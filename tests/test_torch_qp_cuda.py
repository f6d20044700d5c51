"""The QP/SQP stepper and the diagnostic CLI on the card (marker `cuda`;
they skip without one).

* one SQP step (graphics constraints, a cube 0.004 above the ground: the
  half-space rows join, then ADMM runs into its cap) on the card in
  float64 against the same step on the CPU, from the CPU's state: the
  outer count, the ADMM list and the active-set sizes equal, x within
  1e-9; the Hv kernel launched once per operator application;
* the ADMM x-update's PCG with its body in a CUDA graph (GraphedPCG)
  against the eager `pcg` on the same card inputs: the same iterate bit for
  bit and the same count, over two solves (the second replays the graph),
  with every replayed tet_hv launch counted;
* the drop's second SQP step under torch.profiler: the device ran as many
  `tet_rows_kernel` launches (pass A of tet_hv) as `tet_hv.launches` and
  the operator applications counted, graph replays included;
* `meshproc info` builds its mesh on the card by default;
* `python -m ipc_tpu_torch.diagnostic all` on the card: every mode passes,
  the dtype modes in float64 and float32.

The module imports no JAX, so it runs where only PyTorch is installed:
python -m pytest --noconftest -m cuda tests/test_torch_qp_cuda.py
"""

import numpy as np
import pytest
import torch

from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
from ipc_tpu_torch.convert import state_from_numpy, state_to_numpy
from ipc_tpu_torch.mesh import build_mesh
from ipc_tpu_torch.models.primitives import cube
from ipc_tpu_torch.qp.stepper import QPStepper
from ipc_tpu_torch.solver.pcg import GraphedPCG, pcg
from ipc_tpu_torch.timestepper import SimParams
from ipc_tpu_torch.utils import observability as obs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the QP path's tet_hv kernel runs only on the card")
    return torch.device("cuda", torch.cuda.current_device())


def _drop(device, dtype=torch.float64):
    V, T = cube(1)
    mesh, meta = build_mesh(V + np.array([0.0, 0.004, 0.0]), T, dtype=dtype, device=device)
    return QPStepper(mesh, meta, SimParams(), halfspaces=[HalfSpace(HalfSpaceParams())],
                     mode="SQP", constraint_type="graphics")


@pytest.mark.cuda
def test_sqp_steps_on_the_card_match_the_cpu(cuda_device):
    cpu, card = _drop("cpu"), _drop(cuda_device)
    s = cpu.initial_state()
    n0 = obs.counter("tet_hv.launches")
    for i in range(2):
        pre = state_to_numpy(s)
        s, ref = cpu.step(state_from_numpy(pre, "cpu", torch.float64))
        got, gs = card.step(state_from_numpy(pre, cuda_device, torch.float64))
        assert (gs.iters, gs.pcg_iters, gs.n_constraints) == (
            ref.iters, ref.pcg_iters, ref.n_constraints), i
        np.testing.assert_allclose(got.x.cpu().numpy(), s.x.numpy(), rtol=0, atol=1e-9)
    assert 200 in ref.pcg_iters  # ADMM's cap
    assert obs.counter("tet_hv.launches") - n0 == card.operator_applications > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_graphed_pcg_is_pcg_bitwise(cuda_device, dtype):
    st = _drop(cuda_device, dtype)
    x = st.mesh.x_rest
    Hel = st._qp_hess_blocks(x)
    P, M = st._qp_make_apply(Hel), st._qp_precond(Hel)
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.standard_normal(tuple(x.shape)), device=cuda_device).to(dtype)
    x0 = torch.zeros_like(b)
    x_e, k_e, _ = pcg(P, b, M, x0=x0, tol=1e-6, maxiter=500)
    n0, ops0 = obs.counter("tet_hv.launches"), obs.counter("operator.applications")
    g = GraphedPCG(P, M, b)
    for _ in range(2):
        g.state[0].copy_(x0)
        g.start(b, 1e-6, *g.state)
        k_g = g.iterate(500)
        assert k_g == k_e > 1 and torch.equal(g.state[0], x_e)
    assert g.body.capture.counts == {"operator.applications": 1, "tet_hv.launches": 1}
    ops = obs.counter("operator.applications") - ops0
    assert obs.counter("tet_hv.launches") - n0 == ops
    assert ops == 2 * (1 + k_e) + 1  # set-ups, replays, warm-up


@pytest.mark.cuda
def test_graph_replays_count_the_device_launches(cuda_device):
    from ipc_tpu_torch.hv_timing import device_launches

    st = _drop(cuda_device, torch.float32)
    s, _ = st.step(st.initial_state())
    n0, ops0 = obs.counter("tet_hv.launches"), st.operator_applications
    (_, stats), n = device_launches(lambda: st.step(s), cuda_device)
    assert 200 in stats.pcg_iters  # ADMM ran its graphs 200 times in one call
    assert n == obs.counter("tet_hv.launches") - n0 == st.operator_applications - ops0 > 200


@pytest.mark.cuda
def test_meshproc_info_on_the_card(cuda_device, tmp_path, capsys, monkeypatch):
    from ipc_tpu_torch import mesh, meshproc

    built_on = []
    build = mesh.build_mesh
    monkeypatch.setattr(mesh, "build_mesh", lambda *a, **k: (built_on.append(k["device"]),
                                                             build(*a, **k))[1])
    msh = str(tmp_path / "m.msh")
    assert meshproc.main(["gen", "box", "2", "2", "2", msh]) == 0
    assert meshproc.main(["info", msh]) == 0
    assert built_on == [cuda_device] and "tets 48" in capsys.readouterr().out


@pytest.mark.cuda
def test_diagnostic_all_on_the_card(cuda_device, capsys):
    from ipc_tpu_torch.diagnostic import DTYPE_MODES, MODES, main

    assert main(["all", "--device", str(cuda_device)]) == 0
    out = capsys.readouterr().out
    assert out.count("PASS") == len(MODES) + len(DTYPE_MODES) and "FAIL" not in out
