"""The mat-twist scene (scenes.build_twist_scene) against the JAX package's
twist, on the CPU: the script `twist` turns the two border handles in
opposite senses, with self-contact.

Both packages build the scene from `mat(n)` and `build_script("twist",
...)`. JAX runs 4 jitted steps from rest.

* float64 at mat(4) (96 tets): the port takes each step from JAX's state
  before it; identical Newton, PCG and kappa-doubling counts, script_scale
  1 and no AL iteration, x within 1e-9, and the handle rows within 1e-12
  of JAX's (they are moved by the script alone).
* float32 at mat(12) (864 tets): the port runs the 4 steps from rest on
  its own; iteration counts within 1 and x within 1e-4 of JAX's float32
  run, as tests/test_torch_step.py holds the ground step in float32. On
  coarser mats (4 to 8 cells) the float32 inversion filter of both
  packages finds spurious roots in rounding noise (its cubic's absolute
  1e-12 thresholds, ipc_tpu/ops/step_bound.py), which clamp the handles'
  motion by rounding-dependent amounts; mat(12) stays clear of that.
"""

import numpy as np
import pytest
import torch

from ipc_tpu.contact.pipeline import SelfContact as JSelfContact
from ipc_tpu.jit_step import make_jit_step
from ipc_tpu.mesh import build_mesh as j_build_mesh
from ipc_tpu.models.primitives import mat
from ipc_tpu.scripting import build_script as j_build_script
from ipc_tpu.timestepper import IPCStepper as JStepper, SimParams as JParams
from ipc_tpu_torch.convert import state_from_numpy
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.scenes import build_twist_scene

N, N_F32, STEPS = 4, 12, 4
COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings", "al_iters")


def _jax_twist(n, dtype):
    """The JAX package's twist scene: matTwist20.txt's parameters on mat(n)."""
    V, T = mat(n, size=1.0)
    mesh0, _ = j_build_mesh(V, T)
    surface = np.zeros(len(V), bool)
    surface[np.asarray(mesh0.surf_verts)] = True
    script = j_build_script("twist", V, surface, [(0, len(V))], handle_ratio=0.01)
    mesh, meta = j_build_mesh(V, T, density=1000.0, ym=2e4, pr=0.4,
                              dbc_mask=script.dbc_mask(), dtype=dtype)
    params = JParams(dt=0.04, gravity=(0.0, 0.0, 0.0), rel_gl2_tol=1e-4)
    return JStepper(mesh, meta, params, self_contact=JSelfContact(mesh, meta, friction=0.0),
                    script=script)


def _arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step))


def _jax_run(n, dtype):
    st = _jax_twist(n, dtype)
    step = make_jit_step(st, donate=False)
    s = st.initial_state()
    rows = []
    for _ in range(STEPS):
        pre = _arrays(s)
        s, stats = step(s)
        rows.append((pre, _arrays(s), {k: np.asarray(getattr(stats, k)).item() for k in
                                        stats.__dataclass_fields__}))
    return st, rows


@pytest.fixture(scope="module")
def f64_run():
    jst, rows = _jax_run(N, np.float64)
    pst = build_twist_scene(N, torch.float64, "cpu")
    for f in ("x_rest", "tets", "surf_tris", "mass", "dbc_mask"):
        np.testing.assert_array_equal(getattr(pst.mesh, f).numpy(),
                                      np.asarray(getattr(jst.mesh, f)))
    pstep = make_step(pst)
    out = [pstep(state_from_numpy(pre, "cpu", torch.float64)) for pre, _, _ in rows]
    return jst, pst, rows, out


def test_twist_matches_jax_float64(f64_run):
    jst, pst, rows, out = f64_run
    dbc = pst.mesh.dbc_mask.numpy()
    assert dbc.sum() == 20  # the two x-border columns of mat(4)
    for (pre, post, js), (ps, pstats) in zip(rows, out):
        assert {k: getattr(pstats, k) for k in COUNTS} == {k: js[k] for k in COUNTS}
        assert pstats.script_scale == js["script_scale"] == 1.0 and pstats.al_iters == 0
        np.testing.assert_allclose(pstats.kappa, js["kappa"], rtol=1e-12)
        px = ps.x.numpy()
        np.testing.assert_allclose(px, post["x"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(px[dbc], post["x"][dbc], rtol=0, atol=1e-12)
    # the handles turned: 4 x 0.4 pi rad/s x 0.04 s = 0.064 pi rad each
    x0 = rows[0][0]["x"]
    assert np.abs(out[-1][0].x.numpy()[dbc] - x0[dbc])[:, 1:].max() > 1e-3


@pytest.fixture(scope="module")
def f32_run():
    _, rows = _jax_run(N_F32, np.float32)
    pst = build_twist_scene(N_F32, torch.float32, "cpu")
    pstep = make_step(pst)
    ps = state_from_numpy(rows[0][0], "cpu", torch.float32)
    out = []
    for _ in range(STEPS):
        ps, pstats = pstep(ps)
        out.append((ps.x.numpy(), pstats))
    return rows, out


def test_twist_matches_jax_float32(f32_run):
    rows, out = f32_run
    for (_, post, js), (px, pstats) in zip(rows, out):
        for k in ("newton_iters", "pcg_iters_total", "kappa_doublings"):
            assert abs(getattr(pstats, k) - js[k]) <= 1, k
        assert pstats.script_scale == 1.0 and pstats.al_iters == js["al_iters"] == 0
        np.testing.assert_allclose(px, post["x"], rtol=0, atol=1e-4)
        assert px.dtype == np.float32 and np.isfinite(px).all()
