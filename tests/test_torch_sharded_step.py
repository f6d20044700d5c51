"""The port's make_step split over 2 gloo ranks on the CPU, held to the JAX
package's make_jit_step over the same padded mesh, float64.

JAX's reference is the dryrun_multichip set-up without its mesh: the two-box
scene (n_cells=2) with its mesh padded by ipc_tpu.parallel.sharding.
shard_mesh_data for 2 devices, carried through numpy onto one device, the
pipeline rebound, and make_jit_step run single-device (no spmd.activate).
The port's ranks start from JAX's state before each compared step
(tests/torch_rank_jobs.step_job, parallel/launch.py) and must give, on every rank:

* the same Newton, PCG and kappa-doubling counts and, with self-contact,
  the same candidate, active and friction counts (summed over ranks);
* x within 1e-9 or, where larger, twice the JAX step's own response to a
  1-ulp perturbation of its input x (the rule of test_torch_contact_step;
  the response is measured only where x is not within 1e-9);
* the same x on both ranks, bit for bit.

Cases: the boxes without self-contact from rest, 3 steps; with self-contact
the impact steps 8-9. The host-path and QP steppers refuse to run under an
active group.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ipc_tpu.jit_step import make_jit_step
from ipc_tpu.parallel.sharding import make_mesh, shard_mesh_data
from ipc_tpu_torch.mesh import MESH_FIELDS
from ipc_tpu_torch.parallel import spmd
from ipc_tpu_torch.parallel.launch import launch
from ipc_tpu_torch.scenes import build_scene

from torch_rank_jobs import step_job

COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings")
PAIR_COUNTS = ("pt_count", "ee_count", "et_count", "active_pt_max", "active_ee_max",
               "fric_count")


def _arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step))


def _jax_padded_stepper(with_contact):
    st = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=with_contact)
    padded = shard_mesh_data(st.mesh, make_mesh(2))
    st.mesh = type(padded)(**{k: jnp.asarray(np.asarray(getattr(padded, k)))
                              for k in MESH_FIELDS})
    st._sv = st.mesh.surf_verts
    st._dbc_sv = st.mesh.dbc_mask[st.mesh.surf_verts]
    if st.sc is not None:
        st.sc.rebind_mesh(st.mesh)
    st._build_kernels()
    return st


def _jax_rows(with_contact, steps):
    """JAX over the padded mesh from rest: per compared step the state
    before it, its stats and x after it; `respond(i)` gives step i's 1-ulp
    response (run only where the port's x is not within 1e-9)."""
    st = _jax_padded_stepper(with_contact)
    jstep = make_jit_step(st, donate=False)
    s = st.initial_state()
    rows = {}
    for i in range(max(steps) + 1):
        pre = _arrays(s)
        s, stats = jstep(s)
        if i in steps:
            rows[i] = dict(pre=pre, x=np.asarray(s.x),
                           stats={k: np.asarray(getattr(stats, k)).item()
                                  for k in stats.__dataclass_fields__})
    rng = np.random.default_rng(11)

    def respond(i):
        r = rows[i]
        resp = 0.0
        for _ in range(2):
            ulp = rng.choice([-1.0, 1.0], size=r["x"].shape) * np.spacing(np.abs(r["pre"]["x"]))
            pert = dataclasses.replace(s, **{k: jnp.asarray(v) for k, v in
                                             dict(r["pre"], x=r["pre"]["x"] + ulp).items()})
            sp, _ = jstep(pert)
            resp = max(resp, float(np.abs(np.asarray(sp.x) - r["x"]).max()))
        return resp

    return rows, respond


def _hold(jax_run, outs, steps, counts):
    rows, respond = jax_run
    for k, i in enumerate(steps):
        js, jx = rows[i]["stats"], rows[i]["x"]
        dx = max(float(np.abs(o["rows"][k]["x"] - jx).max()) for o in outs)
        tol = max(1e-9, 2.0 * respond(i)) if dx > 1e-9 else 1e-9
        for o in outs:
            rec = o["rows"][k]
            ps = rec["stats"]
            assert {c: ps[c] for c in counts} == {c: js[c] for c in counts}, (i, o["rank"])
            np.testing.assert_allclose(ps["kappa"], js["kappa"], rtol=1e-12)
            assert jx.shape == rec["x"].shape
            np.testing.assert_allclose(rec["x"], jx, rtol=0, atol=tol)
            assert rec["finite"] and rec["ymin"] > 0 and not rec["intersection"]
        np.testing.assert_array_equal(outs[0]["rows"][k]["x"], outs[1]["rows"][k]["x"])
        assert outs[0]["rows"][k]["collectives"] == outs[1]["rows"][k]["collectives"] > 0


def _port(steps, jax_run, with_contact):
    rows = jax_run[0]
    spec = dict(n_cells=2, dtype="float64", with_contact=with_contact, check=True,
                starts=[rows[i]["pre"] for i in steps])
    outs = launch(step_job, 2, "gloo", "cpu", (spec,), timeout=600)
    assert [o["backend"] for o in outs] == ["gloo", "gloo"]
    # the tets are split: each rank holds half of the padded rows
    for o in outs:
        rep = {name: (total, mine) for name, total, mine, _ in o["report"]}
        assert 2 * rep["mesh.tets"][1] == rep["mesh.tets"][0]
        assert rep["mesh.x_rest"][1] == rep["mesh.x_rest"][0]
    return outs


def test_sharded_ground_steps_match_jax():
    steps = (0, 1, 2)
    run = _jax_rows(False, steps)
    _hold(run, _port(steps, run, False), steps, COUNTS)


@pytest.fixture(scope="module")
def contact_run():
    return _jax_rows(True, (8, 9))


def test_sharded_contact_steps_match_jax(contact_run):
    steps = (8, 9)
    run = contact_run
    assert all(run[0][i]["stats"]["active_pt_max"] > 0 for i in steps)
    outs = _port(steps, run, True)
    _hold(run, outs, steps, COUNTS + PAIR_COUNTS)
    # both ranks hold pairs of their own
    for o in outs:
        assert all(r["rank_counts"]["pt"] > 0 for r in o["rows"])
        for r in o["rows"]:
            assert r["rank_counts"]["pt"] < r["stats"]["pt_count"]


def test_host_and_qp_steppers_refuse_an_active_group(monkeypatch):
    from ipc_tpu_torch.qp.stepper import QPStepper

    st = build_scene(1, torch.float64, "cpu")
    qp = QPStepper(st.mesh, st.meta, st.p, halfspaces=st.halfspaces)
    monkeypatch.setitem(spmd._CTX, "group", object())
    for stepper in (st, qp):
        with pytest.raises(NotImplementedError):
            stepper.step(st.initial_state())


def test_one_rank_group_is_the_unsharded_step_bitwise(contact_run):
    """A 1-rank group over the mesh padded for 2 ranks runs the unsharded
    step over that mesh bit for bit (the owner adds every term in the
    unsharded order, and a sum over one rank is the identity): the impact
    step 8 from JAX's state."""
    from ipc_tpu_torch.convert import state_from_numpy
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.parallel.sharding import shard_stepper

    rows = contact_run[0]
    st = shard_stepper(build_scene(2, torch.float64, "cpu", with_contact=True), 2)
    step = make_step(st)
    spec = dict(n_cells=2, dtype="float64", with_contact=True, pad=2,
                starts=[rows[8]["pre"]])
    (out,) = launch(step_job, 1, "gloo", "cpu", (spec,), timeout=300)
    for k, i in enumerate((8,)):
        s, stats = step(state_from_numpy(rows[i]["pre"], "cpu", torch.float64))
        assert stats.active_pt_max > 0
        np.testing.assert_array_equal(out["rows"][k]["x"], s.x.numpy())
        assert out["rows"][k]["stats"] == dataclasses.asdict(stats)


def test_a_rank_stepper_needs_its_group(monkeypatch):
    """A stepper holding one rank's tets refuses to build its step without
    that rank's group, a stepper holding the whole mesh refuses to build it
    under a group (each rank would add every tet), and a step runs only
    under the group it was built under."""
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.parallel.sharding import shard_stepper

    st = shard_stepper(build_scene(1, torch.float64, "cpu"), 2, rank=1)
    with pytest.raises(ValueError):
        make_step(st)
    step = make_step(build_scene(1, torch.float64, "cpu"))
    monkeypatch.setitem(spmd._CTX, "group", object())
    monkeypatch.setitem(spmd._CTX, "world", 2)
    with pytest.raises(RuntimeError):
        step(build_scene(1, torch.float64, "cpu").initial_state())
    with pytest.raises(ValueError):
        make_step(st)  # rank 1's tets under rank 0
    for whole in (build_scene(1, torch.float64, "cpu"),
                  shard_stepper(build_scene(1, torch.float64, "cpu"), 2)):
        with pytest.raises(ValueError):
            make_step(whole)
    monkeypatch.setitem(spmd._CTX, "rank", 1)
    make_step(st)

