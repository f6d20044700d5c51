"""The mat twist's moving-DBC augmented Lagrangian (AL) on the CPU: the
port's device step against the JAX package's, and against the benchmark's
plain reference.

At 225^2 cells the prologue's clamp blocks the twist's handles
(`script_scale` 0.83-0.93 on the card), so every step hands the rest of
their move to the AL. A mat(10) in float64 whose handles turn 16 times as
fast is blocked alike, by the prologue's CCD (`script_scale` 0.86-0.88),
and runs 2 steps from rest here.

* JAX runs the steps through tests/jax_al_step.py (its loop, with the
  projected iterations after the AL's starting PCG as the port starts
  them) over its dense broad phase; the port takes each step from JAX's
  state before it: identical Newton, PCG, kappa-doubling and AL counts,
  script_scale within 1e-12, x within 1e-9 and the handle rows within
  1e-12, as tests/test_torch_twist_step.py holds the unblocked twist.
* The port's AL counters agree with StepStats.al_iters, and each step's
  one episode ends by completion.
* The port's chain of steps from rest passes the reference's judgement
  (portbench/reference) within the limits of the cell twist225.al:
  `newton` at most 10, `handle_err` at most 0.02, no inverted tet, no gap
  under zero, no crossing. The loop that carries the AL direction's DBC
  rows into the projected iterations (JAX's, and the port's before it
  zeroed them) ends these steps at a failed line search, judged `newton`
  128 and 207.
"""

import json
import os

import numpy as np
import pytest
import torch

from ipc_tpu.contact.pipeline import SelfContact as JSelfContact
from ipc_tpu.mesh import build_mesh as j_build_mesh
from ipc_tpu.models.primitives import mat
from ipc_tpu.scripting import build_script as j_build_script
from ipc_tpu.timestepper import IPCStepper as JStepper, SimParams as JParams
from ipc_tpu_torch.convert import state_from_numpy
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.scenes import build_twist_scene
from ipc_tpu_torch.utils import observability as obs
from jax_al_step import jax_al_step
from portbench.reference import judge as RJ
from portbench.reference import scene as RS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, SPEED, STEPS = 10, 16.0, 2
COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings", "al_iters")
AL_COUNTERS = ("al.episodes", "al.iters", "al.completed", "al.stalled", "al.capped")


def _speed_up(script):
    for h in script.handles:
        h.ang_vel *= SPEED


def _jax_twist():
    """The JAX package's twist on mat(N), its handles SPEED times as fast, over the
    dense broad phase."""
    V, T = mat(N, size=1.0)
    mesh0, _ = j_build_mesh(V, T)
    surface = np.zeros(len(V), bool)
    surface[np.asarray(mesh0.surf_verts)] = True
    script = j_build_script("twist", V, surface, [(0, len(V))], handle_ratio=0.01)
    _speed_up(script)
    mesh, meta = j_build_mesh(V, T, density=1000.0, ym=2e4, pr=0.4,
                              dbc_mask=script.dbc_mask(), dtype=np.float64)
    params = JParams(dt=0.04, gravity=(0.0, 0.0, 0.0), rel_gl2_tol=1e-4)
    # the dense broad phase: JAX's fixed-capacity grid cells overflow under
    # the fast handles' sweep (166 > 8 in the prologue of step 0) and drop
    # the candidates whose CCD blocks the move; the port's grid drops none
    sc = JSelfContact(mesh, meta, friction=0.0, broadphase="dense")
    return JStepper(mesh, meta, params, self_contact=sc, script=script)


def _port_twist():
    st = build_twist_scene(N, torch.float64, "cpu")
    _speed_up(st.script)
    return st


def _arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step))


def _traced(step, state):
    """One port step with tracing on (bit-identical results): (state,
    stats, the AL counters it counted)."""
    obs.set_tracing(True)
    try:
        obs.collect()
        state, stats = step(state)
        counters = obs.collect()["counters"]
    finally:
        obs.set_tracing(False)
    return state, stats, {k: counters.get(k, 0) for k in AL_COUNTERS}


@pytest.fixture(scope="module")
def run():
    """JAX's steps from rest, each taken again by the port from JAX's state
    before it, and the port's own chain from rest."""
    jst = _jax_twist()
    jstep = jax_al_step(jst)
    s = jst.initial_state()
    rows = []
    for _ in range(STEPS):
        pre = _arrays(s)
        s, stats = jstep(s)
        rows.append((pre, _arrays(s), {k: np.asarray(getattr(stats, k)).item() for k in
                                        stats.__dataclass_fields__}))
    pst = _port_twist()
    np.testing.assert_array_equal(pst.mesh.dbc_mask.numpy(), np.asarray(jst.mesh.dbc_mask))
    pstep = make_step(pst)
    held = [_traced(pstep, state_from_numpy(pre, "cpu", torch.float64))
            for pre, _, _ in rows]
    own = pst.initial_state()
    x0, v0 = own.x.clone(), own.v.clone()
    chain = []
    for _ in range(STEPS):
        own, _ = pstep(own)
        chain.append(own.x.clone())
    return pst, rows, held, (x0, v0, chain)


def test_twist_al_matches_jax_float64(run):
    pst, rows, held, _ = run
    dbc = pst.mesh.dbc_mask.numpy()
    for i, ((pre, post, js), (ps, pstats, _)) in enumerate(zip(rows, held)):
        assert {k: getattr(pstats, k) for k in COUNTS} == {k: js[k] for k in COUNTS}, i
        assert pstats.script_scale == pytest.approx(js["script_scale"], rel=1e-12, abs=0)
        np.testing.assert_allclose(pstats.kappa, js["kappa"], rtol=1e-12)
        px = ps.x.numpy()
        np.testing.assert_allclose(px, post["x"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(px[dbc], post["x"][dbc], rtol=0, atol=1e-12)


def test_twist_al_blocks_and_completes(run):
    """Every step is blocked and runs the AL; the counters tell one
    episode a step that ended with the move completed."""
    _, _, held, _ = run
    for i, (_, stats, al) in enumerate(held):
        assert stats.script_scale < 1.0 - 1e-3 and stats.al_iters > 0, i
        assert al == {"al.episodes": 1, "al.iters": stats.al_iters, "al.completed": 1,
                      "al.stalled": 0, "al.capped": 0}, i
        # the projected iterations after the AL converge
        assert stats.newton_iters > stats.al_iters and stats.last_alpha == 1.0, i


def test_twist_al_passes_the_reference(run):
    pst, _, _, (x0, v0, chain) = run
    with open(os.path.join(ROOT, "portbench", "configs", "twist225.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "limits", "twist225.al.json")) as f:
        limits = json.load(f)
    body = cfg["scene"]["bodies"][0]
    body["cells"], body["size"] = [N, 1, N], [1.0, 1.0 / N, 1.0]
    script = cfg["scene"]["script"]
    script["angular_velocity"] = [w * SPEED for w in script["angular_velocity"]]
    scene = RS.build(cfg)
    np.testing.assert_array_equal(scene.dbc.numpy(), pst.mesh.dbc_mask.numpy())
    worst, rows = RJ.judge_chain(scene, x0, v0, chain)
    assert limits["handle_err"]["max"] <= 0.02
    assert worst["newton"] <= limits["newton"]["max"], rows
    assert worst["handle_err"] <= limits["handle_err"]["max"], rows
    assert worst["min_det"] > 0.0 and worst["min_gap"] > 0.0 and worst["crossings"] == 0, rows
