"""Live float64 parity of the self-contact step: the port's make_step
against ipc_tpu.jit_step.make_jit_step on the bench scene at n_cells=2.

JAX compiles its step once for the module (about 40 s on a CPU) and runs 12
steps from rest. The upper box lands in step 8; steps 8-11 carry active
PT/EE pairs, steps 9-11 self-friction pairs. For each of those four steps
the port starts from JAX's state before it and must give:

* identical newton_iters, pcg_iters_total, kappa_doublings, pt/ee/et
  counts, active PT/EE maxima and fric_count;
* kappa to rtol 1e-12;
* x to atol 1e-9, or, where larger, to twice the JAX step's own response
  to a 1-ulp perturbation of its input x. Steps 9 and 10 are
  ill-conditioned (step 9 runs 501 PCG iterations): JAX moves its own
  result by ~2e-7 (step 9) and ~5e-9 (step 10) under that perturbation.
  The two packages agree to ~2e-15 on step 8 but sum in different orders
  (XLA's fused reductions against torch's), and those steps amplify the
  rounding difference to ~5e-8 and ~1e-9, with the same iteration counts.

The JAX sets are fixed-capacity: every count compared must be within its
capacity, so no JAX set was truncated. A second case, port only, forces the
grid broad phase (spatial hash) and must reproduce the dense run exactly.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ipc_tpu.jit_step import make_jit_step
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.convert import state_from_numpy
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.scenes import build_scene
from ipc_tpu_torch.timestepper import IPCStepper

STEPS = (8, 9, 10, 11)
COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings", "pt_count", "ee_count",
          "et_count", "active_pt_max", "active_ee_max", "fric_count")


def _arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step))


def _jax_state(template, arrays):
    return replace(template, **{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module")
def jax_run():
    """JAX: 12 steps from rest; per compared step the state before it, its
    stats, the x after it, and its response to a 1-ulp change of x."""
    st = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=True)
    jstep = make_jit_step(st, donate=False)
    s = st.initial_state()
    rows = {}
    for i in range(max(STEPS) + 1):
        pre = _arrays(s)
        s, stats = jstep(s)
        if i in STEPS:
            rows[i] = dict(pre=pre, x=np.asarray(s.x),
                           stats={k: np.asarray(getattr(stats, k)).item()
                                  for k in stats.__dataclass_fields__})
    rng = np.random.default_rng(9)
    template = st.initial_state()
    for i, r in rows.items():
        resp = 0.0
        for _ in range(2):
            ulp = rng.choice([-1.0, 1.0], size=r["x"].shape) * np.spacing(np.abs(r["pre"]["x"]))
            sp, _ = jstep(_jax_state(template, dict(r["pre"], x=r["pre"]["x"] + ulp)))
            resp = max(resp, float(np.abs(np.asarray(sp.x) - r["x"]).max()))
        r["ulp_response"] = resp
    caps = dict(pt_count=st.sc.cap_pt, ee_count=st.sc.cap_ee, et_count=st.sc.cap_et,
                active_pt_max=st.sc.cap_act_pt, active_ee_max=st.sc.cap_act_ee,
                fric_count=st.sc.cap_fric)
    return rows, caps, st.sc.broadphase


def _port_steps(jax_rows, broadphase=None, steps=STEPS):
    st = build_scene(2, torch.float64, "cpu", with_contact=True)
    if broadphase is not None:
        sc = SelfContact(st.mesh, st.meta, friction=0.1, broadphase=broadphase)
        st = IPCStepper(st.mesh, st.meta, st.p, halfspaces=st.halfspaces, self_contact=sc)
    step = make_step(st)
    out = {}
    for i in steps:
        s, stats = step(state_from_numpy(jax_rows[i]["pre"], "cpu", torch.float64))
        out[i] = (s.x.numpy(), stats)
    return out, st.sc.broadphase


@pytest.fixture(scope="module")
def port_run(jax_run):
    return _port_steps(jax_run[0])


def test_jax_reference_sets_within_capacity(jax_run):
    rows, caps, broadphase = jax_run
    assert broadphase == "dense"
    for i in STEPS:
        js = rows[i]["stats"]
        for k, cap in caps.items():
            assert js[k] <= cap, (i, k, js[k], cap)
        assert js["bucket_overflow"] == 0
    # the window is the impact: active pairs on every step, friction after
    assert all(rows[i]["stats"]["active_pt_max"] > 0 for i in STEPS)
    assert all(rows[i]["stats"]["fric_count"] > 0 for i in STEPS[1:])


@pytest.mark.parametrize("i", STEPS)
def test_contact_step_matches_jax_float64(jax_run, port_run, i):
    rows, _, _ = jax_run
    (out, broadphase) = port_run
    assert broadphase == "dense"
    js, jx = rows[i]["stats"], rows[i]["x"]
    px, ps = out[i]
    assert {k: getattr(ps, k) for k in COUNTS} == {k: js[k] for k in COUNTS}
    np.testing.assert_allclose(ps.kappa, js["kappa"], rtol=1e-12)
    tol = max(1e-9, 2.0 * rows[i]["ulp_response"])
    np.testing.assert_allclose(px, jx, rtol=0, atol=tol)
    assert np.isfinite(px).all() and px[:, 1].min() > 0


def test_grid_broadphase_matches_dense(jax_run, port_run):
    rows, _, _ = jax_run
    dense, _ = port_run
    steps = (8, 10)
    grid, broadphase = _port_steps(rows, broadphase="grid", steps=steps)
    assert broadphase == "grid"
    for i in steps:
        (gx, gs), (dx, ds) = grid[i], dense[i]
        assert {k: getattr(gs, k) for k in COUNTS} == {k: getattr(ds, k) for k in COUNTS}
        np.testing.assert_allclose(gx, dx, rtol=0, atol=1e-9)
