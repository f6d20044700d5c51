"""The step variants of the port's make_step against ipc_tpu.jit_step.
make_jit_step, in float64 on the CPU.

* Newmark, FCR, damping_stiff=1e-4 and coarse_precond=False, each on the
  ground-contact scene at n_cells=2 (`build_scene(2)`), 3 steps from rest:
  identical Newton, PCG and kappa-doubling counts, x within 1e-9.
* ccd_method="ti" on the self-contact scene (`build_scene(2,
  with_contact=True)`): steps 8 and 9 (the impact), each from JAX's state
  before it. Counts identical; x within 1e-9, or within twice JAX's own
  response to a 1-ulp change of x where that is larger (step 9 runs 501
  PCG iterations and moves x by ~2e-7 under that change; the port sums in
  torch's order and lands ~5e-8 away), as tests/test_torch_contact_step.py
  holds the ACCD step.

JAX's Newmark step does not run as make_jit_step builds it: its epilogue
(ipc_tpu/jit_step.py:1058) reads `x_tilde`, a name its scope does not bind,
and raises NameError when traced. The Newton solve runs: the test takes
it through make_jit_step's bounded-dispatch entry points (`burst=`, whose
`begin` returns the predictor x_tilde and whose `run_burst` carries the
same Newton loop), and applies the epilogue's three lines itself with that
x_tilde, which the port's step also uses.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ipc_tpu.contact.pipeline import SelfContact as JSelfContact
from ipc_tpu.jit_step import make_jit_step
from ipc_tpu.timestepper import IPCStepper as JStepper, SimParams as JParams
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.convert import state_from_numpy
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.scenes import build_scene
from ipc_tpu_torch.timestepper import IPCStepper, SimParams

VARIANTS = {
    "newmark": dict(time_integration="NM"),
    "fcr": dict(model="FCR"),
    "damping": dict(damping_stiff=1e-4),
    "no_coarse": dict(coarse_precond=False),
}
COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings")


def _arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step))


def _jax_newmark_step(st):
    """JAX's Newmark step: make_jit_step's Newton solve through its burst
    entry points, then the epilogue with the step's predictor x_tilde."""
    begin, run_burst, _, max_newton = make_jit_step(st, donate=False, burst=64)
    p = st.p

    def step(s):
        s, _, _, pa, carry = begin(s)
        while not bool(carry["done"]) and int(carry["k"]) < max_newton:
            carry = run_burst(pa, carry)
        x = carry["x"]
        v = s.v + st.dt * (1.0 - p.nm_gamma) * s.a
        a = (x - pa["x_tilde"]) / (st.dtSq * p.nm_beta) + jnp.asarray(st.gravity)[None, :]
        v = v + st.dt * p.nm_gamma * a
        stats = dict(newton_iters=carry["k"], pcg_iters_total=carry["pcg_total"],
                     kappa_doublings=carry["n_doubles"])
        return replace(s, x=x, x_prev=x, v=v, a=a, t=s.t + st.dt, step=s.step + 1), stats

    return step


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def variant_run(request):
    params = VARIANTS[request.param]
    jst = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=False)
    jst = JStepper(jst.mesh, jst.meta, JParams(**params), halfspaces=jst.halfspaces)
    pst = build_scene(2, torch.float64, "cpu")
    pst = IPCStepper(pst.mesh, pst.meta, SimParams(**params), halfspaces=pst.halfspaces)
    if request.param == "newmark":
        jstep = _jax_newmark_step(jst)
    else:
        jit = make_jit_step(jst, donate=False)

        def jstep(s):
            s, stats = jit(s)
            return s, {k: getattr(stats, k) for k in COUNTS}
    pstep = make_step(pst)
    js = jst.initial_state()
    ps = state_from_numpy(_arrays(js), "cpu", torch.float64)
    rows = []
    for _ in range(3):
        js, jstats = jstep(js)
        ps, pstats = pstep(ps)
        rows.append((_arrays(js), {k: int(v) for k, v in jstats.items()}, ps, pstats))
    return request.param, rows


def test_variant_matches_jax_float64(variant_run):
    name, rows = variant_run
    for j, js, ps, pstats in rows:
        assert {k: getattr(pstats, k) for k in COUNTS} == js, name
        for field in ("x", "v", "a"):
            # v and a scale x's rounding by 1/dt and 1/dt^2
            scale = {"x": 1.0, "v": 1.0 / 0.025, "a": 1.0 / 0.025 ** 2}[field]
            np.testing.assert_allclose(getattr(ps, field).numpy(), j[field], rtol=0,
                                       atol=1e-9 * scale)
        assert pstats.script_scale == 1.0 and pstats.al_iters == 0
    assert sum(r[3].newton_iters for r in rows) >= 3


TI_STEPS = (8, 9)


@pytest.fixture(scope="module")
def ti_run():
    jst = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=True)
    jst = JStepper(jst.mesh, jst.meta, jst.p, halfspaces=jst.halfspaces,
                   self_contact=JSelfContact(jst.mesh, jst.meta, friction=0.1, ccd_method="ti"))
    jstep = make_jit_step(jst, donate=False)
    s = jst.initial_state()
    rows = {}
    for i in range(max(TI_STEPS) + 1):
        pre = _arrays(s)
        s, stats = jstep(s)
        if i in TI_STEPS:
            rows[i] = dict(pre=pre, x=np.asarray(s.x),
                           stats={k: np.asarray(getattr(stats, k)).item()
                                  for k in stats.__dataclass_fields__})
    pst = build_scene(2, torch.float64, "cpu", with_contact=True)
    pst = IPCStepper(pst.mesh, pst.meta, pst.p, halfspaces=pst.halfspaces,
                     self_contact=SelfContact(pst.mesh, pst.meta, friction=0.1, ccd_method="ti"))
    pstep = make_step(pst)
    out = {i: pstep(state_from_numpy(rows[i]["pre"], "cpu", torch.float64)) for i in TI_STEPS}
    return jstep, jst.initial_state(), rows, out


@pytest.mark.parametrize("i", TI_STEPS)
def test_ti_contact_step_matches_jax_float64(ti_run, i):
    jstep, template, rows, out = ti_run
    js, jx = rows[i]["stats"], rows[i]["x"]
    ps, pstats = out[i]
    counts = COUNTS + ("pt_count", "ee_count", "et_count", "active_pt_max", "active_ee_max",
                       "fric_count")
    assert {k: getattr(pstats, k) for k in counts} == {k: js[k] for k in counts}
    np.testing.assert_allclose(pstats.kappa, js["kappa"], rtol=1e-12)
    assert js["active_pt_max"] > 0  # the impact window: the interval CCD is live
    px = ps.x.numpy()
    dx = np.abs(px - jx).max()
    tol = 1e-9
    if dx > tol:
        # JAX's own response to a 1-ulp change of its input x
        rng = np.random.default_rng(9)
        pre = rows[i]["pre"]
        ulp = rng.choice([-1.0, 1.0], size=pre["x"].shape) * np.spacing(np.abs(pre["x"]))
        sp, _ = jstep(replace(template, **{k: jnp.asarray(v)
                                           for k, v in dict(pre, x=pre["x"] + ulp).items()}))
        tol = max(tol, 2.0 * float(np.abs(np.asarray(sp.x) - jx).max()))
    assert dx <= tol, (dx, tol)
    assert np.isfinite(px).all() and px[:, 1].min() > 0
