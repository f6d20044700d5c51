"""The port's production step against ipc_tpu.jit_step.make_jit_step.

Both packages build the two-box ground-contact scene
(`_build_scene(n_cells=2, with_contact=False)` / `build_scene(2, ...)`),
start from the same numpy state and take 3 steps; ground contact and
friction are active from the first step. A second float64 case widens the
"close constraint" band (dtol_rel 3e-2) so adaptive kappa doubles inside
the Newton loop (steps 0 and 5 of 6).

* float64: identical newton_iters, pcg_iters_total and kappa_doublings,
  kappa to rtol 1e-12, x to atol 1e-9 (the two sum in library order; all
  decisions — PCG termination, line-search acceptance, convergence — agree).
* float32: x to atol 1e-4 and iteration counts within 1: the line search
  compares compensated (hi, lo) energies whose per-tet terms carry f32
  rounding, so near the f32 noise floor an acceptance can flip.
"""

import ast
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ipc_tpu.jit_step import make_jit_step
from ipc_tpu.timestepper import IPCStepper as JaxStepper, SimParams as JaxParams
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.convert import state_from_numpy, state_to_numpy
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.scenes import build_scene
from ipc_tpu_torch.timestepper import IPCStepper, SimParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 3


def _jax_state_arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step))


def _run_both(np_dtype, torch_dtype, params=None, n_steps=N_STEPS):
    st = ge._build_scene(n_cells=2, dtype=np_dtype, with_contact=False)
    pst = build_scene(2, torch_dtype, "cpu")
    if params:
        st = JaxStepper(st.mesh, st.meta, JaxParams(**params), halfspaces=st.halfspaces)
        pst = IPCStepper(pst.mesh, pst.meta, SimParams(**params), halfspaces=pst.halfspaces)
    jstep = make_jit_step(st, donate=False)
    js = st.initial_state()
    pstep = make_step(pst)
    ps = state_from_numpy(_jax_state_arrays(js), "cpu", torch_dtype)
    rows = []
    for _ in range(n_steps):
        js, jstats = jstep(js)
        ps, pstats = pstep(ps)
        rows.append((np.asarray(js.x), jstats, state_to_numpy(ps)["x"], pstats))
    return rows, pst, pstep


@pytest.fixture(scope="module", params=["default", "kappa_doubling"])
def f64_run(request):
    if request.param == "kappa_doubling":
        return _run_both(np.float64, torch.float64, dict(dtol_rel=3e-2), n_steps=6)
    return _run_both(np.float64, torch.float64)


@pytest.fixture(scope="module")
def f32_run():
    return _run_both(np.float32, torch.float32)


def test_step_matches_jax_float64(f64_run):
    rows, pst, pstep = f64_run
    for jx, js, px, ps in rows:
        assert ps.newton_iters == int(js.newton_iters)
        assert ps.pcg_iters_total == int(js.pcg_iters_total)
        assert ps.kappa_doublings == int(js.kappa_doublings)
        assert ps.sweep_clamps == int(js.sweep_clamps)
        np.testing.assert_allclose(ps.kappa, float(js.kappa), rtol=1e-12)
        np.testing.assert_allclose(px, jx, rtol=0, atol=1e-9)
        assert np.isfinite(px).all() and px[:, 1].min() > 0
    # ground contact is live: the low box sits inside the barrier band
    assert rows[-1][2][:, 1].min() < 1e-3
    assert pstep.operator_applications > 0
    if pst.p.dtol_rel > 1e-3:
        assert sum(r[3].kappa_doublings for r in rows) >= 2


def test_step_matches_jax_float32(f32_run):
    rows, _, _ = f32_run
    for jx, js, px, ps in rows:
        assert abs(ps.newton_iters - int(js.newton_iters)) <= 1
        assert abs(ps.pcg_iters_total - int(js.pcg_iters_total)) <= 1
        assert abs(ps.kappa_doublings - int(js.kappa_doublings)) <= 1
        np.testing.assert_allclose(px, jx, rtol=0, atol=1e-4)
        assert px.dtype == np.float32 and np.isfinite(px).all() and px[:, 1].min() > 0


def test_step_is_deterministic_and_dtype_clean():
    st = build_scene(2, torch.float32, "cpu")
    step = make_step(st)
    s0 = st.initial_state()
    s1, _ = step(s0)
    s2, _ = step(s0)
    assert torch.equal(s1.x, s2.x) and torch.equal(s1.v, s2.v)
    for t in (s1.x, s1.x_prev, s1.v, s1.a):
        assert t.dtype == torch.float32
    assert s1.step == 1 and s1.t == pytest.approx(st.dt)


@pytest.mark.parametrize("change", [
    dict(params=SimParams(time_integration="NM")),
    dict(params=SimParams(damping_stiff=0.1)),
    dict(params=SimParams(linsys="dense")),
    dict(sc=SimpleNamespace(ccd_method="ti")),
    dict(script=object()),
    dict(burst=4),
])
def test_make_step_rejects_outside_the_slice(change):
    st = build_scene(1, torch.float64, "cpu")
    if "params" in change:
        st = IPCStepper(st.mesh, st.meta, change["params"], halfspaces=st.halfspaces)
    if "sc" in change:
        st.sc = change["sc"]
    if "script" in change:
        st.script = change["script"]
    with pytest.raises(NotImplementedError):
        make_step(st, burst=change.get("burst"))


def test_self_contact_scene_not_yet_ported():
    """The bench scene's self-contact is ported; what waits for later
    slices (Tight-Inclusion CCD, per-vertex friction of kinematic objects)
    is refused, not silently replaced."""
    st = build_scene(2, torch.float64, "cpu", with_contact=True)
    assert st.sc is not None and st.sc.broadphase == "dense"
    for kwargs in (dict(ccd_method="ti"), dict(vert_mu=np.ones(1))):
        with pytest.raises(NotImplementedError):
            SelfContact(st.mesh, st.meta, friction=0.1, **kwargs)


def test_port_never_imports_jax():
    # jax and the JAX package are made unimportable, then a ground step and
    # a self-contact step
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ipc_tpu'] = None\n"
        "import ipc_tpu_torch\n"
        "from ipc_tpu_torch.scenes import build_scene\n"
        "from ipc_tpu_torch.jit_step import make_step\n"
        "for contact in (False, True):\n"
        "    st = build_scene(2, 'float64', 'cpu', with_contact=contact)\n"
        "    s, stats = make_step(st)(st.initial_state())\n"
        "    assert stats.newton_iters > 0 and (st.sc is not None) == contact\n"
        "sys.modules.pop('jax')\n"
        "sys.modules.pop('ipc_tpu')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ipc_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ipc_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _imported_modules(path):
    """Top-level names of every module `path` imports (absolute imports)."""
    tree = ast.parse(open(path).read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return {n.split(".")[0] for n in names}


def test_port_sources_import_neither_jax_nor_ipc_tpu():
    """Static check over every source of the port and chip_smoke.py, imports
    inside functions included."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "ipc_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    bad = {os.path.relpath(p, ROOT): sorted(_imported_modules(p) & {"jax", "jaxlib", "ipc_tpu"})
           for p in paths}
    assert not {p: m for p, m in bad.items() if m}


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
