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
from ipc_tpu_torch.scripting import DBCGroup, MeshSeqMotion, Script
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


def _mesh_seq_script(n_verts):
    return Script(n_verts=n_verts, mesh_seqs=[MeshSeqMotion(
        verts=np.arange(4), folder="frames", transform=None, n_frames=2, ext=".obj")])


# make_step refuses exactly these: burst= (any value, 0 included), the host
# path's linear solvers, and mesh-sequence scripts (ValueError, as
# make_jit_step)
@pytest.mark.parametrize("change", [
    dict(params=SimParams(linsys="dense")),
    dict(params=SimParams(linsys="sparse")),
    dict(burst=4),
    dict(burst=0),
    dict(script="mesh_seq"),
])
def test_make_step_rejects_outside_the_slice(change):
    st = build_scene(1, torch.float64, "cpu")
    if "params" in change:
        st = IPCStepper(st.mesh, st.meta, change["params"], halfspaces=st.halfspaces)
    error = NotImplementedError
    if "script" in change:
        st = IPCStepper(st.mesh, st.meta, st.p, halfspaces=st.halfspaces,
                        script=_mesh_seq_script(int(st.mesh.x_rest.shape[0])))
        error = ValueError
    with pytest.raises(error):
        make_step(st, burst=change.get("burst"))


@pytest.mark.parametrize("change", [
    dict(params=SimParams(time_integration="NM")),
    dict(params=SimParams(model="FCR")),
    dict(params=SimParams(damping_stiff=0.1)),
    dict(params=SimParams(coarse_precond=False)),
    dict(ccd_method="ti"),
    dict(script=True),
    dict(vert_mu=0.2),
], ids=["newmark", "fcr", "damping", "no_coarse", "ccd_ti", "script", "vert_mu"])
def test_make_step_accepts_the_variants(change):
    contact = "ccd_method" in change or "vert_mu" in change
    st = build_scene(1, torch.float64, "cpu", with_contact=contact)
    sc = None
    if contact:
        # per-vertex friction (kinematic objects) on the upper box's vertices
        n = int(st.mesh.x_rest.shape[0])
        vert_mu = np.where(np.arange(n) >= n // 2, change.get("vert_mu", 0.0), 0.0)
        sc = SelfContact(st.mesh, st.meta, friction=0.1,
                         ccd_method=change.get("ccd_method", "accd"),
                         vert_mu=vert_mu if "vert_mu" in change else None)
    script = None
    if "script" in change:
        n = int(st.mesh.x_rest.shape[0])
        script = Script(n_verts=n, dbc_groups=[DBCGroup(np.arange(4), np.array([0.0, 1.0, 0.0]))])
    st = IPCStepper(st.mesh, st.meta, change.get("params", st.p), halfspaces=st.halfspaces,
                    self_contact=sc, script=script)
    s, stats = make_step(st)(st.initial_state())
    assert stats.newton_iters > 0 and torch.isfinite(s.x).all()


def test_self_contact_scene_not_yet_ported():
    """The bench scene's self-contact is ported, Tight-Inclusion CCD and
    per-vertex friction of kinematic objects included (one coefficient per
    vertex, in the mesh's dtype and device); an unknown CCD method and a
    vert_mu of the wrong length are refused."""
    st = build_scene(2, torch.float64, "cpu", with_contact=True)
    assert st.sc is not None and st.sc.broadphase == "dense"
    assert SelfContact(st.mesh, st.meta, friction=0.1, ccd_method="ti").ccd_method == "ti"
    n = int(st.mesh.x_rest.shape[0])
    sc = SelfContact(st.mesh, st.meta, friction=0.1, vert_mu=np.full(n, 0.3))
    assert sc.vert_mu.dtype == torch.float64 and sc.vert_mu.shape == (n,)
    with pytest.raises(ValueError):
        SelfContact(st.mesh, st.meta, friction=0.1, vert_mu=np.ones(1))
    with pytest.raises(ValueError):
        SelfContact(st.mesh, st.meta, friction=0.1, ccd_method="ctcd")


def test_port_never_imports_jax():
    # jax and the JAX package are made unimportable, then a ground step, a
    # self-contact step and a scripted (twist) step, a contact step split
    # over two gloo ranks (whose processes must not load jax either) and
    # the native runtime
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ipc_tpu'] = None\n"
        "import ipc_tpu_torch\n"
        "from ipc_tpu_torch.scenes import build_scene\n"
        "from ipc_tpu_torch.jit_step import make_step\n"
        "from ipc_tpu_torch.scenes import build_twist_scene\n"
        "for contact in (False, True):\n"
        "    st = build_scene(2, 'float64', 'cpu', with_contact=contact)\n"
        "    s, stats = make_step(st)(st.initial_state())\n"
        "    assert stats.newton_iters > 0 and (st.sc is not None) == contact\n"
        "st = build_twist_scene(3, 'float64', 'cpu')\n"
        "s, stats = make_step(st)(st.initial_state())\n"
        "assert stats.script_scale == 1.0\n"
        "import ipc_tpu_torch.__main__, ipc_tpu_torch.sim, ipc_tpu_torch.config\n"
        "import ipc_tpu_torch.io_mesh, ipc_tpu_torch.utils.observability\n"
        "import ipc_tpu_torch.utils.render\n"
        "import ipc_tpu_torch.diagnostic, ipc_tpu_torch.meshproc\n"
        "from ipc_tpu_torch.qp.stepper import QPStepper\n"
        "q = QPStepper(st.mesh, st.meta, st.p, self_contact=st.sc, mode='SQP',\n"
        "              constraint_type='verschoor')\n"
        "s, stats = q.step(q.initial_state())\n"
        "assert stats.iters > 0 and q.operator_applications > 0\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    assert ipc_tpu_torch.diagnostic.ccd_probe('cpu')\n"
        "from ipc_tpu_torch.parallel.launch import launch\n"
        "from ipc_tpu_torch.parallel.jobs import step_job\n"
        "import ipc_tpu_torch.parallel.__main__\n"
        "outs = launch(step_job, 2, 'gloo', 'cpu', (dict(n_cells=1, dtype='float64',\n"
        "              with_contact=True),), timeout=240)\n"
        "assert all(o['rows'][0]['stats']['newton_iters'] > 0 for o in outs)\n"
        "assert not any(o['foreign_modules'] for o in outs), outs\n"
        "import ipc_tpu_torch.native\n"
        "ipc_tpu_torch.native.available()\n"
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
    for name in ("qp/constraints.py", "qp/admm.py", "qp/stepper.py", "diagnostic.py",
                 "meshproc.py", "parallel/spmd.py", "parallel/sharding.py",
                 "parallel/launch.py", "parallel/jobs.py", "parallel/__main__.py",
                 "native/__init__.py"):
        assert os.path.join(ROOT, "ipc_tpu_torch", name) in paths
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
