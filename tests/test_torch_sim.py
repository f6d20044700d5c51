"""Port parity: the scene driver (sim.py, __main__.py, utils/observability.py)
against the JAX package's, in float64 on the CPU.

The scene (written into a temporary directory): two box_grid(2) boxes as
.msh shapes at y 0.01 and 1.2, NH, BE, dt 0.025, selfCollisionOn, selfFric
0.1, no ground: a two-triangle meshCO plate, 4 wide at y = 0, friction
0.2. JAX runs it once through `Simulation.run(use_jit_step=True)` (4
steps, a status file per step; the compile takes most of this file's
time). The port must give:

* the same assembly (mesh arrays, meta, script DBC, obstacle ranges,
  vert_mu) for a scene with two .msh shapes, a codimensional .obj, size,
  rotateModel and a meshCO;
* the same run: identical Newton, PCG, kappa-doubling, candidate, active
  and friction counts per step (kappa to 1e-12), iterStats.txt identical
  in its Newton and active columns, every status x within 1e-9, sysE/M/L
  within 1e-9 relative, the same surface meshes' faces;
* a JAX checkpoint restarts the port, whose next step equals JAX's;
* restart determinism: 4 steps == 2 steps, save, a fresh Simulation,
  load, 2 steps, bitwise; the text status file round-trips exactly;
* the pinned ACO checkpoint behaviour (ROADMAP §3): the status file holds
  the planes' initial origins and velocities, as JAX's does, though the
  planes moved, so a restart starts them from there again;
* `python -m ipc_tpu_torch --device cpu` runs with jax and ipc_tpu made
  unimportable; without --device it refuses to run without a card, on
  either stepper; the QP stepper raises NotImplementedError;
* the host path: the CLI without --jit-step (IPCStepper.step) writes
  JAX's `python -m ipc_tpu` iterStats.txt to the printed precision, and
  on an ACO scene its checkpoint holds the moved planes, as JAX's host
  path's does, so a restart reproduces the uninterrupted run bitwise.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ipc_tpu import io_mesh as JIO
from ipc_tpu import jit_step as JJ
from ipc_tpu import sim as JS
from ipc_tpu.config import load_config as jload
from ipc_tpu_torch import sim as PS
from ipc_tpu_torch.__main__ import main
from ipc_tpu_torch.config import load_config
from ipc_tpu_torch.jit_step import initial_device_aux
from ipc_tpu_torch.mesh import MESH_FIELDS
from ipc_tpu_torch.models.primitives import box_grid, cube
from ipc_tpu_torch.utils.observability import load_status_text, save_status_text

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLATE_V = np.array([[-2.0, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]])
PLATE_F = np.array([[0, 2, 1], [0, 3, 2]])
N_STEPS = 4
COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings", "pt_count", "ee_count",
          "et_count", "active_pt_max", "active_ee_max", "fric_count", "al_iters")

SCENE = """energy NH
timeIntegration BE
time 0.25 0.025
density 1000
stiffness 1e5 0.4
shapes input 2
box.msh 0 0.01 0  0 0 0  1 1 1
box.msh 0 1.2 0  0 0 0  1 1 1
selfCollisionOn
selfFric 0.1
meshCO plate.obj 0.5 0 0.5 4 1e10 0.2
"""


def _write(d, name, text):
    path = os.path.join(d, name)
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    V, T = box_grid(2, 2, 2)
    JIO.write_msh(os.path.join(d, "box.msh"), V, T)
    JIO.write_obj(os.path.join(d, "plate.obj"), PLATE_V, PLATE_F)
    _write(d, "scene.txt", SCENE)
    return d


@pytest.fixture(scope="module")
def jax_run(scene_dir):
    """JAX's run directory and its per-step stats (its driver keeps them
    out of the artifacts: the step function is wrapped to record them)."""
    out = os.path.join(scene_dir, "out_jax")
    sim = JS.Simulation(jload(os.path.join(scene_dir, "scene.txt")))
    stats = []
    make = JJ.make_jit_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def run(state):
            state, js = step(state)
            stats.append({k: np.asarray(getattr(js, k)).item() for k in COUNTS + ("kappa",)})
            return state, js

        return run

    JJ.make_jit_step = recording
    try:
        sim.run(out, n_steps=N_STEPS, save_every=1, use_jit_step=True)
    finally:
        JJ.make_jit_step = make
    return out, stats


@pytest.fixture(scope="module")
def port_run(scene_dir):
    out = os.path.join(scene_dir, "out_port")
    sim = PS.Simulation(load_config(os.path.join(scene_dir, "scene.txt")), device="cpu")
    last = sim.run(out, n_steps=N_STEPS, save_every=1, use_jit_step=True)
    return out, sim, last


def _rows(path):
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


def test_assemble_matches_jax(tmp_path):
    V, T = cube(1)
    JIO.write_msh(str(tmp_path / "cube.msh"), V, T)
    Vb, Tb = box_grid(2, 1, 2)
    JIO.write_msh(str(tmp_path / "slab.msh"), Vb, Tb)
    JIO.write_obj(str(tmp_path / "cloth.obj"), PLATE_V * 0.25, PLATE_F)
    JIO.write_obj(str(tmp_path / "plate.obj"), PLATE_V, PLATE_F)
    path = _write(str(tmp_path), "scene.txt", """energy NH
size 3
rotateModel 0 0 1 30
shapes input 3
cube.msh 0 0.5 0  0 0 0  1 1 1
cloth.obj 0 2 0  0 0 0  1 1 1
slab.msh 0.2 1.0 0  0 30 0  1 2 1  material 500 2e5 0.3
selfCollisionOn
selfFric 0.05
meshCO plate.obj 1 -0.1 1 6 1e10 0.3 rotate 5 0 0
""")
    pm, pmeta, pscript = PS.assemble(load_config(path), torch.float64, "cpu")
    jm, jmeta, jscript = JS.assemble(jload(path), np.float64)
    psim = PS.Simulation(load_config(path), device="cpu")
    jsim = JS.Simulation(jload(path))
    for (a, am), (b, bm) in (((pm, pmeta), (jm, jmeta)),
                             ((psim.mesh, psim.meta), (jsim.mesh, jsim.meta))):
        for name in MESH_FIELDS:
            x, y = getattr(a, name).numpy(), np.asarray(getattr(b, name))
            assert x.shape == y.shape and np.array_equal(x, y), name
        for f in ("n_verts", "n_tets", "bbox_diag2", "avg_edge_len", "avg_node_mass",
                  "comp_ranges"):
            assert getattr(am, f) == getattr(bm, f), f
        assert np.array_equal(am.bbox, bm.bbox)
    assert np.array_equal(pscript.dbc_mask(), jscript.dbc_mask())
    assert psim.mesh_co_ranges == jsim.mesh_co_ranges and len(psim.mesh_co_ranges) == 1
    assert psim.n_script_verts == jsim.n_script_verts
    assert np.array_equal(psim.stepper.sc.vert_mu.numpy(),
                          np.asarray(jsim.stepper.sc.vert_mu))
    assert psim.stepper.sc.friction == jsim.stepper.sc.friction == 0.05
    assert psim.params == type(psim.params)(**vars(jsim.params))
    # the codimensional cloth and the obstacle are kinematic surfaces
    assert pmeta.n_verts == 8 + 18 + 4 and psim.meta.n_verts == pmeta.n_verts + 4
    assert bool(psim.mesh.dbc_mask[26:].all()) and not bool(psim.mesh.dbc_mask[:26].any())


def test_run_matches_jax(jax_run, port_run):
    jax_run, jax_stats = jax_run
    out_p, sim, last = port_run
    # the step's counts, from the port's info.txt and JAX's recorded stats
    with open(os.path.join(out_p, "info.txt")) as f:
        info = json.load(f)
    assert len(info["step_stats"]) == len(jax_stats) == N_STEPS
    for ps, js in zip(info["step_stats"], jax_stats):
        assert {k: ps[k] for k in COUNTS} == {k: js[k] for k in COUNTS}
        np.testing.assert_allclose(ps["kappa"], js["kappa"], rtol=1e-12)
    assert sum(s["fric_count"] for s in jax_stats) > 0
    assert info["operator_applications"] > 0 and info["host_syncs"] > 0
    it_p, it_j = _rows(os.path.join(out_p, "iterStats.txt")), _rows(
        os.path.join(jax_run, "iterStats.txt"))
    # one line per Newton iteration; step and active-constraint columns
    assert [(r[0], r[2]) for r in it_p] == [(r[0], r[2]) for r in it_j]
    assert max(int(r[2]) for r in it_p) > 0
    for k in range(1, N_STEPS + 1):
        zp = np.load(os.path.join(out_p, f"status{k}.npz"))
        zj = np.load(os.path.join(jax_run, f"status{k}.npz"))
        assert int(zp["step"]) == int(zj["step"]) == k and float(zp["t"]) == float(zj["t"])
        for f in ("x", "v", "a"):
            assert zp[f].dtype == np.float64
        np.testing.assert_allclose(zp["x"], zj["x"], rtol=0, atol=1e-9)
        Vp, Fp = JIO.read_obj(os.path.join(out_p, f"surf{k}.obj"))
        Vj, Fj = JIO.read_obj(os.path.join(jax_run, f"surf{k}.obj"))
        assert np.array_equal(Fp, Fj)
        np.testing.assert_allclose(Vp, Vj, rtol=0, atol=1e-9)
    for name in ("sysE.txt", "sysM.txt", "sysL.txt"):
        a = np.array(_rows(os.path.join(out_p, name)), float)
        b = np.array(_rows(os.path.join(jax_run, name)), float)
        assert a.shape == b.shape == (N_STEPS, {"sysE.txt": 3}.get(name, 9))
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9 * np.abs(b).max())
    rp, rj = _rows(os.path.join(out_p, "resultsStats.txt")), _rows(
        os.path.join(jax_run, "resultsStats.txt"))
    assert rp[:2] == rj[:2]  # steps, iterations per step
    for name in ("info.txt", "config.txt"):
        assert os.path.exists(os.path.join(out_p, name))
    # the obstacle stayed where it was placed, bitwise
    p0, p1 = sim.mesh_co_ranges[0]
    assert torch.equal(last.x[p0:p1], sim.mesh.x_rest[p0:p1])
    assert float(last.x[:p0, 1].min()) > 0.0


def test_jax_checkpoint_restarts_the_port(scene_dir, jax_run):
    jax_run = jax_run[0]
    scene = _write(scene_dir, "restart_jax.txt",
                   SCENE + f"restart {os.path.join(jax_run, 'status2.npz')}\n")
    out = os.path.join(scene_dir, "out_restart_jax")
    sim = PS.Simulation(load_config(scene), device="cpu")
    s = sim.run(out, n_steps=3, save_every=1, use_jit_step=True)
    assert s.step == 3 and not os.path.exists(os.path.join(out, "status2.npz"))
    zj = np.load(os.path.join(jax_run, "status3.npz"))
    np.testing.assert_allclose(s.x.numpy(), zj["x"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(s.v.numpy(), zj["v"], rtol=0, atol=1e-9 / 0.025)


def test_restart_bitwise_determinism(scene_dir, port_run, tmp_path):
    out_full = port_run[0]
    out_a = str(tmp_path / "a")
    PS.Simulation(load_config(os.path.join(scene_dir, "scene.txt")), device="cpu").run(
        out_a, n_steps=2, save_every=2, use_jit_step=True)
    scene = _write(scene_dir, "restart_port.txt",
                   SCENE + f"restart {os.path.join(out_a, 'status2.npz')}\n")
    fresh = PS.Simulation(load_config(scene), device="cpu")
    s = fresh.run(str(tmp_path / "b"), n_steps=N_STEPS, save_every=2, use_jit_step=True)
    ref = np.load(os.path.join(out_full, f"status{N_STEPS}.npz"))
    got = np.load(str(tmp_path / "b" / f"status{N_STEPS}.npz"))
    for f in ("x", "v", "a"):
        assert got[f].tobytes() == ref[f].tobytes(), f
    assert float(got["t"]) == float(ref["t"])
    # the reference's text status format round-trips exactly
    save_status_text(str(tmp_path / "status4"), s, N_STEPS)
    back = load_status_text(str(tmp_path / "status4"), fresh.stepper)
    for f in ("x", "v", "a"):
        assert torch.equal(getattr(back, f), getattr(s, f)), f
    assert back.step == N_STEPS and back.x.dtype == torch.float64


ACO_SCENE = """energy NH
time 1 0.025
turnOffGravity
script ACOSquash
shapes input 1
cube.msh 0 0 0  0 0 0  1 1 1
selfCollisionOff
halfSpace -0.3 0 0  1 0 0  1 0.1
halfSpace 1.3 0 0  -1 0 0  1 0.1
"""


def test_aco_checkpoint_keeps_the_initial_planes(tmp_path):
    """The pinned reference behaviour (ROADMAP §3): the device step keeps the
    planes in SimState.aux, but a checkpoint stores the stepper's initial
    origins and velocities, in both packages; a restart from it starts the
    planes there again, not where they were."""
    V, T = cube(1)
    JIO.write_msh(str(tmp_path / "cube.msh"), V, T)
    path = _write(str(tmp_path), "aco.txt", ACO_SCENE)
    JS.Simulation(jload(path)).run(str(tmp_path / "j"), n_steps=2, save_every=2,
                                   use_jit_step=True)
    psim = PS.Simulation(load_config(path), device="cpu")
    last = psim.run(str(tmp_path / "p"), n_steps=2, save_every=2, use_jit_step=True)
    zj, zp = np.load(str(tmp_path / "j" / "status2.npz")), np.load(
        str(tmp_path / "p" / "status2.npz"))
    initial = np.array([[-0.3, 0.0, 0.0], [1.3, 0.0, 0.0]])
    for z in (zj, zp):
        assert np.array_equal(z["hs_origin"], initial)
        assert np.array_equal(z["aco_vel"], [[1.0, 0, 0], [-1.0, 0, 0]])
    np.testing.assert_allclose(zp["x"], zj["x"], rtol=0, atol=1e-9)
    moved = last.aux["hs_origin"].numpy()
    assert np.abs(moved - initial).max() > 1e-3  # the planes did move
    restarted = PS.Simulation(load_config(
        _write(str(tmp_path), "aco_restart.txt",
               ACO_SCENE + f"restart {tmp_path / 'p' / 'status2.npz'}\n")), device="cpu")
    state = restarted.initial_state()
    aux = initial_device_aux(restarted.stepper)
    assert state.step == 2 and np.array_equal(aux["hs_origin"].numpy(), initial)


def test_cli_runs_without_jax_on_the_cpu(scene_dir):
    out = os.path.join(scene_dir, "out_cli")
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ipc_tpu'] = None\n"
        f"sys.argv = ['ipc_tpu_torch', {os.path.join(scene_dir, 'scene.txt')!r}, '--jit-step',\n"
        f"            '--device', 'cpu', '-n', '2', '-o', {out!r}]\n"
        "try:\n"
        "    runpy.run_module('ipc_tpu_torch', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "sys.modules.pop('jax')\n"
        "sys.modules.pop('ipc_tpu')\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ipc_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ipc_tpu.')))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "done: 2 steps" in res.stdout
    for name in ("iterStats.txt", "sysE.txt", "sysM.txt", "sysL.txt", "info.txt",
                 "resultsStats.txt", "status1.npz", "status2.npz", "surf2.obj"):
        assert os.path.exists(os.path.join(out, name)), name


def test_what_is_not_ported_raises(scene_dir, tmp_path):
    scene = os.path.join(scene_dir, "scene.txt")
    qp = _write(scene_dir, "qp.txt", SCENE + "constraintSolver QP\n")
    # constraintSolver QP builds the QP stepper; the device step (the IP
    # solve) does not take it
    sim = PS.Simulation(load_config(qp), device="cpu")
    assert type(sim.stepper).__name__ == "QPStepper" and sim.stepper.mode == "QP"
    with pytest.raises(ValueError, match="host path only"):
        sim.run(str(tmp_path / "qp"), n_steps=1, use_jit_step=True)
    if not torch.cuda.is_available():
        # no --device: the card, and no quiet fall back to the CPU
        for i, extra in enumerate(([], ["--jit-step"])):
            with pytest.raises(RuntimeError, match="CUDA"):
                main([scene, *extra, "-n", "1", "-o", str(tmp_path / f"card{i}")])


N_HOST = 3


def test_cli_host_path_matches_jax(scene_dir):
    """Both CLIs without --jit-step (the host path), 3 steps of the scene."""
    from ipc_tpu.__main__ import main as jax_main

    scene = os.path.join(scene_dir, "scene.txt")
    out_j, out_p = (os.path.join(scene_dir, d) for d in ("host_jax", "host_port"))
    assert jax_main([scene, "-n", str(N_HOST), "-o", out_j]) == 0
    assert main([scene, "--device", "cpu", "-n", str(N_HOST), "-o", out_p]) == 0
    with open(os.path.join(out_p, "iterStats.txt")) as f:
        it_p = f.read()
    with open(os.path.join(out_j, "iterStats.txt")) as f:
        it_j = f.read()
    assert it_p == it_j
    assert len(it_p.splitlines()) > N_HOST  # more than one Newton iteration per step
    rp, rj = _rows(os.path.join(out_p, "resultsStats.txt")), _rows(
        os.path.join(out_j, "resultsStats.txt"))
    assert rp[:2] == rj[:2]
    with open(os.path.join(out_p, "info.txt")) as f:
        info = json.load(f)
    assert info["operator_applications"] > 0 and info["host_syncs"] > 0
    assert [s["iters"] for s in info["step_stats"]] == [
        sum(1 for r in it_p.splitlines() if r.split()[0] == str(k)) for k in range(N_HOST)]
    for k in range(1, N_HOST + 1):
        zp = np.load(os.path.join(out_p, f"status{k}.npz"))
        zj = np.load(os.path.join(out_j, f"status{k}.npz"))
        np.testing.assert_allclose(zp["x"], zj["x"], rtol=0, atol=1e-9)


def test_host_path_aco_restart_is_bitwise(tmp_path):
    """On the host path the stepper moves the planes and a checkpoint holds
    where they are, as JAX's host path's does: a restart from status2
    reproduces the uninterrupted run's status4 bitwise, planes included."""
    V, T = cube(1)
    JIO.write_msh(str(tmp_path / "cube.msh"), V, T)
    path = _write(str(tmp_path), "aco.txt", ACO_SCENE)
    JS.Simulation(jload(path)).run(str(tmp_path / "j"), n_steps=2, save_every=2)
    PS.Simulation(load_config(path), device="cpu").run(str(tmp_path / "p"), n_steps=4,
                                                       save_every=2)
    zj, zp = (np.load(str(tmp_path / d / "status2.npz")) for d in ("j", "p"))
    initial = np.array([[-0.3, 0.0, 0.0], [1.3, 0.0, 0.0]])
    assert np.abs(zp["hs_origin"] - initial).max() > 1e-3  # the planes moved
    np.testing.assert_allclose(zp["hs_origin"], zj["hs_origin"], rtol=0, atol=1e-12)
    assert np.array_equal(zp["aco_vel"], zj["aco_vel"])
    np.testing.assert_allclose(zp["x"], zj["x"], rtol=0, atol=1e-9)
    restart = _write(str(tmp_path), "aco_restart.txt",
                     ACO_SCENE + f"restart {tmp_path / 'p' / 'status2.npz'}\n")
    sim = PS.Simulation(load_config(restart), device="cpu")
    s = sim.run(str(tmp_path / "r"), n_steps=4, save_every=2)
    assert s.step == 4
    ref, got = (np.load(str(tmp_path / d / "status4.npz")) for d in ("p", "r"))
    for f in ("x", "v", "a", "hs_origin", "aco_vel"):
        assert got[f].tobytes() == ref[f].tobytes(), f
