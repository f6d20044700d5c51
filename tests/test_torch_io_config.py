"""Port parity: the port's copies of io_mesh.py and config.py against the
JAX package's originals.

Mesh files: the same arrays written by both packages give the same bytes,
and files read by both give the same arrays (Gmsh .msh 4.1 and legacy 2.2,
.obj, .seg, .node/.ele). Scene files: `load_config` gives equal Config
fields (dataclasses compared field by field, arrays exactly) for the scene
texts of tests/test_scene_pipeline.py (tutorial style, DBC/NBC, meshCO with
rotate, half-spaces, tuning, restart) and for scenes/*.txt.
"""

import dataclasses
import math
import os

import numpy as np
import pytest

from ipc_tpu import config as JC
from ipc_tpu import io_mesh as JIO
from ipc_tpu_torch import config as PC
from ipc_tpu_torch import io_mesh as PIO
from ipc_tpu_torch.models.primitives import box_grid, cube

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(a, b, where="cfg"):
    """Deep equality of two parsed values from the two packages."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        fa, fb = dataclasses.fields(a), dataclasses.fields(b)
        assert [f.name for f in fa] == [f.name for f in fb], where
        for f in fa:
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b, equal_nan=True), where
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), where
    else:
        assert type(a) is type(b) and a == b, where


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_copies_keep_the_public_names():
    for j, p in ((JIO, PIO), (JC, PC)):
        assert j.__all__ == p.__all__
        for name in j.__all__:
            assert hasattr(p, name)


@pytest.mark.parametrize("n", [1, 3])
def test_mesh_files_round_trip_equal(tmp_path, n):
    V, T = box_grid(n, n + 1, 2)
    rng = np.random.default_rng(n)
    V = V + rng.normal(scale=1e-3, size=V.shape)  # full-precision coordinates
    F = T[:, [0, 1, 2]]
    E = T[:, [0, 3]]
    for ext, write, args in (("msh", "write_msh", (V, T)), ("obj", "write_obj", (V, F)),
                             ("seg", "write_seg", (V, E))):
        pj, pp = str(tmp_path / f"j.{ext}"), str(tmp_path / f"p.{ext}")
        getattr(JIO, write)(pj, *args)
        getattr(PIO, write)(pp, *args)
        assert _bytes(pj) == _bytes(pp), ext
        read = {"msh": "read_msh", "obj": "read_obj", "seg": "read_seg"}[ext]
        for a, b in zip(getattr(JIO, read)(pj), getattr(PIO, read)(pj)):
            assert a.dtype == b.dtype and np.array_equal(a, b), ext
    # write_obj without faces (a point set)
    JIO.write_obj(str(tmp_path / "jv.obj"), V)
    PIO.write_obj(str(tmp_path / "pv.obj"), V)
    assert _bytes(tmp_path / "jv.obj") == _bytes(tmp_path / "pv.obj")


def test_node_ele_and_legacy_msh_read_equal(tmp_path):
    V, T = cube(1)
    prefix = tmp_path / "shape"
    with open(f"{prefix}.node", "w") as f:
        f.write(f"{len(V)} 3 0 0\n")
        for i, p in enumerate(V):
            f.write(f"{i + 1} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r}\n")
    with open(f"{prefix}.ele", "w") as f:
        f.write(f"{len(T)} 4 0\n")
        for i, t in enumerate(T):
            f.write(f"{i + 1} {' '.join(str(int(k) + 1) for k in t)}\n")
    for a, b in zip(JIO.read_node_ele(str(prefix)), PIO.read_node_ele(str(prefix))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    legacy = tmp_path / "legacy.msh"
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat", "$Nodes", str(len(V))]
    lines += [f"{i + 1} {float(p[0])!r} {float(p[1])!r} {float(p[2])!r}" for i, p in enumerate(V)]
    lines += ["$EndNodes", "$Elements", str(len(T))]
    lines += [f"{i + 1} 4 2 0 1 {' '.join(str(int(k) + 1) for k in t)}" for i, t in enumerate(T)]
    lines += ["$EndElements"]
    legacy.write_text("\n".join(lines) + "\n")
    for a, b in zip(JIO.read_msh(str(legacy)), PIO.read_msh(str(legacy))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _scene_texts(tmp_path):
    V, T = cube(1)
    cube_path = str(tmp_path / "cube.msh")
    JIO.write_msh(cube_path, V, T)
    plate = str(tmp_path / "plate.obj")
    JIO.write_obj(plate, np.array([[-1.0, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]]),
                  np.array([[0, 2, 1], [0, 3, 2]]))
    return {
        "tutorial": f"""energy FCR
time 2 0.01
density 800
stiffness 2e5 0.35
shapes input 2
{cube_path} 0 3 0  0 0 0  1 1 1
{cube_path} 0 1 0  0 45 0  2 1 1  material 500 1e6 0.3  initVel 0 -1 0 0 0 0

selfFric 0.15
ground 0.1 0
dHat 5e-3
fricIterAmt 4
""",
        "dbc_nbc": f"""shapes input 1
{cube_path} 0 0 0  0 0 0  1 1 1  DBC 0 0 0 1 0.1 1  0 0 0  0 0 0  NBC 0 0.9 0 1 1 1  0 10 0 0.5 1.5
""",
        "meshco_rotate": f"""size 10
rotateModel 0 0 1 90
script MCOSquash
shapes input 1
{cube_path} 0 0.5 0  10 20 30  1 1 1
selfCollisionOff
meshCO {plate} 0.5 0 0.5 4 1e10 0.2 rotate 10 0 5
meshCO plate.obj 0 2 0 3 1e10 0.1
""",
        "halfspace": f"""shapes input 1
{cube_path} 0 0.5 0  0 0 0  1 1 1
halfSpace 0 0.2 0  0 1 0  50  0.5
halfSpace -1 0 0  1 0 0  10 0.0
turnOffGravity
timeIntegration NM 0.3 0.6
dampingStiff 1e-3
""",
        "tuning": f"""shapes input 1
{cube_path} 0 0.5 0  0 0 0  1 1 1
tuning 6
1e3 1e-3 1e-4 1e-9 1e-3 1e-4
tol 1
1e-2
useAbsParameters
epsv 1e-4
constraintSolver QP
constraintType graphics
warmStart 1
""",
        "restart": f"""shapes input 1
{cube_path} 0 0.5 0  0 0 0  1 1 1
restart {tmp_path}/status3.npz
appendStr _b
""",
    }


def test_scene_texts_parse_equal(tmp_path):
    texts = _scene_texts(tmp_path)
    for name, text in texts.items():
        path = tmp_path / f"{name}.txt"
        path.write_text(text)
        _same(JC.load_config(str(path)), PC.load_config(str(path)), name)
    # the cases parse to what they say (not just to the same thing)
    cfg = PC.load_config(str(tmp_path / "meshco_rotate.txt"))
    assert len(cfg.mesh_cos) == 2 and cfg.mesh_cos[0].friction == 0.2
    assert cfg.size == 10 and cfg.rotate_model is not None and not cfg.self_collision
    assert len(PC.load_config(str(tmp_path / "halfspace.txt")).halfspaces) == 2
    assert PC.load_config(str(tmp_path / "tuning.txt")).tuning[0] == 1e3
    assert PC.load_config(str(tmp_path / "restart.txt")).restart_path.endswith("status3.npz")


@pytest.mark.parametrize("scene", ["matTwist20.txt", "rollerTest.txt"])
def test_repo_scenes_parse_equal(scene):
    path = os.path.join(ROOT, "scenes", scene)
    _same(JC.load_config(path), PC.load_config(path), scene)


def test_save_config_writes_the_same_text(tmp_path):
    path = tmp_path / "tutorial.txt"
    path.write_text(_scene_texts(tmp_path)["tutorial"])
    cfg_j, cfg_p = JC.load_config(str(path)), PC.load_config(str(path))
    JC.save_config(cfg_j, str(tmp_path / "j.txt"))
    PC.save_config(cfg_p, str(tmp_path / "p.txt"))
    assert _bytes(tmp_path / "j.txt") == _bytes(tmp_path / "p.txt")
