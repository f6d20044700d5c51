"""The port's paper_battery parent (ipc_tpu_torch/tools/paper_battery.py
main), on the CPU: one child process per scene file, under the hard
timeout --budget + --headroom.

The folder (written into tmp_path from models/primitives.py):
* matTwist4.txt, the mat(4) twist with scenes/matTwist20.txt's settings:
  PASS;
* matTwist225.txt, naming input/tetMeshes/mat225x225.msh, which is absent:
  SKIP, its reason naming the mesh;
* cubeOverlap.txt, two box_grid(2) boxes overlapping by half with
  self-contact: FAIL, from the initial-feasibility check (an intersected
  start state);
* meshSeqStall.txt, a falling box beside a kinematic triangle that
  follows a mesh sequence whose frame 2 is a named pipe with no writer.
  Step 1 reads frame 1 and prints its PROG line; step 2 blocks on the pipe
  for good, so the child is always killed at --budget + --headroom,
  whatever the host's speed: TIMEOUT, with the PROG fields salvaged
  (verts, tets, step 1, its sysE/M/L). The budget is far above one step
  of this 96-tet scene, and the headroom leaves the child several times
  the ~5 s it takes to import torch and reach step 2.

The first sweep skips matTwist4: while it waits on the stalled child, the
table file must already hold the records before it (rewritten after every
record). Then --resume runs only matTwist4 and keeps the earlier records.
--route picks each scene's lane from its mesh bytes (every shape
instance, resolved from the scene's folder). The parent needs --scenes
and exits 1 where it finds no scene. The tools run with `jax`,
`ipc_tpu` and the repo's `tools` made
unimportable in a subprocess; without --device, or with --device cuda,
they refuse to run on a machine without a card, as batch does.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ipc_tpu_torch import io_mesh
from ipc_tpu_torch.models.primitives import box_grid
from ipc_tpu_torch.tools import batch as PBATCH
from ipc_tpu_torch.tools import paper_battery as PB
from ipc_tpu_torch.tools.twist_scenes import TWIST_SCENE, write_twist_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET, HEADROOM = 12.0, 8.0

HEAD = """energy NH
timeIntegration BE
time 1 0.025
density 1000
stiffness 1e5 0.4
"""
OVERLAP = HEAD + """shapes input 2
input/tetMeshes/box2.msh 0 0.5 0  0 0 0  1 1 1
input/tetMeshes/box2.msh 0.3 0.8 0.3  0 0 0  1 1 1
selfCollisionOn
"""
STALL = HEAD + """shapes input 2
input/tetMeshes/box2.msh 0 0.5 0  0 0 0  1 1 1
tri.obj 3 0 0  0 0 0  1 1 1  meshSeq seq
selfCollisionOff
"""


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("paper"))
    write_twist_scene(d, 4)
    _write(os.path.join(d, "matTwist225.txt"),
           TWIST_SCENE.format(mesh="input/tetMeshes/mat225x225.msh"))
    io_mesh.write_msh(os.path.join(d, "input", "tetMeshes", "box2.msh"), *box_grid(2, 2, 2))
    _write(os.path.join(d, "cubeOverlap.txt"), OVERLAP)
    tri = (np.array([[0.0, 0, 0], [1, 0, 0], [0, 0, 1]]), np.array([[0, 1, 2]]))
    io_mesh.write_obj(os.path.join(d, "tri.obj"), *tri)
    os.makedirs(os.path.join(d, "seq"))
    for frame in (0, 1):
        io_mesh.write_obj(os.path.join(d, "seq", f"{frame}.obj"), *tri)
    os.mkfifo(os.path.join(d, "seq", "2.obj"))
    _write(os.path.join(d, "meshSeqStall.txt"), STALL)
    return d


def _records(path):
    with open(path) as f:
        return {r["scene"]: r for r in json.load(f)}


def test_sweep_records_every_outcome(scenes, tmp_path):
    out = str(tmp_path / "battery.json")
    args = ["--scenes", scenes, "--device", "cpu", "--steps", "2", "--budget", str(BUDGET),
            "--headroom", str(HEADROOM), "--out", out]
    seen = {}

    def watch(sweep):
        # the stalled child runs last and cannot end before the timeout: the
        # file must hold the two records before it meanwhile
        while sweep.is_alive():
            if os.path.exists(out):
                seen.update(_records(out))
            if len(seen) == 2:
                return
            time.sleep(0.2)

    t0 = time.perf_counter()
    sweep = threading.Thread(target=PB.main, args=(args + ["--skip", "matTwist4"],))
    sweep.start()
    watch(sweep)
    sweep.join()
    assert sorted(seen) == ["cubeOverlap.txt", "matTwist225.txt"]
    assert time.perf_counter() - t0 >= BUDGET + HEADROOM

    first = _records(out)
    assert [r["scene"] for r in json.load(open(out))] == [
        "matTwist225.txt", "cubeOverlap.txt", "meshSeqStall.txt"]
    skip, fail, stall = (first[k] for k in ("matTwist225.txt", "cubeOverlap.txt",
                                            "meshSeqStall.txt"))
    assert skip["status"] == "SKIP" and "mat225x225.msh" in skip["reason"]
    assert fail["status"] == "FAIL"
    assert fail["error"].startswith("RuntimeError: initial state is self-intersected")
    assert stall["status"] == "TIMEOUT"
    assert (stall["verts"], stall["tets"], stall["step"]) == (30, 48, 1)
    assert len(stall["sysE"]) == len(stall["sysM"]) == len(stall["sysL"]) == 1
    assert all(r["config"] == "cpu-f64" for r in first.values())

    PB.main(args + ["--resume"])
    second = json.load(open(out))
    assert second[:3] == list(first.values())  # kept as they were, in order
    ok = second[3]
    assert (ok["scene"], ok["status"], ok["path"], ok["steps"], ok["tets"]) == (
        "matTwist4.txt", "PASS", "host", 2, 96)
    assert len(ok["sysE"]) == 2 and ok["newton_iters"] > 0


def test_tools_run_without_jax(scenes, tmp_path):
    """The child mode, batch and the summaries in a process where jax,
    ipc_tpu and the repo's tools cannot be imported."""
    out = str(tmp_path / "one.json")
    code = (
        "import contextlib, io, json, sys\n"
        "for m in ('jax', 'ipc_tpu', 'tools'):\n"
        "    sys.modules[m] = None\n"
        "from ipc_tpu_torch.tools import batch, battery_summary, paper_battery\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        f"    paper_battery.main(['--one', {os.path.join(scenes, 'matTwist4.txt')!r},\n"
        "                        '--steps', '1', '--device', 'cpu'])\n"
        "rec = [json.loads(l[7:]) for l in buf.getvalue().splitlines()\n"
        "       if l.startswith('RESULT ')][0]\n"
        "assert rec['status'] == 'PASS', rec\n"
        f"json.dump([rec], open({out!r}, 'w'))\n"
        f"battery_summary.main([{out!r}, '--md'])\n"
        "for m in ('jax', 'ipc_tpu', 'tools'):\n"
        "    sys.modules.pop(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ipc_tpu', 'tools')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'ipc_tpu.', 'tools.')))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "1 PASS over 1 records" in res.stdout


def test_no_device_means_the_card(scenes, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tools would run on it")
    scene = os.path.join(scenes, "matTwist4.txt")
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PB.main(["--one", scene, "--steps", "1", *device])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.main(["--scenes", scenes, "--out", str(tmp_path / "b.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PBATCH.main([scenes, "--out", str(tmp_path / "out"), "--steps", "1"])
    assert not os.path.exists(tmp_path / "b.json") and not os.path.exists(tmp_path / "out")


def test_flags_not_ported_are_refused(scenes):
    for flag in ("--grid-K", "--cap-scale", "--sync-every", "--burst", "--platform"):
        with pytest.raises(SystemExit):
            PB.main(["--one", os.path.join(scenes, "matTwist4.txt"), flag, "1"])


def test_the_parent_needs_a_folder_with_scenes(scenes, tmp_path):
    out = str(tmp_path / "b.json")
    with pytest.raises(SystemExit) as e:
        PB.main(["--device", "cpu", "--out", out])
    assert e.value.code == 2
    empty = tmp_path / "empty"
    empty.mkdir()
    assert PB.main(["--scenes", str(empty), "--device", "cpu", "--out", out]) == 1
    assert PB.main(["--scenes", scenes, "--only", "noSuchScene", "--device", "cpu",
                    "--out", out]) == 1
    assert not os.path.exists(out)


def test_route_splits_by_mesh_bytes(scenes):
    """--route: the scene's mesh bytes (each shape instance, resolved from
    the scene's folder) against --route-bytes pick its lane."""
    small = os.path.join(scenes, "matTwist4.txt")
    boxes = os.path.join(scenes, "cubeOverlap.txt")
    mesh = os.path.getsize(os.path.join(scenes, "input", "tetMeshes", "box2.msh"))
    assert PB.scene_mesh_bytes(boxes) == 2 * mesh  # two instances of one file
    assert PB.scene_mesh_bytes(os.path.join(scenes, "matTwist225.txt")) == 0  # absent
    n = PB.scene_mesh_bytes(small)
    assert n == os.path.getsize(os.path.join(scenes, "input", "tetMeshes", "mat4x4.msh"))

    def lane(route, path, limit):
        args = argparse.Namespace(route=route, route_bytes=limit, device="cpu",
                                     dtype="f64", jit="auto")
        return PB._lane(args, path)

    assert lane("", small, 0) == ("cpu", "f64", "auto")
    assert lane("auto", small, n) == ("cpu", "f64", "auto")
    assert lane("auto", small, n - 1) == ("cuda", "f32", "auto")
    assert lane("cpu-only", small, n - 1) is None and lane("gpu-only", small, n) is None
    assert lane("cpujit", small, n - 1) == ("cpu", "f32", "on")
    assert lane("cpujit", small, n) == ("cpu", "f64", "off")
