"""The port's batch runner (ipc_tpu_torch/tools/batch.py) against the JAX
tool (tools/batch.py, run as a subprocess with --platform cpu), on the CPU
in float64: a folder of two scene files (two box_grid(2) boxes over a
ground half-space without self-contact, at two placements and two ground
frictions), 2 steps each on the host path, both tools' default.

The records (scene, ok, steps) are equal (wall times aside), each scene's
output folder holds the same file names, and every status{k}.npz's x
agrees within 1e-9. A scene that fails is recorded ok=false and the exit
code is 1.
"""

import json
import os
import subprocess
import sys

import numpy as np

from ipc_tpu_torch.tools import batch as PBATCH

from test_torch_battery import BOXES, write_boxes_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X_ATOL = 1e-9


def _records(stdout):
    return [json.loads(line) for line in stdout.splitlines() if line.startswith("{")]


def test_batch_matches_jax(tmp_path, capsys):
    scenes = tmp_path / "scenes"
    scenes.mkdir()
    write_boxes_scene(str(scenes), "dropA.txt")
    (scenes / "dropB.txt").write_text(
        BOXES.replace("0 1.2 0  0 0 0", "0.3 0.8 0  0 0 0").replace("1e10 0.1", "1e10 0.2"))
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "batch.py"), str(scenes), "--out",
         str(out_j), "--steps", "2", "--platform", "cpu"],
        cwd=str(tmp_path), env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    ref = _records(res.stdout)

    assert PBATCH.main([str(scenes), "--out", str(out_p), "--steps", "2",
                        "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    got = _records(printed)
    assert [r["scene"] for r in ref] == ["dropA", "dropB"]
    assert [{k: v for k, v in r.items() if k != "wall"} for r in got] == \
        [{k: v for k, v in r.items() if k != "wall"} for r in ref]
    assert all(r["ok"] and r["steps"] == 2 for r in got)
    assert printed.rstrip().endswith("# 2/2 scenes ok")
    for name in ("dropA", "dropB"):
        files = sorted(os.listdir(out_p / name))
        assert files == sorted(os.listdir(out_j / name))
        npz = [f for f in files if f.startswith("status") and f.endswith(".npz")]
        assert npz == ["status1.npz", "status2.npz"]
        for f in npz:
            xp, xj = np.load(out_p / name / f)["x"], np.load(out_j / name / f)["x"]
            assert xp.shape == xj.shape
            np.testing.assert_allclose(xp, xj, rtol=0.0, atol=X_ATOL)


def test_a_failing_scene_is_recorded(tmp_path, capsys):
    scenes = tmp_path / "scenes"
    scenes.mkdir()
    write_boxes_scene(str(scenes), "good.txt")
    (scenes / "missing.txt").write_text(BOXES.replace("box2.msh", "absent.msh"))
    assert PBATCH.main([str(scenes), "--out", str(tmp_path / "out"), "--steps", "1",
                        "--device", "cpu"]) == 1
    recs = _records(capsys.readouterr().out)
    assert [(r["scene"], r["ok"]) for r in recs] == [("good", True), ("missing", False)]
    assert "absent.msh" in recs[1]["error"]
