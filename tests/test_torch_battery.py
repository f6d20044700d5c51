"""The port's battery tools (ipc_tpu_torch/tools/) against the JAX tools
(tools/paper_battery.py, tools/battery_summary.py,
tools/gen_status_battery.py, loaded from their files), on the CPU in
float64.

* run_one on the host lane (IPCStepper.step): the mat(4) twist with
  scenes/matTwist20.txt's settings (self-contact on), 3 steps. Equal
  steps, status, path, script, Newton iterations, kappa doublings,
  intersection backtracks, AL iterations, verts and tets; sysE/M/L agree
  to the 6 significant digits both tools print, or, where float64
  rounding flips the last printed digit, within 1e-5 relative.
* run_one on the device lane (jit_step.make_step against JAX's
  make_jit_step): two box_grid(2) boxes over a ground half-space without
  self-contact, 2 steps; held as above.
* battery_summary and gen_status_battery on the repo's battery JSON
  (BATTERY_r2/r3/r5.json, out_r4/BATTERY_*_r4.json merged): the same
  printed lines, the same --merge-out file, and the same STATUS.md section
  byte for byte but for the generated-by marker's file name (each tool
  writes into its own copy of STATUS.md under tmp_path).

Both packages read the same scene files, written into tmp_path from the
port's models/primitives.py.
"""

import glob
import importlib.util
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from ipc_tpu_torch import io_mesh
from ipc_tpu_torch.models.primitives import box_grid
from ipc_tpu_torch.tools import battery_summary as PSUM
from ipc_tpu_torch.tools import gen_status_battery as PGEN
from ipc_tpu_torch.tools import paper_battery as PB
from ipc_tpu_torch.tools.twist_scenes import write_twist_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAME = ("scene", "verts", "tets", "script", "path", "steps", "status", "newton_iters",
        "kappa_doublings", "intersection_backtracks", "al_iters")
# the conservation columns: 6 significant digits, as printed; a flipped
# last digit is within 1e-5 relative
SYS_RTOL = 1e-5

BOXES = """energy NH
timeIntegration BE
time 0.25 0.025
density 1000
stiffness 1e5 0.4
shapes input 2
input/tetMeshes/box2.msh 0 0.01 0  0 0 0  1 1 1
input/tetMeshes/box2.msh 0 1.2 0  0 0 0  1 1 1
selfCollisionOff
halfSpace 0 0 0  0 1 0  1e10 0.1
"""


def _jax_tool(name):
    """The JAX tool tools/<name>.py, loaded from its file."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_boxes_scene(folder, name="boxes.txt"):
    mesh = os.path.join(folder, "input", "tetMeshes", "box2.msh")
    os.makedirs(os.path.dirname(mesh), exist_ok=True)
    io_mesh.write_msh(mesh, *box_grid(2, 2, 2))
    path = os.path.join(folder, name)
    with open(path, "w") as f:
        f.write(BOXES)
    return path


def _hold(port, ref):
    for k in SAME:
        assert port[k] == ref[k], (k, port[k], ref[k])
    for k in ("sysE", "sysM", "sysL"):
        assert len(port[k]) == len(ref[k]) == port["steps"], k
        np.testing.assert_allclose(port[k], ref[k], rtol=SYS_RTOL, atol=0.0, err_msg=k)
    assert "peak_mem_bytes" not in port  # a card-only field


def test_host_lane_matches_jax(tmp_path):
    scene = write_twist_scene(str(tmp_path), 4)
    ref = _jax_tool("paper_battery").run_one(scene, 3, 240.0, dtype=np.float64)
    counts = {}
    port = PB.run_one(scene, 3, 240.0, dtype=torch.float64, device="cpu", counts=counts)
    assert ref["path"] == "host" and ref["tets"] == 96 and ref["script"] == "twist"
    _hold(port, ref)
    assert counts["operator_applications"] > 0 and counts["host_syncs"] > 0


def test_device_lane_matches_jax(tmp_path):
    scene = write_boxes_scene(str(tmp_path))
    ref = _jax_tool("paper_battery").run_one(scene, 2, 240.0, dtype=np.float64, use_jit=True)
    port = PB.run_one(scene, 2, 240.0, dtype=torch.float64, use_jit=True, device="cpu")
    assert ref["path"] == "jit" and ref["verts"] == 54 and ref["newton_iters"] > 0
    _hold(port, ref)


def _batteries():
    r4 = sorted(glob.glob(os.path.join(ROOT, "out_r4", "BATTERY_*_r4.json")))
    assert len(r4) == 3
    return [[os.path.join(ROOT, n)] for n in ("BATTERY_r2.json", "BATTERY_r3.json",
                                              "BATTERY_r5.json")] + [r4]


@pytest.mark.parametrize("files", _batteries(), ids=["r2", "r3", "r5", "r4_merged"])
def test_summaries_match_jax(files, tmp_path, capsys, monkeypatch):
    jsum, jgen = _jax_tool("battery_summary"), _jax_tool("gen_status_battery")
    for f in files:
        for md in ([], ["--md"]):
            monkeypatch.setattr(sys, "argv", ["battery_summary.py", f, *md])
            jsum.main()
            ref = capsys.readouterr().out
            PSUM.main([f, *md])
            assert capsys.readouterr().out == ref
            assert ref.count("\n") > 2

    out = {}
    for tool, run in (("jax", lambda a: (monkeypatch.setattr(sys, "argv", ["g", *a]),
                                         jgen.main())),
                      ("port", PGEN.main)):
        d = tmp_path / tool
        d.mkdir()
        status = d / "STATUS.md"
        shutil.copy(os.path.join(ROOT, "STATUS.md"), status)
        run([*files, "--status", str(status), "--merge-out", str(d / "merged.json")])
        printed = capsys.readouterr().out.replace(str(d), "<dir>")
        out[tool] = (printed, status.read_text(), (d / "merged.json").read_bytes())
    jp, js, jm = out["jax"]
    pp, ps, pm = out["port"]
    assert pp == jp and pm == jm
    assert "generated by tools/gen_status_battery.py from" in js
    assert ps == js.replace("generated by tools/gen_status_battery.py",
                            "generated by ipc_tpu_torch/tools/gen_status_battery.py")
    assert f"**Battery tally over {len(json.loads(pm))} scene records:" in ps
    assert len(json.loads(pm)) == len({r["scene"] for f in files for r in json.load(open(f))})


def test_scene_file_steps_give_the_kernel_contiguous_vectors(tmp_path, monkeypatch):
    """A scene shape's rotation leaves its vertices column-major in numpy;
    the mesh and so the state and every PCG vector must be row-major, as
    the CUDA kernel takes only contiguous H and v (on the card the wrapper
    raises; on the CPU its plain path is watched for the same contract)."""
    from ipc_tpu_torch import step_terms

    seen = []

    def watched(H, v, table):
        seen.append(H.is_contiguous() and v.is_contiguous())
        return tet_hv(H, v, table)

    tet_hv = step_terms.tet_hv
    monkeypatch.setattr(step_terms, "tet_hv", watched)
    scene = write_twist_scene(str(tmp_path), 4)
    rec = PB.run_one(scene, 1, 240.0, dtype=torch.float32, use_jit=True, device="cpu")
    assert rec["status"] == "PASS" and rec["path"] == "jit"
    assert seen and all(seen), f"{seen.count(False)} of {len(seen)} calls non-contiguous"
