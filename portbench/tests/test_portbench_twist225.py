"""The twist225 configuration and its cell twist225.al on the CPU, without a
full-size build: the files parse, the cell resolves in BENCHMARK.json, the
configuration is twist100's at 225^2 cells, and the reference scene's
counts follow from the generator's arithmetic.

    python -m pytest portbench/tests -q
"""

import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.reference import scene as RS  # noqa: E402

N = 225


def _json(*path):
    with open(os.path.join(ROOT, *path)) as f:
        return json.load(f)


def test_cell_resolves():
    bench = _json("BENCHMARK.json")
    cfg = {c["name"]: c for c in bench["configs"]}["twist225"]
    assert cfg["file"] == "portbench/configs/twist225.json" and cfg["reduced"] == []
    assert cfg["source"] == _json(cfg["file"])["source"]
    w = {w["name"]: w for w in bench["workloads"]}["twist225.al"]
    assert (w["config"], w["traffic"], w["chips"]) == ("twist225", "al", 1)
    cell = harness.load_cell("twist225.al", root=ROOT)
    assert cell.chips == 1 and cell.config["name"] == "twist225"
    assert {"peak_mem_GiB", "setup_s"} <= set(cell.end_to_end)
    assert {"al.iters_per_step", "al.span_ms_per_step", "al.completed_share"} <= set(cell.metrics)
    for name in ("al.iters_per_step", "al.span_ms_per_step", "al.completed_share"):
        m = {m["name"]: m for m in bench["per_layer"]}[name]
        assert m["workloads"] == ["twist225.al"] and m["moves"] == "step_s"
    # no other cell reads the AL's metrics
    assert not any(n.startswith("al.") for n in harness.load_cell("twist100.turn", root=ROOT).metrics)


def test_traffic_and_limits():
    tr = _json("portbench", "traffic", "al.json")
    turn = _json("portbench", "traffic", "turn.json")
    assert (tr["steps_before"], tr["episode_steps"], tr["profile_step"]) == (0, 2, 1)
    assert tr["perturb"] == turn["perturb"]
    assert tr["perturb"]["params"] == {"amplitude": 0.01, "kmax": 3}
    lim = _json("portbench", "limits", "twist225.al.json")
    assert set(lim) == {"newton", "handle_err", "min_det", "min_gap", "crossings"}
    # a handle left at the prologue's clamp (script_scale 0.83-0.96) fails
    assert lim["handle_err"]["max"] <= 0.02


def test_configuration_is_twist100_at_225():
    big, small = _json("portbench", "configs", "twist225.json"), _json(
        "portbench", "configs", "twist100.json")
    assert big["args"] == dict(small["args"], n=N)
    # the 225^2 scene file of the suite twist100 names as its directory
    assert big["source"] == small["source"].replace("/tree/", "/blob/") + "/mat225x225_twist.txt"
    assert big["reduced"] == [] == small["reduced"]
    assert big["assumed"]["handle_ratio"] == small["assumed"]["handle_ratio"]
    assert set(small["guarantees"]) < set(big["guarantees"])
    assert any("moved > 1 - 1e-3" in g for g in big["guarantees"])
    body, body100 = big["scene"]["bodies"][0], small["scene"]["bodies"][0]
    assert body["cells"] == [N, 1, N] and body["size"] == [1.0, 1.0 / N, 1.0]
    assert {k: v for k, v in big["scene"].items() if k != "bodies"} == {
        k: v for k, v in small["scene"].items() if k != "bodies"}
    assert {k: v for k, v in body.items() if k not in ("cells", "size")} == {
        k: v for k, v in body100.items() if k not in ("cells", "size")}


def test_counts_follow_from_the_generator():
    """(nx+1)(ny+1)(nz+1) vertices and 6 nx ny nz tets: checked on the
    generator at small sizes, then read off at 225^2 against the counts the
    configuration and build_twist_scene state."""
    for cells in ([3, 1, 4], [5, 1, 5]):
        V, T = RS.box_grid(cells, [1.0, 0.1, 1.0], [0.0, 0.0, 0.0])
        nx, ny, nz = cells
        assert V.shape[0] == (nx + 1) * (ny + 1) * (nz + 1) and T.shape[0] == 6 * nx * ny * nz
    nx, ny, nz = _json("portbench", "configs", "twist225.json")["scene"]["bodies"][0]["cells"]
    n_verts, n_tets = (nx + 1) * (ny + 1) * (nz + 1), 6 * nx * ny * nz
    assert (n_verts, n_tets) == (102_152, 303_750)
    stated = _json("portbench", "configs", "twist225.json")["deployment"]
    assert re.search(r"303,750 tets, 102,152 vertices", stated)
    from ipc_tpu_torch import scenes

    assert "6 n^2 tets" in scenes.build_twist_scene.__doc__ and 6 * N * N == n_tets
