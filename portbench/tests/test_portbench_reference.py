"""The reference against the program at a small size: a sound run is
correct, and runs with the timed path broken underneath, the control in
bfloat16 and the planted faults are not.

The cells run with their own traffic, limits and reference on the CPU, at
3^3-cell boxes and a 12^2 mat in place of the configurations' sizes
(harness.run skips run.py's look for a card). The `cuda` test runs the
small twist cell, traced, on the card.
"""

import copy
import dataclasses
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.reference import judge as RJ  # noqa: E402

SMALL = {"boxes20": 3, "twist100": 12}


@pytest.fixture(scope="module")
def small_root(tmp_path_factory):
    """A checkout root whose configurations are the small versions."""
    root = tmp_path_factory.mktemp("small")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    os.makedirs(root / "portbench" / "configs")
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        n = SMALL[c["name"]]
        if "n_cells" in cfg["args"]:
            cfg["args"]["n_cells"] = n
            for body in cfg["scene"]["bodies"]:
                body["cells"] = [n, n, n]
        else:
            cfg["args"]["n"] = n
            body = cfg["scene"]["bodies"][0]
            body["cells"], body["size"] = [n, 1, n], [1.0, 1.0 / n, 1.0]
        (root / c["file"]).write_text(json.dumps(cfg))
    # the bypass cell, kept as files for a later benchmark (PERF.md)
    if not any(w["name"] == "boxes20.fall" for w in bench["workloads"]):
        bench["workloads"].append({"name": "boxes20.fall", "config": "boxes20",
                                   "traffic": "fall", "chips": 1, "why": "steps 0-1"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def _run(root, cell, step_wrap=None, seed=2_147_483_659, trace=False):
    c = harness.load_cell(cell, root=root)
    return harness.run(c, seed, 0.0, trace, torch.device("cpu"), log=lambda m: None,
                       step_wrap=step_wrap)


def _unchanged(step):
    """A step that returns its input state."""
    def broken(state):
        _, stats = step(state)
        return state, stats

    broken.__dict__ = step.__dict__
    return broken


def _altered(step):
    """A step whose output has one vertex moved by 0.05."""
    def broken(state):
        new, stats = step(state)
        x = new.x.clone()
        x[x.shape[0] // 2, 0] += 0.05
        return dataclasses.replace(new, x=x, x_prev=x), stats

    broken.__dict__ = step.__dict__
    return broken


@pytest.mark.parametrize("cell", ["boxes20.fall", "twist100.turn"])
def test_sound_run_is_correct(small_root, cell):
    res = _run(small_root, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == set(harness.load_cell(cell, root=small_root).end_to_end)
    assert {"peak_mem_GiB", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("cell,fault", [("boxes20.fall", _unchanged),
                                        ("boxes20.fall", _altered),
                                        ("twist100.turn", _unchanged),
                                        ("twist100.turn", _altered)])
def test_broken_step_is_not_correct(small_root, cell, fault):
    assert not _run(small_root, cell, step_wrap=fault)["correct"]


def test_traced_run_reads_its_counters(small_root):
    res = _run(small_root, "twist100.turn", trace=True)
    m = res["metrics"]
    assert m["newton.iters_per_step"]["value"] >= 1.0
    assert m["pcg.iters_per_newton"]["value"] > 0.0 and m["ccd.ms_per_step"]["value"] > 0.0
    # the device readers read nothing without a trace of the card
    assert "tet_hv_roofline" not in m and "device.idle_share" not in m


def test_traced_run_reads_the_cells_own_layer_metrics(small_root):
    """boxes20.impact reads its step time per layer: the traced window's
    step time and the layer readings under its own names."""
    res = _run(small_root, "boxes20.impact", trace=True)
    m = res["metrics"]
    assert res["correct"], res["checks"]
    assert m["step_s.traced"]["value"] > 0.0 and m["ccd.ms_per_step.impact"]["value"] > 0.0
    assert m["newton.iters_per_step.impact"]["value"] >= 1.0
    assert "ccd.ms_per_step" not in m and "newton.iters_per_step" not in m


@pytest.mark.parametrize("cell", ["boxes20.fall", "twist100.turn"])
def test_bfloat16_control_is_not_correct(small_root, cell):
    """The control: the program's chain with every state rounded to
    bfloat16 (the precision below the configuration's float32) fails a
    compared number."""
    c = harness.load_cell(cell, root=small_root)
    scene = harness.RS.build(c.config, "cpu")
    stepper, step = harness.build_program(c, torch.device("cpu"))
    state, x0, v0 = harness.initial_state(c, stepper, scene, 12345)
    chain = []
    for _ in range(c.traffic["steps_before"] + c.traffic["episode_steps"]):
        state, _ = step(state)
        chain.append(state.x.to(torch.bfloat16).double())
    x0b = torch.as_tensor(x0).to(torch.bfloat16).double()
    _, _, checks, correct = harness.judge(c, scene, x0b, v0, chain)
    assert not correct, checks


def test_planted_faults_read_far_above_sound(small_root):
    """The compared number separates: a step left unchanged and a moved
    vertex read at least ten times the sound chain's worst."""
    c = harness.load_cell("boxes20.fall", root=small_root)
    scene = harness.RS.build(c.config, "cpu")
    stepper, step = harness.build_program(c, torch.device("cpu"))
    state, x0, v0 = harness.initial_state(c, stepper, scene, 99)
    chain = []
    for _ in range(2):
        state, _ = step(state)
        chain.append(state.x.double())
    sound, _ = RJ.judge_chain(scene, x0, v0, chain)
    unchanged, _ = RJ.judge_chain(scene, x0, v0, [torch.as_tensor(x0)] * 2)
    moved = copy.deepcopy(chain)
    for x in moved:
        x[int(scene.surf[0]), 0] += 0.01
    moved_w, _ = RJ.judge_chain(scene, x0, v0, moved)
    assert unchanged["newton"] > 10 * sound["newton"]
    assert moved_w["newton"] > 10 * sound["newton"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_small_cell_on_the_card(small_root, cuda_device):
    c = harness.load_cell("twist100.turn", root=small_root)
    res = harness.run(c, 7, 0.0, True, cuda_device, log=lambda m: None)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0.0
    assert 0.0 < res["metrics"]["tet_hv_roofline"]["value"] <= 105.0
