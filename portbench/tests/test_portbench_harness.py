"""The benchmark harness on the CPU: files found by name, the contract's
shapes, the import checks and the kernel byte counts.

    python -m pytest portbench/tests -q
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    names = [c["name"] for c in b["configs"]]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    used = {w["config"] for w in b["workloads"]}
    assert used == set(names)
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert {"setup_s", "step_s", "peak_mem_GiB"} <= e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def _reports(b, cell):
    return {m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])}


def test_every_cell_reports_what_its_layers_move():
    """Each cell reports setup_s and another end-to-end metric, and each
    per-layer metric listed for a cell moves an end-to-end metric that the
    cell reports; one without a list is read in every cell that reports
    what it moves."""
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    for m in b["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells), m
    for cell in cells:
        e2e = _reports(b, cell)
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layers = [m for m in b["per_layer"] if cell in m.get("workloads", [cell])
                  and ("workloads" in m or m["moves"] in e2e)]
        assert layers and all(m["moves"] in e2e for m in layers), cell
        c = harness.load_cell(cell, root=ROOT)
        assert c.end_to_end == [m["name"] for m in b["end_to_end"] if m["name"] in e2e]
        assert set(c.metrics) == {m["name"] for m in layers}


def test_a_metric_file_can_read_as_another():
    """boxes20.impact reads step time per layer: its layer metrics are the
    twist's readings under names of their own, moving setup_s."""
    impact = harness.load_cell("boxes20.impact", root=ROOT)
    twist = harness.load_cell("twist100.turn", root=ROOT)
    assert "step_s" not in impact.end_to_end and "step_s" in twist.end_to_end
    assert impact.metrics["ccd.ms_per_step.impact"] == twist.metrics["ccd.ms_per_step"]
    assert impact.metrics["step_s.traced"] == ("json", {
        "about": impact.metrics["step_s.traced"][1]["about"], "ratio": ["window_s", "steps"]})
    kind, mod = impact.metrics["tet_hv_roofline.impact"]
    assert kind == "py" and mod.KERNELS == twist.metrics["tet_hv_roofline"][1].KERNELS
    assert not set(impact.metrics) & set(twist.metrics)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cells_found_by_name(cell):
    c = harness.load_cell(cell, root=ROOT)
    assert c.traffic["episode_steps"] >= 1 and hasattr(c.perturb, "apply")
    assert "newton" in c.limits and "min_det" in c.limits
    for name, (kind, spec) in c.metrics.items():
        assert (kind == "py" and hasattr(spec, "read")) or "wrap" in spec or "ratio" in spec


def test_new_cell_from_new_files_only(tmp_path):
    """A later cell is new files plus a workloads entry: nothing edited."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    b = _bench()
    b["workloads"].append({"name": "boxes20.rest", "config": "boxes20", "traffic": "rest",
                           "chips": 1, "why": "resting contact after the landing"})
    b["per_layer"].append({"name": "script.ms_per_step", "unit": "ms/step", "better": "lower",
                           "source": "program_span", "layer": "scripted prologue (scripting)",
                           "moves": "setup_s", "workloads": ["boxes20.rest"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "portbench/traffic/rest.json").write_text(json.dumps(
        {"steps_before": 12, "episode_steps": 2,
         "perturb": {"name": "rigid_place",
                     "params": {"body": 1, "offset": 0.05, "yaw_deg": 2.0}}}))
    (root / "portbench/limits/boxes20.rest.json").write_text(
        (root / "portbench/limits/boxes20.impact.json").read_text())
    (root / "portbench/metrics/script.ms_per_step.json").write_text(
        json.dumps({"wrap": ["ipc_tpu_torch.scripting:device_closures"]}))
    c = harness.load_cell("boxes20.rest", root=str(root), bench_dir=str(root / "portbench"))
    assert c.traffic["steps_before"] == 12 and "script.ms_per_step" in c.metrics
    assert c.end_to_end == ["peak_mem_GiB", "setup_s"]
    assert "script.ms_per_step" not in harness.load_cell(
        "boxes20.impact", root=str(root), bench_dir=str(root / "portbench")).metrics


def test_forbidden_by_top_level_name():
    assert harness.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla", "ipc_tpu.mesh",
                                      "flax"]) == sorted(["jax", "jax.numpy", "jaxlib.xla",
                                                          "ipc_tpu.mesh", "flax"])
    assert harness.forbidden_modules(["ipc_tpu_torch", "ipc_tpu_torch.jit_step", "jaxtyping",
                                      "torch", "portbench.harness"]) == []


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] not in ("ipc_tpu_torch", "ipc_tpu", "jax", "jaxlib"), \
                    (f, mod)
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.judge, "
            "portbench.reference.scene; bad = [m for m in sys.modules if m.split('.')[0] in "
            "('ipc_tpu_torch', 'ipc_tpu', 'jax', 'jaxlib')]; print(bad); "
            "sys.exit(1 if bad else 0)" % ROOT)
    assert subprocess.run([sys.executable, "-c", code], capture_output=True).returncode == 0


def test_harness_sources_import_no_jax():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in ("jax", "jaxlib", "flax", "ipc_tpu"), \
                        (f, mod)


def test_tet_hv_bytes():
    k = harness.kernel_module("tet_hv")
    assert k.bytes_moved(96_000, 18_522, 4) == 57_276_528
    assert k.bytes_moved(60_000, 20_402, 4) == 36_009_648


def test_no_device_no_result():
    """run.py exits non-zero and prints no result without the cell's cards
    (here: no CUDA device at all)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "boxes20.fall", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_trace_reduction():
    """Busy time is the union of kernel intervals; idle gaps are named by
    the layer range over their midpoint; layer ranges on the device are not
    kernels."""
    from portbench.tracing import reduce_trace

    events = [(True, "k1", 10.0, 20.0), (True, "k2", 15.0, 30.0), (True, "k1", 60.0, 70.0),
              (False, "ccd.ms_per_step", 30.0, 65.0), (True, "ccd.ms_per_step", 30.0, 65.0),
              (False, "aten::add", 0.0, 5.0)]
    red = reduce_trace(events, 0.0, 100.0, {"ccd.ms_per_step"})
    assert abs(red["busy_s"] - 30e-6) < 1e-12
    assert abs(red["kernels"]["k1"] - 20e-6) < 1e-12
    assert abs(red["idle"]["ccd.ms_per_step"] - 30e-6) < 1e-12
    assert abs(red["idle"]["step control (jit_step)"] - 40e-6) < 1e-12


def test_trace_events_of_a_profile():
    import torch

    from portbench.tracing import trace_events

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("portbench.window"):
            torch.ones(8).sum()
    ev = [e for e in trace_events(prof) if e[1] == "portbench.window"]
    assert len(ev) == 1 and not ev[0][0] and ev[0][3] > ev[0][2]


def test_window_annotation_is_not_a_kernel_or_a_layer():
    from portbench.tracing import reduce_trace

    events = [(False, "portbench.window", 0.0, 100.0), (True, "portbench.window", 0.0, 100.0),
              (True, "k", 40.0, 60.0)]
    red = reduce_trace(events, 0.0, 100.0, set(), skip={"portbench.window"})
    assert red["kernels"] == {"k": 20e-6} and list(red["idle"]) == ["step control (jit_step)"]
