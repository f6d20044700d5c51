"""The benchmark's readers of the moving-DBC AL (portbench/metrics/al.*)
and the span and counters they read.

* On stub span rounds: each metric reads its counters or the `al_iter`
  spans from a span round's summary; a program without them (the parent of
  these metrics) gives no reading and no error.
* On the port's device step, on the CPU in float64, a two-cube press whose
  scripted half is blocked by contact: every AL iteration's `newton` span
  holds one `al_iter` span, which covers the iteration after its AL read,
  and the AL counters agree with StepStats.al_iters; with tracing off the
  step records nothing and gives the same bits.
* The entries name the one cell that reads them, and the cell reads
  `twist100.turn`'s twist-only layers through `<metric>.al` twins.
"""

import json
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ipc_tpu_torch.utils import observability as obs  # noqa: E402
from ipc_tpu_torch.utils.observability import Span  # noqa: E402
from portbench import harness, spans  # noqa: E402

AL_METRICS = ("al.iters_per_step", "al.span_ms_per_step", "al.completed_share")


@pytest.fixture(autouse=True)
def _tracing_off():
    obs.set_tracing(False)
    obs.collect()
    yield
    obs.set_tracing(False)
    obs.collect()


def _reader(name):
    kind, mod = harness._metric_spec(name, harness.BENCH)
    assert kind == "py"
    return mod


def _recording(al_iter="al_iter"):
    """Two steps: step 0 with two AL iterations and a projected one, step
    1 with none."""
    return dict(spans=[
        Span(1, 0, "step", 0, 1000, {}),
        Span(2, 1, "newton", 10, 310, {"k": 0}),
        Span(7, 2, al_iter, 20, 300, {}),
        Span(3, 1, "newton", 310, 510, {"k": 1}),
        Span(8, 3, al_iter, 320, 500, {}),
        Span(4, 1, "newton", 510, 600, {"k": 2}),
        Span(5, 0, "step", 1000, 1500, {}),
        Span(6, 5, "newton", 1010, 1400, {"k": 0}),
    ], counters={"al.episodes": 2, "al.iters": 6, "al.completed": 1, "al.stalled": 1,
                 "newton.iters": 9}, reads={})


def test_summary_sums_al_iter_spans():
    s = spans.summarize(_recording(), 2, 1e-6)
    assert s["span_ns"]["newton"] == 300 + 200 + 90 + 390
    assert s["span_ns"]["al_iter"] == 280 + 180


def test_al_metrics_read_the_round():
    ctx = {spans.KEY: spans.summarize(_recording(), 2, 1e-6)}
    assert _reader("al.iters_per_step").read(ctx) == pytest.approx(6 / 2)
    assert _reader("al.span_ms_per_step").read(ctx) == pytest.approx(460 / 1e6 / 2)
    assert _reader("al.completed_share").read(ctx) == pytest.approx(50.0)


def test_al_metrics_read_nothing_without_the_program_s_al():
    """A program without the AL counters and the `al_iter` span (the
    parent of these metrics) or a round without an episode reads None."""
    rec = _recording(al_iter="search_dir")
    rec["counters"] = {"newton.iters": 9}
    ctx = {spans.KEY: spans.summarize(rec, 2, 1e-6)}
    for name in AL_METRICS:
        assert _reader(name).read(ctx) is None, name
        assert _reader(name).read({spans.KEY: None}) is None, name


def _press():
    """The port's two-cube press: the upper cube scripted 2 m/s down onto
    the lower one, on the ground, float64 on the CPU."""
    from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
    from ipc_tpu_torch.contact.pipeline import SelfContact
    from ipc_tpu_torch.mesh import build_mesh, merge_meshes
    from ipc_tpu_torch.models.primitives import cube
    from ipc_tpu_torch.scripting import DBCGroup, Script
    from ipc_tpu_torch.timestepper import IPCStepper, SimParams

    V1, T1 = cube(1)
    V2, T2 = cube(1)
    V, T, comp, ranges = merge_meshes([(V1 + np.array([0.0, 0.002, 0.0]), T1),
                                       (V2 + np.array([0.0, 1.006, 0.0]), T2)])
    script = Script(n_verts=len(V), dbc_groups=[
        DBCGroup(np.arange(len(V1), len(V)), np.array([0.0, -2.0, 0.0]))])
    mesh, meta = build_mesh(V, T, vert_comp=comp, comp_ranges=ranges,
                            dbc_mask=script.dbc_mask(), dtype=torch.float64, device="cpu")
    return IPCStepper(mesh, meta, SimParams(), halfspaces=[HalfSpace(HalfSpaceParams())],
                      self_contact=SelfContact(mesh, meta, friction=0.0), script=script)


@pytest.fixture(scope="module")
def press_steps():
    """Two press steps from rest with tracing on, then the same two with
    tracing off: ([(state, stats, recording)], [(state, stats)], what
    collect() gave after the steps with tracing off)."""
    from ipc_tpu_torch.jit_step import initial_device_aux, make_step

    st = _press()
    step = make_step(st)
    s0 = replace(st.initial_state(), aux=initial_device_aux(st))
    obs.collect()
    obs.set_tracing(True)
    try:
        s, on = s0, []
        for _ in range(2):
            s, stats = step(s)
            on.append((s, stats, obs.collect()))
    finally:
        obs.set_tracing(False)
    obs.collect()
    s, off = s0, []
    for _ in range(2):
        s, stats = step(s)
        off.append((s, stats))
    return on, off, obs.collect()


def test_al_iter_spans_in_a_blocked_press(press_steps):
    for i, (_, stats, rec) in enumerate(press_steps[0]):
        assert stats.script_scale < 1.0 - 1e-3 and stats.al_iters > 0, i
        kids = {}
        for sp in rec["spans"]:
            kids.setdefault(sp.parent, []).append(sp)
        newtons = [sp for sp in rec["spans"] if sp.name == "newton"]
        al = [sp for sp in rec["spans"] if sp.name == "al_iter"]
        assert len(al) == stats.al_iters, i
        for sp in al:
            parent = next(n for n in newtons if n.id == sp.parent)
            assert [c.name for c in kids[parent.id]][:2] == ["host_read", "al_iter"], i
            assert sp.end_ns <= parent.end_ns
            assert {c.name for c in kids[sp.id]} >= {"search_dir", "line_search", "al_update"}
        c = rec["counters"]
        assert (c["al.episodes"], c["al.iters"], c["al.completed"]) == (1, stats.al_iters, 1)
        assert c.get("al.stalled", 0) == c.get("al.capped", 0) == 0


def test_al_iter_span_costs_nothing_with_tracing_off(press_steps):
    on, off, rec = press_steps
    assert rec is None
    for (s_on, st_on, _), (s_off, st_off) in zip(on, off):
        assert torch.equal(s_on.x, s_off.x)
        assert (st_on.newton_iters, st_on.al_iters) == (st_off.newton_iters, st_off.al_iters)


def test_entries_name_the_al_cell():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in AL_METRICS:
        m = per_layer[name]
        assert m["workloads"] == ["twist225.al"] and m["moves"] == "step_s"
        assert m["layer"] == "moving-DBC augmented Lagrangian (jit_step)"
        assert m["source"] == ("program_span" if "span" in name else "program_counter")


def test_al_cell_reads_the_twist_layers_through_twins():
    """Each metric that lists `twist100.turn` alone has a twin `<metric>.al`
    in `twist225.al`, which reads what the metric reads, in the same layer."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    twist_only = [n for n, m in per_layer.items() if m.get("workloads") == ["twist100.turn"]]
    assert len(twist_only) == 15
    cell = harness.load_cell("twist225.al", root=ROOT)
    for name in twist_only:
        twin = per_layer[name + ".al"]
        assert twin["workloads"] == ["twist225.al"] and twin["moves"] == "step_s"
        assert {k: twin[k] for k in ("unit", "better", "source", "layer")} == {
            k: per_layer[name][k] for k in ("unit", "better", "source", "layer")}
        (kind, got), (want_kind, want) = (cell.metrics[name + ".al"],
                                          harness._metric_spec(name, harness.BENCH))
        assert kind == want_kind, name
        assert (got.__file__ == want.__file__) if kind == "py" else got == want, name
        assert name not in cell.metrics
