"""The benchmark's readers of the program's spans and counters
(portbench/spans.py and its metric files), on the CPU from stub contexts:
each metric reads its span or counter ratio from a span round's summary,
the summary counts a span nested in one of the same name once, the round
runs the harness's own episodes with the program's tracing on, and a
program without the recorder gives no reading and no error.
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ipc_tpu_torch.utils import observability as obs  # noqa: E402
from ipc_tpu_torch.utils.observability import Span  # noqa: E402
from portbench import harness, spans  # noqa: E402

SPAN_METRICS = {
    "broadphase.span_ms_per_step": "broadphase",
    "ccd.span_ms_per_step": "ccd",
    "pairs.span_ms_per_step": "pairs",
    "elasticity.span_ms_per_step": "elasticity",
    "pcg.span_ms_per_step": "pcg",
    "linesearch.span_ms_per_step": "line_search",
    "host.sync_wait_ms_per_step": "host_read",
    "script.span_ms_per_step": "script",
}
RATIO_METRICS = {
    "linesearch.trials_per_newton": ("linesearch.trials", "newton.iters", 1.0),
    "ccd.live_pass_share": ("ccd.live_passes", "ccd.passes", 100.0),
    "ccd.live_pair_share": ("ccd.live_pair_passes", "ccd.pair_passes", 100.0),
}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _reader(name):
    kind, mod = harness._metric_spec(name, harness.BENCH)
    assert kind == "py"
    return mod


def _stub(**over):
    summary = dict(steps=4, wall_s=1.0, span_ns={n: 1_000_000 * (i + 1) for i, n in
                                                 enumerate(SPAN_METRICS.values())},
                   counters={"linesearch.trials": 9, "newton.iters": 6, "ccd.live_passes": 16,
                             "ccd.passes": 256, "ccd.live_pair_passes": 30,
                             "ccd.pair_passes": 1200},
                   reads={}, step_ns=[], coverage=[])
    summary.update(over)
    return {spans.KEY: summary}


@pytest.mark.parametrize("name", list(SPAN_METRICS) + list(RATIO_METRICS))
def test_metric_reads_the_round(name):
    ctx = _stub()
    value = _reader(name).read(ctx)
    if name in SPAN_METRICS:
        i = list(SPAN_METRICS).index(name)
        assert value == pytest.approx((i + 1) / 4)
    else:
        num, den, scale = RATIO_METRICS[name]
        c = ctx[spans.KEY]["counters"]
        assert value == pytest.approx(scale * c[num] / c[den])
    # the landing's twin reads the same number
    if name != "script.span_ms_per_step":
        assert _reader(name + ".impact").read(ctx) == value


def test_missing_span_or_counter_reads_none():
    ctx = _stub(span_ns={"step": 5}, counters={"ccd.passes": 64})
    assert _reader("script.span_ms_per_step").read(ctx) is None
    assert _reader("ccd.live_pass_share").read(ctx) is None
    assert _reader("linesearch.trials_per_newton").read(ctx) is None
    assert _reader("ccd.span_ms_per_step").read({spans.KEY: None}) is None


def test_new_entries_have_readers():
    b = _bench()
    names = {m["name"] for m in b["per_layer"]}
    for name in list(SPAN_METRICS) + list(RATIO_METRICS):
        assert name in names
        assert (name + ".impact" in names) == (name != "script.span_ms_per_step")
    for m in b["per_layer"]:
        if m["name"].split(".impact")[0] in SPAN_METRICS:
            assert m["source"] == "program_span"
        if m["name"].split(".impact")[0] in RATIO_METRICS:
            assert m["source"] == "program_counter"


def test_summary_counts_nested_spans_once():
    rec = dict(spans=[
        Span(1, 0, "step", 0, 100, {}),
        Span(2, 1, "newton", 5, 60, {"k": 0}),
        Span(3, 2, "ccd", 10, 40, {}),
        Span(4, 3, "ccd", 12, 30, {}),  # nested in a ccd: counted once
        Span(5, 2, "host_read", 41, 59, {"site": "newton.converged"}),
        Span(6, 1, "epilogue", 60, 97, {}),
        Span(7, 6, "host_read", 90, 96, {"site": "epilogue"}),
    ], counters={"newton.iters": 1}, reads={})
    s = spans.summarize(rec, 1, 1e-7)
    assert s["span_ns"] == {"step": 100, "newton": 55, "ccd": 30, "host_read": 24,
                            "epilogue": 37}
    assert s["reads"] == {"newton.converged": (1, 18), "epilogue": (1, 6)}
    # newton's children (30 + 18) and the other top-level spans (37)
    assert s["coverage"] == [pytest.approx(0.85)]
    assert s["step_ns"] == [100] and s["n_spans"] == 7


def run(ctx, episode, starts, order):
    """Stands for harness.run: the round finds these locals by name."""
    return spans.span_round(ctx)


def test_round_plays_the_harness_episodes_with_tracing_on():
    played = []

    def episode(s0):
        assert obs.tracing()
        outs = []
        for k in range(2):
            with obs.span("step"):
                with obs.span("ccd"):
                    obs.count("ccd.passes", 64)
                obs.host_read("epilogue", torch.tensor(1.0))
            outs.append(s0)
        played.append(s0)
        return outs, [None, None]

    starts = [(None, None, None, [], "S0-a"), (None, None, None, [], "S0-b")]
    ctx = {}
    r = run(ctx, episode, starts, [1, 0])
    assert played == ["S0-b", "S0-a"] and not obs.tracing()
    assert r["steps"] == 4 and r["counters"] == {"ccd.passes": 256}
    assert len(r["step_ns"]) == 4 and r["reads"]["epilogue"][0] == 4
    assert _reader("ccd.span_ms_per_step").read(ctx) == pytest.approx(
        r["span_ns"]["ccd"] / 1e6 / 4)
    assert spans.span_round(ctx) is r  # one round per run


def test_program_without_recorder_reads_nothing(monkeypatch):
    monkeypatch.delattr(obs, "set_tracing")

    def episode(s0):
        raise AssertionError("no round without a recorder")

    ctx = {}
    assert run(ctx, episode, [], []) is None
    for name in list(SPAN_METRICS) + list(RATIO_METRICS):
        assert _reader(name).read(ctx) is None


def test_outside_the_harness_reads_nothing():
    assert spans.span_round({}) is None
