"""The in-program recorder (ipc_tpu_torch/utils/observability.py) on the CPU.

* Tracing changes no result: the device step's trajectories and StepStats
  are bit-identical with tracing on and off, on a small two-box scene with
  self-contact (the upper box 0.005 above the lower one, falling) and on
  the twist at mat(12) (the grid broad phase, the scripted prologue).
* `step.host_syncs` is the same on and off, is the sum of the per-site
  counts, and is the count the step kept before the reads went through
  `host_read` (pinned: the hand-kept arithmetic gave the same numbers on
  these scenes).
* The span tree: one `newton` span per iteration entered, one `trial` per
  `linesearch.trials`, each span inside its parent, and the step tiled by
  its top-level and Newton spans.
* ACCD's live counters are exact on pairs that finish at known passes.
* Under a CPU-only torch.profiler session each span starts within 1 ms of
  its record_function range.
* With tracing off, `span()` records nothing and returns one shared no-op.
* A `Capture` scope keeps the counts made in it out of the totals (and of
  the recording) until each `replay()` adds them, into an enclosing scope's
  record when one is open.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ipc_tpu_torch.contact.ccd import accd_pt
from ipc_tpu_torch.jit_step import initial_device_aux, make_step
from ipc_tpu_torch.scenes import build_scene, build_twist_scene
from ipc_tpu_torch.utils import observability as obs

STEPS = 2
# step.host_syncs per step, as the step counted them before host_read
PINNED = {"boxes": [127, 103], "twist": [66, 71]}


@pytest.fixture(autouse=True)
def _tracing_off():
    obs.set_tracing(False)
    obs.collect()
    yield
    obs.set_tracing(False)
    obs.collect()


def _boxes():
    st = build_scene(2, "float64", "cpu", with_contact=True)
    x = st.mesh.x_rest.numpy().copy()
    upper = st.mesh.vert_comp.numpy() == 1
    x[upper, 1] -= 0.185  # 0.005 above the lower box
    v = np.zeros_like(x)
    v[upper, 1] = -0.3
    return st, st.initial_state(x, v)


def _twist():
    st = build_twist_scene(12, "float64", "cpu")
    return st, dataclasses.replace(st.initial_state(), aux=initial_device_aux(st))


SCENES = {"boxes": _boxes, "twist": _twist}


def _run(name, trace):
    st, s = SCENES[name]()
    step = make_step(st)
    reads0 = obs.host_reads_by_site()
    obs.set_tracing(trace)
    rows = []
    for _ in range(STEPS):
        h0 = step.host_syncs
        s, stats = step(s)
        rows.append((stats, step.host_syncs - h0, s.x.clone(), s.v.clone()))
    obs.set_tracing(False)
    rec = obs.collect() if trace else None
    sites = {k: v - reads0.get(k, 0) for k, v in obs.host_reads_by_site().items()
             if v != reads0.get(k, 0)}
    return rows, rec, sites


@pytest.fixture(scope="module", params=list(SCENES))
def runs(request):
    name = request.param
    return name, _run(name, False), _run(name, True)


def test_tracing_changes_no_result(runs):
    name, (off, _, _), (on, _, _) = runs
    for (s0, _, x0, v0), (s1, _, x1, v1) in zip(off, on):
        assert s0 == s1
        assert torch.equal(x0, x1) and torch.equal(v0, v1)


def test_host_syncs_counted_by_host_read(runs):
    name, (off, _, sites_off), (on, rec, sites_on) = runs
    counts_off = [r[1] for r in off]
    assert counts_off == [r[1] for r in on] == PINNED[name]
    assert sum(sites_off.values()) == sum(counts_off) == sum(sites_on.values())
    assert rec["reads"] == sites_on
    # every read of the traced steps is a host_read span with its site
    spans = rec["spans"]
    assert sum(sp.name == "host_read" for sp in spans) == sum(counts_off)
    by_site = {}
    for sp in spans:
        if sp.name == "host_read":
            by_site[sp.attrs["site"]] = by_site.get(sp.attrs["site"], 0) + 1
    assert by_site == sites_on


def test_span_tree(runs):
    name, (off, _, _), (on, rec, _) = runs
    spans = rec["spans"]
    by_id = {sp.id: sp for sp in spans}
    for sp in spans:
        assert sp.start_ns <= sp.end_ns
        if sp.parent:
            par = by_id[sp.parent]
            assert par.start_ns <= sp.start_ns and sp.end_ns <= par.end_ns, (sp, par)
    steps = [sp for sp in spans if sp.name == "step"]
    assert len(steps) == STEPS and all(sp.parent == 0 for sp in steps)
    kids = {}
    for sp in spans:
        kids.setdefault(sp.parent, []).append(sp)
    newton_iters = 0
    for st_span, (stats, *_) in zip(steps, on):
        newtons = [c for c in kids[st_span.id] if c.name == "newton"]
        assert [c.attrs["k"] for c in newtons] == list(range(len(newtons)))
        stepped = [c for c in newtons if any(g.name == "line_search" for g in kids.get(c.id, []))]
        # every iteration entered is a span; the converged one takes no step
        assert len(stepped) == stats.newton_iters
        assert len(newtons) in (stats.newton_iters, stats.newton_iters + 1)
        assert newtons[:len(stepped)] == stepped
        newton_iters += stats.newton_iters
    assert rec["counters"]["newton.iters"] == newton_iters
    trials = [sp for sp in spans if sp.name == "trial"]
    assert len(trials) == rec["counters"]["linesearch.trials"] > 0
    for sp in trials:
        assert by_id[sp.parent].name == "line_search"
    top = {c.name for c in kids[steps[0].id]}
    assert {"warm_start", "kappa_init", "friction_capture", "newton", "epilogue"} <= top
    assert ("script" in top) == (name == "twist")
    assert {"broadphase", "ccd", "search_dir", "pcg", "host_read"} <= {sp.name for sp in spans}
    assert all(c > 0.95 for c in obs.step_coverage(spans))
    totals = obs.span_totals(spans)
    assert totals["step"][1] == sum(sp.end_ns - sp.start_ns for sp in steps)
    assert totals["ccd"][0] == sum(sp.name == "ccd" for sp in spans)
    assert rec["counters"]["ccd.passes"] == 64 * (totals["accd_pt"][0] + totals["accd_ee"][0])


def _stencils():
    """Five point-triangle stencils: a point 1 above a triangle, at rest or
    falling onto it at speeds whose ACCD steps shrink tenfold per pass; the
    falling ones stop (step <= 1e-6 d0) after 1, 2, 4 and 6 passes."""
    tri = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                       dtype=torch.float64)
    pt = torch.tensor([[0.25, 1.0, 0.25]], dtype=torch.float64)
    x4 = torch.cat([pt, tri])[None].repeat(5, 1, 1)
    p4 = torch.zeros_like(x4)
    for i, v in enumerate([0.0, 1e7, 1e5, 1e3, 10.0]):
        p4[i, 0, 1] = -v
    return x4, p4


def test_accd_live_counters_exact():
    x4, p4 = _stencils()
    t_off = accd_pt(x4, p4, 0.2, 64)
    assert obs.collect() is None
    obs.set_tracing(True)
    t_on = accd_pt(x4, p4, 0.2, 64)
    obs.set_tracing(False)
    assert torch.equal(t_on, t_off)
    c = obs.collect()["counters"]
    assert c == {"ccd.calls": 1, "ccd.passes": 64, "ccd.pair_passes": 5 * 64,
                 "ccd.live_pair_passes": 0 + 1 + 2 + 4 + 6, "ccd.live_passes": 6}


def test_spans_on_the_profiler_clock():
    st, s = _twist()
    step = make_step(st)
    s, _ = step(s)
    obs.set_tracing(True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # the session's lazy set-up
            pass
        step(s)
    obs.set_tracing(False)
    spans = obs.collect()["spans"]
    names = {sp.name for sp in spans}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(e.start_ns())
    assert len(spans) > 50
    for name in names:
        mine = sorted(sp.start_ns for sp in spans if sp.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000, name


def test_span_off_is_one_shared_noop():
    a, b = obs.span("step"), obs.span("newton", k=3)
    assert a is b
    with a:
        with b:
            pass
    obs.count_device("ccd.live_passes", torch.tensor(3))
    assert obs.collect() is None
    obs.set_tracing(True)
    with obs.span("step"):
        obs.count_device("ccd.live_passes", torch.tensor(3))
    obs.set_tracing(False)
    rec = obs.collect()
    assert [sp.name for sp in rec["spans"]] == ["step"]
    assert rec["counters"] == {"ccd.live_passes": 3} and rec["reads"] == {}


def test_host_read_values_and_counts():
    n0, sites0 = obs.host_reads(), obs.host_reads_by_site()
    assert obs.host_read("t.one", torch.tensor(True)) is True
    assert obs.host_read("t.two", torch.tensor(1.5), torch.tensor(2.0)) == [1.5, 2.0]
    assert obs.host_read("t.two", torch.tensor([3, 4])) == [3, 4]
    with obs.reading("t.copy"):
        torch.zeros(3).numpy()
    sites = obs.host_reads_by_site()
    assert obs.host_reads() - n0 == 4
    assert {k: sites[k] - sites0.get(k, 0) for k in ("t.one", "t.two", "t.copy")} == {
        "t.one": 1, "t.two": 2, "t.copy": 1}


def test_capture_scope_holds_counts_until_replayed():
    n0 = obs.counter("t.captured")
    obs.set_tracing(True)
    with obs.Capture() as cap:
        obs.count("t.captured", 3)
        obs.count("t.captured")
    assert obs.counter("t.captured") == n0 and cap.counts == {"t.captured": 4}
    obs.count("t.captured")  # the scope is closed: into the totals
    cap.replay()
    cap.replay()
    assert obs.counter("t.captured") == n0 + 9
    with obs.Capture() as outer:  # a replay inside a scope adds to its record
        cap.replay()
    obs.set_tracing(False)
    assert obs.counter("t.captured") == n0 + 9 and outer.counts == {"t.captured": 4}
    assert obs.collect()["counters"] == {"t.captured": 9}


def test_timers_section_is_a_span():
    timers = obs.Timers()
    obs.set_tracing(True)
    with timers.section("io"):
        pass
    obs.set_tracing(False)
    with timers.section("io"):
        pass
    assert [sp.name for sp in obs.collect()["spans"]] == ["io"]
    assert list(timers.report()) == ["io"] and timers.report()["io"] >= 0.0
