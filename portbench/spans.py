"""The program's own spans and counters, read in a traced run.

The metric files metrics/<metric>.py that read the program's spans and
counters call `span_ms_per_step(ctx, span)` or `counter_ratio(ctx, num,
den, scale)`. Both read one span round, made at the first such reading of
a `--trace 1` run (after the window and the profiled step): every start
variant's episode once from its S0, in the run's order, with the
program's tracing on (`ipc_tpu_torch.utils.observability.set_tracing`)
and the layer timers off, then the program's `collect()`. A `--trace 0`
run reads none of these metrics, so it never turns tracing on. A program
without the recorder (a checkout before it) gives no round, and the
metrics read None.

`read(ctx)` is handed no step and no start state: the round takes the
harness's own `episode` closure, `starts` and `order` from the frame of
`harness.run` that reads the metric.

Readings:
  span_ms_per_step   the inclusive wall ms of a span name per step of the
                     round, a span nested in one of the same name counted
                     once: the host's time in that layer (the spans add no
                     sync; device work queued there is paid at the next
                     host read, inside a `host_read` span);
  counter_ratio      counters[num] / counters[den] * scale over the round.
"""

import sys
import time
from collections import defaultdict

import torch

__all__ = ["span_round", "span_ms_per_step", "counter_ratio", "summarize"]

KEY = "program_spans"


def _log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _harness_run():
    """The locals of the `harness.run` frame below this call, or None."""
    f = sys._getframe(1)
    while f is not None:
        loc = f.f_locals
        if f.f_code.co_name == "run" and all(k in loc for k in ("episode", "starts", "order")):
            return loc
        f = f.f_back
    return None


def summarize(rec, steps, wall_s):
    """The round's readings from a `collect()` recording: dict(steps,
    wall_s, span_ns {name: inclusive ns}, n_spans, counters, reads {site:
    (n, ns)}, step_ns [per step span], coverage [per step])."""
    spans = rec["spans"]
    by_id = {sp.id: sp for sp in spans}
    kids = defaultdict(list)
    for sp in spans:
        kids[sp.parent].append(sp)

    def dur(sp):
        return sp.end_ns - sp.start_ns

    def nested(sp):
        p = by_id.get(sp.parent)
        while p is not None:
            if p.name == sp.name:
                return True
            p = by_id.get(p.parent)
        return False

    span_ns = defaultdict(int)
    reads = defaultdict(lambda: [0, 0])
    for sp in spans:
        if not nested(sp):
            span_ns[sp.name] += dur(sp)
        if sp.name == "host_read":
            r = reads[sp.attrs.get("site", "?")]
            r[0] += 1
            r[1] += dur(sp)
    step_spans = [sp for sp in spans if sp.name == "step"]
    coverage = [sum(dur(c) if c.name != "newton" else sum(dur(g) for g in kids[c.id])
                    for c in kids[st.id]) / max(dur(st), 1) for st in step_spans]
    return dict(steps=steps, wall_s=wall_s, span_ns=dict(span_ns), n_spans=len(spans),
                counters=dict(rec["counters"]), reads={k: tuple(v) for k, v in reads.items()},
                step_ns=[dur(st) for st in step_spans], coverage=coverage)


def span_round(ctx):
    """The round's summary (cached in ctx), or None without a recorder or
    outside `harness.run`."""
    if KEY in ctx:
        return ctx[KEY]
    ctx[KEY] = None
    try:
        from ipc_tpu_torch.utils import observability as obs
    except ImportError:
        return None
    if not all(hasattr(obs, f) for f in ("set_tracing", "collect")):
        _log("span round: the program has no recorder; its span metrics read nothing")
        return None
    run = _harness_run()
    if run is None:
        return None
    episode, starts, order = run["episode"], run["starts"], run["order"]
    cuda = torch.cuda.is_available()
    obs.collect()  # drop anything recorded before the round
    obs.set_tracing(True)
    try:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        for i in order:
            outs, _ = episode(starts[i][4])
            steps += len(outs)
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    finally:
        obs.set_tracing(False)
    out = summarize(obs.collect(), steps, wall_s)
    ctx[KEY] = out
    step_ms = [ns / 1e6 for ns in out["step_ns"]]
    _log(f"span round: {steps} steps in {wall_s:.4f} s ({wall_s / max(steps, 1):.4f} s/step "
         f"with tracing on, {out['n_spans'] / max(steps, 1):.1f} spans a step); step spans "
         f"(ms) {[round(v, 3) for v in step_ms]}; coverage "
         f"{[round(c, 4) for c in out['coverage']]}; counters {out['counters']}")
    _log("span round: inclusive ms per step " + ", ".join(
        f"{k}={v / 1e6 / max(steps, 1):.3f}" for k, v in
        sorted(out["span_ns"].items(), key=lambda kv: -kv[1])))
    _log("span round: host reads per step (count, wait ms) " + ", ".join(
        f"{k}=({n / max(steps, 1):.2f}, {ns / 1e6 / max(steps, 1):.3f})" for k, (n, ns) in
        sorted(out["reads"].items(), key=lambda kv: -kv[1][1])))
    return out


def span_ms_per_step(ctx, name):
    """Inclusive ms of the spans `name` per step of the round, or None."""
    r = span_round(ctx)
    if r is None or not r["steps"] or name not in r["span_ns"]:
        return None
    return r["span_ns"][name] / 1e6 / r["steps"]


def counter_ratio(ctx, num, den, scale=1.0):
    """counters[num] / counters[den] * scale over the round, or None."""
    r = span_round(ctx)
    if r is None:
        return None
    c = r["counters"]
    if num not in c or not c.get(den):
        return None
    return scale * c[num] / c[den]
