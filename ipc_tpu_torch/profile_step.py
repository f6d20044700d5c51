"""Per-layer wall times of a time step on one GPU, from the program's spans.

    python -m ipc_tpu_torch.profile_step [--scene boxes|twist] [--n-cells 20]
        [--dtype float32] [--settle 8] [--steps 3] [--no-contact]
        [--stepper device|host]

Builds the two-box scene (`scenes.build_scene` at n_cells, with
self-contact unless --no-contact) or the mat-twist scene
(`scenes.build_twist_scene` at n = n_cells) and steps it with the device
step (`jit_step.make_step`, the default) or the host path
(`IPCStepper.step`), takes `settle` steps, then runs the next `steps`
steps three times from the same state (both steppers are deterministic,
so each run does the same work):

  1. plain: wall seconds per step, Newton/PCG iterations (the host path's
     Newton iterations: its search directions), host syncs;
  2. layers: the same steps with the program's tracing on
     (utils/observability.py, which adds no sync): per span name its
     calls and inclusive seconds (a span nested in one of the same name
     counted once; the host's time in that layer, the device work it
     queued paid at the next host read), the `host_read` waits by site,
     the counters, the share of each step its top-level and Newton spans
     cover, and the wall against the plain pass's (tracing's cost);
  3. trace: `torch.profiler` over the last of those steps alone, tracing
     on: CUDA kernel time (the spans' annotation ranges left out) against
     that step's plain wall time (the device's busy share), kernel count,
     the kernels that take the most time, the device's idle time by the
     innermost span the host was in, and the share of it inside
     `host_read` spans (small when the spans and the kernels share one
     clock: the host waits while the device works).

Needs a CUDA device.
"""

import argparse
import bisect
import time
from collections import defaultdict

import torch

from ipc_tpu_torch.utils import observability as obs

__all__ = ["main"]


def _run(step, counts, state, n, host):
    """n steps from state: rows of (wall s, Newton iterations, PCG
    iterations, host syncs, largest active-pair count, the device step's
    convergence fields as text)."""
    rows = []
    for _ in range(n):
        syncs = counts.host_syncs
        t0 = time.perf_counter()
        state, s = step(state)
        torch.cuda.synchronize()
        if host:
            k, it, act = len(s.pcg_iters), sum(s.pcg_iters), max(s.n_constraints, default=0)
            extra = ""
        else:
            k, it, act = s.newton_iters, s.pcg_iters_total, s.active_pt_max + s.active_ee_max
            extra = (f" dist_to_opt={s.dist_to_opt:.4e} last_alpha={s.last_alpha:.4g} "
                     f"kappa_doublings={s.kappa_doublings} script_scale={s.script_scale:.4g}")
        rows.append((time.perf_counter() - t0, k, it, counts.host_syncs - syncs, act, extra))
    return state, rows


def _kernels(prof, skip):
    """(name, start ns, end ns) of the CUDA events of a finished profiler
    run, read from its raw kineto results, leaving out the annotation
    ranges named in `skip` (record_function ranges show on the device
    too)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and e.name() not in skip and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _idle_by_span(kernels, spans, t0, t1):
    """The device's idle gaps in [t0, t1] (outside the union of the kernel
    intervals): ({innermost span covering a gap's midpoint: seconds},
    idle seconds, idle seconds inside `host_read` spans)."""
    busy = []
    for _, s, e in sorted(kernels, key=lambda k: k[1]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps, prev = [], t0
    for s, e in busy + [[t1, t1]]:
        if min(s, t1) > prev:
            gaps.append((prev, min(s, t1)))
        prev = max(prev, e)
    # the host's spans nest: sweep the gaps' midpoints through their
    # boundaries with a stack of the open spans
    bounds = sorted([(sp.start_ns, 1, sp.id) for sp in spans]
                    + [(sp.end_ns, 0, sp.id) for sp in spans])
    names = {sp.id: sp.name for sp in spans}
    reads = sorted((sp.start_ns, sp.end_ns) for sp in spans if sp.name == "host_read")
    starts = [r[0] for r in reads]
    idle, in_reads, stack, i = defaultdict(float), 0.0, [], 0
    for a, b in gaps:
        mid = 0.5 * (a + b)
        while i < len(bounds) and bounds[i][0] <= mid:
            _, opens, sid = bounds[i]
            if opens:
                stack.append(sid)
            elif sid in stack:
                stack.remove(sid)
            i += 1
        idle[names[stack[-1]] if stack else "(no span)"] += (b - a) / 1e9
        j = bisect.bisect_right(starts, b) - 1
        while j >= 0 and reads[j][1] > a:
            lo, hi = max(a, reads[j][0]), min(b, reads[j][1])
            in_reads += max(0, hi - lo) / 1e9
            j -= 1
    return dict(idle), sum(b - a for a, b in gaps) / 1e9, in_reads


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("boxes", "twist"), default="boxes")
    ap.add_argument("--n-cells", type=int, default=20)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--settle", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--no-contact", action="store_true")
    ap.add_argument("--stepper", choices=("device", "host"), default="device")
    args = ap.parse_args(argv)

    from ipc_tpu_torch import jit_step as JS
    from ipc_tpu_torch.device import require_cuda
    from ipc_tpu_torch.scenes import build_scene, build_twist_scene

    device = require_cuda()
    print(f"[profile] {torch.cuda.get_device_name(0)}; scene={args.scene} "
          f"n_cells={args.n_cells} {args.dtype} contact={not args.no_contact} "
          f"stepper={args.stepper} settle={args.settle} steps={args.steps}")
    if args.scene == "twist":
        st = build_twist_scene(args.n_cells, args.dtype, device)
    else:
        st = build_scene(args.n_cells, args.dtype, device, with_contact=not args.no_contact)
    host = args.stepper == "host"
    step = st.step if host else JS.make_step(st)
    counts = st if host else step
    start, _ = _run(step, counts, st.initial_state(), args.settle, host)

    _, plain = _run(step, counts, start, args.steps, host)
    for i, (w, k, it, sy, act, extra) in enumerate(plain):
        print(f"[profile] plain step {args.settle + i}: wall_s={w:.4f} newton_iters={k} "
              f"pcg_iters={it} host_syncs={sy} active_pairs_max={act}{extra}")
    wall = sum(r[0] for r in plain)
    newton = sum(r[1] for r in plain)
    print(f"[profile] plain: {wall:.4f} s for {args.steps} steps, {newton} Newton "
          f"iterations, {wall / max(newton, 1):.4f} s per iteration")

    obs.set_tracing(True)
    _, traced = _run(step, counts, start, args.steps, host)
    obs.set_tracing(False)
    rec = obs.collect()
    total = sum(r[0] for r in traced)
    print(f"[profile] spans over the same {args.steps} steps: {total:.4f} s with tracing on "
          f"({100.0 * (total / wall - 1.0):+.2f}% against plain); counters {rec['counters']}; "
          f"step coverage {[round(c, 4) for c in obs.step_coverage(rec['spans'])]}")
    for name, (calls, ns) in sorted(obs.span_totals(rec["spans"]).items(),
                                    key=lambda kv: -kv[1][1]):
        print(f"[profile] span | {name} | calls={calls} | s={ns / 1e9:.4f} | "
              f"share={100.0 * ns / 1e9 / total:.1f}%")

    last, _ = _run(step, counts, start, args.steps - 1, host)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    obs.set_tracing(True)
    with torch.profiler.profile(activities=acts) as prof:
        step(last)
        torch.cuda.synchronize()
    obs.set_tracing(False)
    spans = obs.collect()["spans"]
    kernels = _kernels(prof, {sp.name for sp in spans})
    sums = defaultdict(lambda: [0, 0.0])
    for name, s0, s1 in kernels:
        sums[name][0] += 1
        sums[name][1] += (s1 - s0) / 1e9
    t0 = min(sp.start_ns for sp in spans)
    t1 = max(sp.end_ns for sp in spans)
    idle, idle_s, in_reads = _idle_by_span(kernels, spans, t0, t1)
    busy = (t1 - t0) / 1e9 - idle_s
    w_last = plain[-1][0]
    print(f"[profile] trace of step {args.settle + args.steps - 1}: kernel union {busy:.4f} s "
          f"over {len(kernels)} kernels; plain wall {w_last:.4f} s: busy "
          f"{100.0 * busy / w_last:.1f}%; idle under the profiler {idle_s:.4f} s, "
          f"{100.0 * in_reads / max(idle_s, 1e-12):.2f}% of it inside host_read spans")
    for name, sec in sorted(idle.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[profile] idle | {name} | s={sec:.4f}")
    for name, (n, sec) in sorted(sums.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"[profile] kernel | {name[:90]} | count={n} | s={sec:.4f}")


if __name__ == "__main__":
    main()
