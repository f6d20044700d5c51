"""Layer timers and the profiler's reduction, from outside the program.

`Layers` wraps the program functions that the cell's per-layer metric
files name (their "wrap" lists: "sc.<method>" on the stepper's
self-contact handler, "stepper.<method>" on the stepper, or
"<module>:<function>"). While `timing` is on, each call of a metric's
functions is timed by the host clock between two `torch.cuda.synchronize()`
calls (nested calls of one metric count once); the syncs inflate what they
time, so only the traced run turns them on. While `labels` is on, each
call is a `torch.profiler.record_function` range named by its metric, which
names the host's layer during the device's idle gaps.

`reduce_trace` turns a profiler run into device busy time (the union of
kernel intervals), kernel sums by name and idle time by host layer.
"""

import bisect
import importlib
import time
from collections import defaultdict

import torch

__all__ = ["Layers", "reduce_trace", "trace_events"]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Layers:
    """Timers and profiler labels around the program functions of the
    metrics `specs` ({metric name: [target, ...]})."""

    def __init__(self, specs, device):
        self.specs = specs
        self.device = device
        self.timing = False
        self.labels = False
        self.seconds = defaultdict(float)
        self.calls = defaultdict(int)
        self._depth = defaultdict(int)

    def _wrap(self, metric, fn):
        def layer(*args, **kwargs):
            if self._depth[metric]:
                return fn(*args, **kwargs)
            self._depth[metric] += 1
            try:
                if self.labels:
                    with torch.profiler.record_function(metric):
                        return fn(*args, **kwargs)
                if not self.timing:
                    return fn(*args, **kwargs)
                _sync(self.device)
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                _sync(self.device)
                self.seconds[metric] += time.perf_counter() - t0
                self.calls[metric] += 1
                return out
            finally:
                self._depth[metric] -= 1

        return layer

    def install(self, stepper):
        """Wrap every target; a target the scene lacks (no self-contact)
        is skipped and its metric reads nothing."""
        for metric, targets in self.specs.items():
            for target in targets:
                if ":" in target:
                    owner, attr = target.split(":")
                    owner = importlib.import_module(owner)
                else:
                    head, attr = target.split(".")
                    owner = {"sc": stepper.sc, "stepper": stepper}[head]
                if owner is None:
                    continue
                setattr(owner, attr, self._wrap(metric, getattr(owner, attr)))


def _union(intervals):
    """Merged [start, end) intervals of a list, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def trace_events(prof):
    """(on_device, name, start_us, end_us) of every event of a finished
    torch.profiler run, read from its raw kineto results (building the
    FunctionEvent tree of an eager step's million events takes minutes)."""
    cuda = torch.autograd.DeviceType.CUDA
    kr = getattr(prof.profiler, "kineto_results", None)
    if kr is None:
        return [(e.device_type == cuda, e.name, e.time_range.start, e.time_range.end)
                for e in prof.events()]
    out = []
    for e in kr.events():
        t0 = e.start_ns()
        out.append((e.device_type() == cuda, e.name(), t0 / 1e3, (t0 + e.duration_ns()) / 1e3))
    return out


def reduce_trace(events, t_start_us, t_end_us, names, skip=(),
                 idle_label="step control (jit_step)"):
    """From trace_events' tuples over one traced window [t_start_us,
    t_end_us] (microseconds), with the layer labels `names` and further
    annotation names `skip` (neither counts as a kernel where it shows on
    the device): dict(busy_s, kernels {name: seconds}, idle {host label:
    seconds})."""
    kernels = defaultdict(float)
    spans, labels = [], []
    for on_device, name, start, end in events:
        if on_device:
            if end > start and name not in names and name not in skip:
                spans.append((start, end))
                kernels[name] += (end - start) / 1e6
        elif name in names:
            labels.append((start, end, name))
    busy = _union(spans)
    busy_s = sum(e - s for s, e in busy) / 1e6
    # idle gaps inside the window, each named by the latest-starting layer
    # range that covers its midpoint (the host's work while the device
    # waited)
    labels.sort()
    starts = [r[0] for r in labels]
    idle = defaultdict(float)
    prev = t_start_us
    for s, e in busy + [[t_end_us, t_end_us]]:
        if s > prev:
            mid = 0.5 * (s + prev)
            name = idle_label
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 8, -1), -1):
                if labels[j][1] >= mid:
                    name = labels[j][2]
                    break
            idle[name] += (s - prev) / 1e6
        prev = max(prev, e)
    return dict(busy_s=busy_s, kernels=dict(kernels), idle=dict(idle))
