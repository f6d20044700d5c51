"""Run artifacts: timers, per-iteration stats, conservation logs, checkpoints,
and the in-program recorder of spans, host reads and counters.

Port of ipc_tpu/utils/observability.py (the reference's Timer registries,
iterStats, sysE/sysM/sysL conservation logs and saveStatus / restart). The
artifacts keep the JAX package's names, formats and contents, so the two
packages' run directories compare file by file:

  iterStats.txt     `step alpha #constraints grad_inf` per Newton iteration
  sysE/sysM/sysL    per component: energy, linear and angular momentum
  info.txt          timers, peak RSS, steps, Newton iterations per step
  resultsStats.txt  steps, iterations and seconds per step, total seconds
  status{k}.npz     step, t, x, v, a in float64 (+ the ACO planes' origins
                    and velocities when the scene moves them)

A checkpoint stores what the JAX package stores, ACO planes included: the
stepper's `hs_origin` and the script's `aco_vel`. The host path moves
those, so its restart resumes the planes where they were. The device step
never updates them (its planes live in SimState.aux): its restart starts
the planes, and any turning rules, from their initial state, as the JAX
driver's does (ROADMAP §3). Neither package stores SimState.dx_el (the
warm-start correction of warm_start 3-4).

The recorder (port-only; off by default, and turning it on changes no
result):

  span(name, **attrs)   a context manager around one layer of the step.
                        While tracing is off it returns one shared no-op
                        object: no allocation, no clock read, no device
                        work. While on it records (id, parent id, name,
                        start_ns, end_ns, attrs) in memory, and under an
                        active torch.profiler session it also opens a
                        `record_function` range of the same name.
  host_read(site, *ts)  every value the steps read back to the host goes
                        through it (`reading(site)` for a read that is not
                        a `.tolist()`, such as a copy to numpy or a
                        `torch.nonzero`). It always counts the read by site;
                        while tracing is on the read is also a leaf span
                        `host_read` with `site=`, whose duration is the
                        time the host waited for the device.
  count(name, n)        a host counter, always on: the one way the port
                        counts (kernel launches, operator applications,
                        collectives, the layers' counters); `counter(name)`
                        reads its running total since import.
  Capture()             a capture scope for CUDA graphs: while it is open
                        every `count` goes into its record `counts` and not
                        into the totals; each `replay()` adds the record.
                        A scope never replayed keeps its counts out of the
                        totals (calls made for a comparison or a timing).
  count_device(name, t) adds a 0-d device tensor to a device accumulator,
                        only while tracing is on (no host read).
  set_tracing(on)       the one switch; `collect()` returns the recording
                        (spans, counters, reads by site) since tracing was
                        turned on or last collected, reading the device
                        accumulators in one read that counts as no host
                        read of a step.

Span times are on the profiler's clock: durations come from
`time.perf_counter_ns()`, placed on `time.time_ns()` (CLOCK_REALTIME, the
clock Kineto stamps CPU events with) through one anchor taken when tracing
is turned on, so a clock step cannot bend a duration.
"""

import json
import os
import resource
import time
from collections import defaultdict, namedtuple

import numpy as np
import torch

__all__ = [
    "Span",
    "span",
    "host_read",
    "reading",
    "host_reads",
    "host_reads_by_site",
    "count",
    "counter",
    "Capture",
    "count_device",
    "set_tracing",
    "tracing",
    "collect",
    "span_totals",
    "step_coverage",
    "Timers",
    "RunLogger",
    "save_status",
    "load_status",
    "save_status_text",
    "load_status_text",
    "peak_rss_mb",
]


Span = namedtuple("Span", "id parent name start_ns end_ns attrs")


class _NoSpan:
    """The span of a step run without tracing: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_rec = None  # the active _Recording while tracing is on
_kept = None  # the recording of the last traced stretch, after tracing went off
_READS = defaultdict(int)  # host reads by site, since import
_reads_total = 0
_COUNTS = defaultdict(int)  # host counters, since import
_into = _COUNTS  # where `count` adds: the totals, or the open Capture's record


class _Recording:
    def __init__(self):
        self.wall0, self.perf0 = time.time_ns(), time.perf_counter_ns()
        self.reset()

    def reset(self):
        self.spans, self.stack, self.next_id = [], [], 1
        self.device = {}
        self.counts0, self.reads0 = dict(_COUNTS), dict(_READS)


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "rf")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        rec = _rec
        self.id, self.parent = rec.next_id, rec.stack[-1] if rec.stack else 0
        rec.next_id += 1
        rec.stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        rec = _rec
        if rec is not None and rec.stack and rec.stack[-1] == self.id:
            rec.stack.pop()
            off = rec.wall0 - rec.perf0
            rec.spans.append(Span(self.id, self.parent, self.name, self.t0 + off, t1 + off,
                                  self.attrs))
        return False


def span(name, **attrs):
    """A context manager spanning one layer of a step (module docstring)."""
    if _rec is None:
        return _NO_SPAN
    return _Span(name, attrs)


def reading(site):
    """Counts one host read at `site` around a read that is not a
    `.tolist()`; while tracing is on, a `host_read` span."""
    global _reads_total
    _reads_total += 1
    _READS[site] += 1
    if _rec is None:
        return _NO_SPAN
    return _Span("host_read", {"site": site})


def host_read(site, *tensors):
    """Python values of tensors read back to the host in one read: the
    single tensor's `.tolist()` (a number for a 0-d tensor), or the
    `.tolist()` of several stacked."""
    t = tensors[0] if len(tensors) == 1 else torch.stack(tensors)
    if _rec is None:
        global _reads_total
        _reads_total += 1
        _READS[site] += 1
        return t.tolist()
    with reading(site):
        return t.tolist()


def host_reads():
    """Host reads since import, all sites."""
    return _reads_total


def host_reads_by_site():
    return dict(_READS)


def count(name, n=1):
    """Adds n to a host counter (always on; into the open Capture's record
    instead while one is open)."""
    _into[name] += n


def counter(name):
    """A host counter's running total since import."""
    return _COUNTS.get(name, 0)


class Capture:
    """The counts made while the scope is open (module docstring), e.g.
    during a CUDA graph capture, whose calls run at each replay."""

    def __init__(self):
        self.counts = defaultdict(int)
        self._outer = None

    def __enter__(self):
        global _into
        self._outer, _into = _into, self.counts
        return self

    def __exit__(self, *exc):
        global _into
        _into = self._outer
        return False

    def replay(self):
        """Adds the record, as the calls it was made by would have."""
        for name, n in self.counts.items():
            count(name, n)


def count_device(name, t):
    """Adds the 0-d device tensor t to a device accumulator while tracing
    is on; nothing otherwise."""
    if _rec is not None:
        acc = _rec.device.get(name)
        t = t.to(torch.int64)
        _rec.device[name] = t if acc is None else acc + t


def tracing():
    return _rec is not None


def set_tracing(on):
    """Turns tracing on (a new recording) or off (the recording stays for
    `collect`)."""
    global _rec, _kept
    if on and _rec is None:
        _rec, _kept = _Recording(), None
    elif not on and _rec is not None:
        _rec, _kept = None, _rec


def collect():
    """dict(spans [Span], counters {name: int}, reads {site: int}) since
    tracing was turned on or last collected; the spans of the ranges still
    open are not there yet. The device accumulators are read in one read
    (not counted as a host read). Then a new recording starts while tracing
    is on. None if tracing was never on."""
    global _kept
    rec = _rec if _rec is not None else _kept
    if rec is None:
        return None
    counters = {k: v - rec.counts0.get(k, 0) for k, v in _COUNTS.items()
                if v != rec.counts0.get(k, 0)}
    by_dev = defaultdict(list)
    for name, t in rec.device.items():
        by_dev[t.device].append((name, t))
    for items in by_dev.values():
        vals = torch.stack([t.reshape(()) for _, t in items]).tolist()
        counters.update((name, int(v)) for (name, _), v in zip(items, vals))
    reads = {k: v - rec.reads0.get(k, 0) for k, v in _READS.items()
             if v != rec.reads0.get(k, 0)}
    out = dict(spans=sorted(rec.spans, key=lambda s: s.start_ns), counters=counters,
               reads=reads)
    rec.spans = []
    rec.device = {}
    rec.counts0, rec.reads0 = dict(_COUNTS), dict(_READS)
    if rec is _kept:
        _kept = None
    return out


def span_totals(spans):
    """{name: (count, inclusive ns)} over a recording's spans, a span
    nested in one of the same name counted once; `host_read` spans by
    site as "host_read:<site>"."""
    by_id = {sp.id: sp for sp in spans}
    out = defaultdict(lambda: [0, 0])

    def nested(sp):
        p = by_id.get(sp.parent)
        while p is not None:
            if p.name == sp.name:
                return True
            p = by_id.get(p.parent)
        return False

    for sp in spans:
        keys = [sp.name] + ([f"host_read:{sp.attrs['site']}"] if sp.name == "host_read" else [])
        for key in keys:
            out[key][0] += 1
            if not nested(sp):
                out[key][1] += sp.end_ns - sp.start_ns
    return {k: tuple(v) for k, v in out.items()}


def step_coverage(spans):
    """Per `step` span, the share of its time that its direct children and
    each `newton` child's children cover (the tiling of the step)."""
    kids = defaultdict(list)
    for sp in spans:
        kids[sp.parent].append(sp)

    def dur(sp):
        return sp.end_ns - sp.start_ns

    out = []
    for st in (sp for sp in spans if sp.name == "step"):
        covered = sum(dur(c) if c.name != "newton" else sum(dur(g) for g in kids[c.id])
                      for c in kids[st.id])
        out.append(covered / max(dur(st), 1))
    return out


class Timers:
    """Named cumulative wall-clock activity timers; each section is also a
    span of the same name."""

    def __init__(self):
        self.acc = defaultdict(float)
        self._start = {}

    def start(self, name):
        self._start[name] = time.perf_counter()

    def stop(self, name):
        if name in self._start:
            self.acc[name] += time.perf_counter() - self._start.pop(name)

    def section(self, name):
        timers = self
        sp = span(name)

        class _Ctx:
            def __enter__(self):
                sp.__enter__()
                timers.start(name)

            def __exit__(self, *a):
                timers.stop(name)
                return sp.__exit__(*a)

        return _Ctx()

    def report(self):
        return dict(sorted(self.acc.items(), key=lambda kv: -kv[1]))


def peak_rss_mb():
    """Peak resident set size of this process in MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


class RunLogger:
    """Writes iterStats.txt, sysE/sysM/sysL.txt, info.txt and
    resultsStats.txt into an output directory."""

    def __init__(self, out_dir):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.iter_stats = open(os.path.join(out_dir, "iterStats.txt"), "w")
        self.sysE = open(os.path.join(out_dir, "sysE.txt"), "w")
        self.sysM = open(os.path.join(out_dir, "sysM.txt"), "w")
        self.sysL = open(os.path.join(out_dir, "sysL.txt"), "w")
        self.timers = Timers()
        self.n_steps = 0
        self.total_newton_iters = 0
        self.coll_pairs_max = 0
        self.coll_pairs_sum = 0

    def log_step(self, step_idx, stats):
        """`step alpha #constraints grad_inf` per Newton iteration; stats has
        iters and per-iteration lists alphas, n_constraints, grad_inf
        (shorter lists repeat 1.0 / 0 / 0.0)."""
        for k in range(stats.iters):
            alpha = stats.alphas[k] if k < len(stats.alphas) else 1.0
            ncon = stats.n_constraints[k] if k < len(stats.n_constraints) else 0
            ginf = stats.grad_inf[k] if k < len(stats.grad_inf) else 0.0
            self.iter_stats.write(f"{step_idx} {alpha:.6g} {ncon} {ginf:.6g}\n")
        self.iter_stats.flush()
        self.n_steps += 1
        self.total_newton_iters += stats.iters
        if stats.n_constraints:
            self.coll_pairs_max = max(self.coll_pairs_max, max(stats.n_constraints))
            self.coll_pairs_sum += sum(stats.n_constraints)

    def log_system(self, mesh, meta, state, gravity, dt, model="NH"):
        """Per component: elastic + kinetic + gravitational energy, linear
        and angular momentum (host float64 sums of the state's values)."""
        from ipc_tpu_torch.energy.elasticity import elasticity_energy_per_elem

        x = state.x.detach().cpu().numpy()
        v = state.v.detach().cpu().numpy()
        m = mesh.mass.detach().cpu().numpy()
        comp = mesh.vert_comp.cpu().numpy()
        g = np.asarray(gravity)
        e_el = elasticity_energy_per_elem(state.x, mesh, model).detach().cpu().numpy()
        tet_comp = comp[mesh.tets[:, 0].cpu().numpy()]
        for ci in range(comp.max() + 1):
            sel = comp == ci
            mc = m[sel][:, None]
            E = (
                0.5 * float((mc * v[sel] ** 2).sum())
                - float((m[sel] * (x[sel] @ g)).sum())
                + float(e_el[tet_comp == ci].sum())
            )
            M = (mc * v[sel]).sum(axis=0)
            L = (mc * np.cross(x[sel], v[sel])).sum(axis=0)
            self.sysE.write(f"{E:.10g} ")
            self.sysM.write(f"{M[0]:.10g} {M[1]:.10g} {M[2]:.10g}  ")
            self.sysL.write(f"{L[0]:.10g} {L[1]:.10g} {L[2]:.10g}  ")
        self.sysE.write("\n")
        self.sysM.write("\n")
        self.sysL.write("\n")

    def write_info(self, extra=None):
        """Timing breakdown and memory (info.txt, JSON)."""
        info = {
            "timers_sec": self.timers.report(),
            "peak_rss_mb": peak_rss_mb(),
            "steps": self.n_steps,
            "avg_newton_iters_per_step": self.total_newton_iters / max(1, self.n_steps),
            "coll_pairs_max": self.coll_pairs_max,
        }
        if extra:
            info.update(extra)
        with open(os.path.join(self.out_dir, "info.txt"), "w") as f:
            json.dump(info, f, indent=2)

    def write_results_stats(self, wall_time):
        with open(os.path.join(self.out_dir, "resultsStats.txt"), "w") as f:
            f.write(f"steps {self.n_steps}\n")
            f.write(f"avg_iters_per_step {self.total_newton_iters / max(1, self.n_steps):.3f}\n")
            f.write(f"avg_sec_per_step {wall_time / max(1, self.n_steps):.6f}\n")
            f.write(f"total_sec {wall_time:.3f}\n")

    def close(self):
        for f in (self.iter_stats, self.sysE, self.sysM, self.sysL):
            f.close()


def _f64(t):
    return t.detach().cpu().numpy().astype(np.float64)


def save_status(path, state, step_idx, stepper=None):
    """Full-precision checkpoint (npz): step, t, x, v, a in float64; with
    moving ACO planes also the stepper's hs_origin and the script's aco_vel
    (see the module docstring)."""
    extra = {}
    if stepper is not None and stepper.hs_moving:
        extra["hs_origin"] = np.asarray(stepper.hs_origin, np.float64)
        extra["aco_vel"] = np.asarray(stepper.script.aco_vel, np.float64)
    np.savez_compressed(path, step=step_idx, t=float(state.t), x=_f64(state.x),
                        v=_f64(state.v), a=_f64(state.a), **extra)


def save_status_text(path, state, step_idx):
    """The reference's text status file: `timestep`, `position` (nV x 3),
    `velocity` (flat 3 nV), `acceleration` (nV x 3), `dx_Elastic` (zeros: a
    warm-start cache the solver recomputes)."""
    x, v, a = _f64(state.x), _f64(state.v), _f64(state.a)
    n = len(x)
    with open(path, "w") as f:
        f.write(f"timestep {step_idx}\n\n")
        f.write(f"position {n} 3\n")
        for r in x:
            f.write(f"{r[0]:.19g} {r[1]:.19g} {r[2]:.19g}\n")
        f.write("\n")
        f.write(f"velocity {3 * n}\n")
        for r in v:
            f.write(f"{r[0]:.19g}\n{r[1]:.19g}\n{r[2]:.19g}\n")
        f.write("\n")
        f.write(f"acceleration {n} 3\n")
        for r in a:
            f.write(f"{r[0]:.19g} {r[1]:.19g} {r[2]:.19g}\n")
        f.write("\n")
        f.write(f"dx_Elastic {n} 3\n")
        for _ in range(n):
            f.write("0 0 0\n")


def _state(stepper, x, v, a, t, step):
    from ipc_tpu_torch.timestepper import SimState

    def conv(arr):
        return torch.as_tensor(np.asarray(arr, np.float64), device=stepper.device).to(
            stepper.dtype)

    xt = conv(x)
    return SimState(x=xt, x_prev=xt, v=conv(v), a=conv(a), t=t, step=step)


def load_status_text(path, stepper):
    """A reference-format text status file -> SimState in the stepper's
    dtype on its device."""
    with open(path) as f:
        toks = f.read().split()
    i = 0

    def expect(word):
        nonlocal i
        while toks[i] != word:
            i += 1
        i += 1

    expect("timestep")
    step = int(toks[i]); i += 1
    expect("position")
    n, c = int(toks[i]), int(toks[i + 1]); i += 2
    x = np.array(toks[i : i + n * c], np.float64).reshape(n, c); i += n * c
    expect("velocity")
    m = int(toks[i]); i += 1
    v = np.array(toks[i : i + m], np.float64).reshape(-1, 3); i += m
    a = np.zeros_like(x)
    try:
        expect("acceleration")
        n2, c2 = int(toks[i]), int(toks[i + 1]); i += 2
        a = np.array(toks[i : i + n2 * c2], np.float64).reshape(n2, c2)
    except IndexError:
        pass
    return _state(stepper, x, v, a, step * stepper.dt, step)


def load_status(path, stepper):
    """Restart from an npz checkpoint -> SimState in the stepper's dtype on
    its device. With moving planes, restores the stepper's hs_origin and
    the script's aco_vel, which the host path and initial_device_aux read."""
    z = np.load(path)
    if "hs_origin" in z and stepper.hs_moving:
        stepper.hs_origin[:] = z["hs_origin"]
        stepper.script.aco_vel[:] = z["aco_vel"]
        stepper._refresh_hs_D()
    return _state(stepper, z["x"], z["v"], z["a"], float(z["t"]), int(z["step"]))
