"""One run of one benchmark cell: set-up, the measured window, the traced
part and the reference's judgement.

Everything that belongs to one configuration, traffic mix, seeded
perturbation, per-layer metric or kernel lives in a file of its own under
portbench/, found by the name that BENCHMARK.json gives:

  configs/<config>.json    the scene builder of ipc_tpu_torch.scenes and its
                           arguments, and the scene's parameters for the
                           reference (portbench/reference/)
  traffic/<traffic>.json   steps before the episode's start state S0, the
                           episode's steps K, the perturbation, its
                           parameters and its start variants, the episode
                           step the profiler traces
  perturb/<name>.py        apply(scene, params, rng) -> (x0, v0)
  metrics/<metric>.json    a layer timer ("wrap": program functions), a
                           ratio of counters ("ratio": [numerator, denominator])
                           or the reading of another metric ("as": <metric>)
  metrics/<metric>.py      read(ctx) -> value or None (trace readers)
  kernels/<kernel>.py      the bytes (and operations) of one call, from shapes
  limits/<cell>.json       the limit of each number the reference compares

A traffic mix names a fixed set of start variants (perturbation seeds,
`perturb.variants`), or none, when the run's seed is the one variant.
Set-up takes each variant through the steps before its S0 and runs one
warm-up episode of each. The window plays whole rounds (each variant's
episode once, in an order drawn from the run's seed) until `seconds` have
passed: every run does the same work, and step_s is the window over the
steps completed in it. Set-up is everything from process start to the
window: imports, the kernel library's load (its build on a checkout's
first run), the scene, the steps before S0 and the warm-up. The reference
then judges one variant's steps before S0 and one of its replays, both
drawn from the seed.
"""

import dataclasses
import gc
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from portbench.reference import judge as RJ
from portbench.reference import scene as RS
from portbench.tracing import Layers, reduce_trace, trace_events

__all__ = ["Cell", "load_cell", "run", "FORBIDDEN", "forbidden_modules", "NoDevice"]

BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ipc_tpu")
WINDOW_LABEL = "portbench.window"


class NoDevice(RuntimeError):
    """The cell's chips are not there."""


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def _load_py(path, name):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read_json(path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    perturb: object
    end_to_end: list  # the end-to-end metrics the cell reports
    metrics: dict  # per-layer metric name -> (kind, spec or module)
    units: dict  # metric name -> unit, end-to-end and per-layer
    bench_dir: str


def load_cell(name, root=".", bench_dir=BENCH):
    """The cell `name` of root/BENCHMARK.json with its files from bench_dir."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, cfg_entry["file"]))
    traffic = _read_json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    limits = _read_json(os.path.join(bench_dir, "limits", name + ".json"))
    pname = traffic["perturb"]["name"]
    perturb = _load_py(os.path.join(bench_dir, "perturb", pname + ".py"), pname)
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}

    def listed(m):
        return "workloads" not in m or name in m["workloads"]

    # a per-layer metric without a workloads list belongs to every cell that
    # reports the end-to-end metric it moves
    end_to_end = [m["name"] for m in bench["end_to_end"] if listed(m)]
    metrics = {m["name"]: _metric_spec(m["name"], bench_dir) for m in bench["per_layer"]
               if listed(m) and m["moves"] in end_to_end}
    return Cell(name, int(w["chips"]), config, traffic, limits, perturb, end_to_end, metrics,
                units, bench_dir)


def _metric_spec(name, bench_dir, seen=()):
    """(kind, spec or module) of metrics/<name>.json or .py; a file that
    says {"as": <metric>} reads what that metric's file reads."""
    if name in seen:
        raise ValueError(f"metric files read as each other: {seen + (name,)}")
    base = os.path.join(bench_dir, "metrics", name)
    if not os.path.exists(base + ".json"):
        return "py", _load_py(base + ".py", name)
    spec = _read_json(base + ".json")
    if "as" in spec:
        return _metric_spec(spec["as"], bench_dir, seen + (name,))
    return "json", spec


def kernel_module(name, bench_dir=BENCH):
    return _load_py(os.path.join(bench_dir, "kernels", name + ".py"), "kernel_" + name)


def power_limit():
    """nvidia-smi's name and power limit of the cards, or what it said."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check(name, value, limit):
    """(passes, limit text) of one compared number."""
    if "max" in limit:
        return value <= limit["max"], f"<= {limit['max']}"
    if "above" in limit:
        return value > limit["above"], f"> {limit['above']}"
    raise ValueError(f"limit of {name}: 'max' or 'above'")


def judge(cell, scene, x0, v0, chain, first_step=0):
    """The reference's numbers over a chain of step outputs from (x0, v0),
    and the checks against the cell's limits: (numbers, checks, correct)."""
    worst, rows = RJ.judge_chain(scene, x0, v0, chain, first=first_step)
    checks, correct = {}, True
    for name, limit in cell.limits.items():
        if name not in worst:
            continue
        ok, text = _check(name, worst[name], limit)
        correct = correct and ok and math.isfinite(worst[name])
        checks[name] = {"value": worst[name], "limit": text}
    return worst, rows, checks, correct


def build_program(cell, device, layers=None):
    """(stepper, step) of the cell's configuration on `device`; `layers`
    wraps its program functions before the step is built."""
    from ipc_tpu_torch import jit_step, scenes

    cfg = cell.config
    stepper = getattr(scenes, cfg["builder"])(**cfg["args"], device=device)
    if layers is not None:
        layers.install(stepper)
    return stepper, jit_step.make_step(stepper)


def initial_state(cell, stepper, scene, seed):
    """(state, x0, v0): the seeded start, the same arrays for both sides."""
    from ipc_tpu_torch import jit_step

    rng = np.random.default_rng(abs(int(seed)))
    x0, v0 = cell.perturb.apply(scene, cell.traffic["perturb"].get("params", {}), rng)
    state = stepper.initial_state(x0, v0)
    aux = jit_step.initial_device_aux(stepper)
    if aux is not None:
        state = dataclasses.replace(state, aux=aux)
    return state, x0, v0


def run(cell, seed, seconds, trace, device, log=print, step_wrap=None, t_process=None):
    """One run of `cell`; returns the result dict that run.py prints.

    step_wrap, when given, wraps the program's step function (the tests
    plant faults through it)."""
    t_process = time.perf_counter() if t_process is None else t_process
    tr = cell.traffic
    K, n_before = int(tr["episode_steps"]), int(tr["steps_before"])
    scene = RS.build(cell.config, device)
    specs = {n: s["wrap"] for n, (k, s) in cell.metrics.items()
             if k == "json" and "wrap" in s}
    layers = Layers(specs, device) if trace else None
    stepper, step = build_program(cell, device, layers)
    if step_wrap is not None:
        step = step_wrap(step)
    rng = np.random.default_rng(abs(int(seed)))
    # the start variants: a fixed set of perturbation seeds that every run
    # plays, in an order drawn from the run's seed; without a set, the
    # run's seed is the only variant
    variants = tr["perturb"].get("variants") or [abs(int(seed))]
    order = [int(i) for i in rng.permutation(len(variants))]
    starts = []  # per variant: (x0, v0, program start x, chain to S0, S0)
    for vseed in variants:
        state, x0, v0 = initial_state(cell, stepper, scene, vseed)
        x_start = state.x.detach().clone()
        chain = []
        for _ in range(n_before):
            state, _ = step(state)
            chain.append(state.x.detach().clone())
        starts.append((x0, v0, x_start, chain, state))
    rest_prog = stepper.mesh.x_rest.detach().clone()

    def episode(s0):
        s, outs, stats = s0, [], []
        for _ in range(K):
            s, st = step(s)
            outs.append(s)
            stats.append(st)
        return outs, stats

    for i in order:  # warm-up: every variant's episode once
        episode(starts[i][4])
    _sync(device)
    setup_s = time.perf_counter() - t_process
    setup_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    counts0 = (step.host_syncs, step.operator_applications)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if layers is not None:
        layers.timing = True
    replays, all_stats = [[] for _ in variants], []
    _sync(device)
    t0 = time.perf_counter()
    # whole rounds (every variant's episode once), so that every run weighs
    # the variants and the episode's steps alike
    rounds = []
    while True:
        for i in order:
            outs, stats = episode(starts[i][4])
            replays[i].append([o.x for o in outs])
            all_stats += stats
        rounds.append(time.perf_counter() - t0 - sum(rounds))
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    if layers is not None:
        layers.timing = False
    n_steps = len(all_stats)
    syncs = step.host_syncs - counts0[0]
    op_apps = step.operator_applications - counts0[1]
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(not math.isfinite(st.energy) for st in all_stats)
    newton = sum(st.newton_iters for st in all_stats)
    pcg = sum(st.pcg_iters_total for st in all_stats)
    log(f"[portbench] set-up {setup_s:.4f} s (peak {setup_peak} B); "
        f"window {window_s:.4f} s, {len(replays[0])} rounds of {len(variants)} episodes "
        f"of {K} steps, "
        f"{newton} Newton / {pcg} PCG iterations, {syncs} host syncs, "
        f"{op_apps} operator applications, peak {peak} B; rounds (s) {rounds}")

    metrics, breakdown, dev_extra = {}, None, {}
    if not trace:
        e2e = dict(step_s=window_s / n_steps, peak_mem_GiB=peak / 2**30, setup_s=setup_s)
        metrics = {k: e2e[k] for k in cell.end_to_end}
    else:
        ctx = dict(steps=n_steps, window_s=window_s, newton_iters=newton, pcg_iters=pcg, host_syncs=syncs,
                   operator_applications=op_apps, layer_seconds=dict(layers.seconds),
                   layer_calls=dict(layers.calls), cell=cell,
                   shapes=dict(n_tets=int(stepper.mesh.tets.shape[0]),
                               n_verts=int(stepper.mesh.x_rest.shape[0]),
                               itemsize=stepper.mesh.x_rest.element_size()),
                   device_name=_device_name(device),
                   kernel=kernel_module, trace=None)
        if device.type == "cuda":
            ctx["trace"] = _profile(step, starts[order[0]][4], tr, layers, device, log)
            t = ctx["trace"]
            dev_extra = dict(busy_s=t["busy_s"], window_s=t["window_s"])
            breakdown = dict(
                device_ops=sorted(([_short(k), v] for k, v in t["kernels"].items()),
                                  key=lambda kv: -kv[1])[:10],
                idle_gaps=sorted(([k, v] for k, v in t["idle"].items()),
                                 key=lambda kv: -kv[1])[:10])
        for name, (kind, spec) in cell.metrics.items():
            value = _read_metric(name, kind, spec, ctx)
            if value is not None:
                metrics[name] = value

    # the judged answers: one variant's steps before S0 and one of its
    # replays, drawn from the seed, after the program's state is freed
    j = int(rng.integers(len(variants)))
    pick = int(rng.integers(len(replays[j])))
    x0, v0, x_start, chain, _ = starts[j]
    chain = chain + [x.detach().clone() for x in replays[j][pick]]
    del replays, starts, state, step, stepper
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers, rows, checks, correct = judge(cell, scene, x0, v0, chain)
    start_err = float(max(
        (x_start.double().cpu() - torch.as_tensor(x0).float().double()).abs().max(),
        (rest_prog.double().cpu() - scene.x_rest.float().double().cpu()).abs().max()))
    ok_start = start_err == 0.0
    checks = {"start_err": {"value": start_err, "limit": "== 0"}, **checks}
    correct = correct and ok_start and failed == 0
    log(f"[portbench] reference judged variant {variants[j]} (replay {pick}): {len(chain)} "
        f"steps in {time.perf_counter() - t_judge:.1f} s")
    for r in rows:
        log("[portbench] step " + " ".join(f"{k}={v}" for k, v in r.items()))

    result = dict(
        correct=bool(correct), attempted=n_steps, failed=failed,
        metrics={k: {"value": v, "unit": cell.units[k]} for k, v in metrics.items()},
        device=dict(platform="gpu" if device.type == "cuda" else device.type,
                    kind=_device_name(device), count=1,
                    memory_peak_bytes=int(max(peak, setup_peak)), **dev_extra),
    )
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def _short(kernel):
    """A kernel's name without the namespaces that every ATen kernel shares."""
    for junk in ("void ", "at::native::", "(anonymous namespace)::", "at::cuda::"):
        kernel = kernel.replace(junk, "")
    return kernel[:120]


def _device_name(device):
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _read_metric(name, kind, spec, ctx):
    if kind == "py":
        return spec.read(ctx)
    if "wrap" in spec:
        calls = ctx["layer_calls"].get(name, 0)
        if calls == 0:
            return None
        return 1000.0 * ctx["layer_seconds"][name] / ctx["steps"]
    num, den = spec["ratio"]
    return ctx[num] / ctx[den] if ctx[den] else None


def _profile(step, s0, tr, layers, device, log):
    """The traced part: the episode's step `profile_step`, from its input
    state, once plain (its wall time) and once under torch.profiler with
    the layer labels on. Returns the reduced trace."""
    k = int(tr.get("profile_step", 0))
    src = s0
    if k:
        # the state before step k of an episode: replay the steps before it
        for _ in range(k):
            src, _ = step(src)
    _sync(device)
    t0 = time.perf_counter()
    step(src)
    _sync(device)
    wall_plain = time.perf_counter() - t0
    apps0 = step.operator_applications
    layers.labels = True
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t1 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_LABEL):
            step(src)
            _sync(device)
    traced_wall = time.perf_counter() - t1
    layers.labels = False
    apps = step.operator_applications - apps0
    t2 = time.perf_counter()
    events = trace_events(prof)
    win = [e for e in events if e[1] == WINDOW_LABEL and not e[0]]
    t_start, t_end = win[0][2], win[0][3]
    red = reduce_trace(events, t_start, t_end, set(layers.specs), skip={WINDOW_LABEL})
    log(f"[portbench] {len(events)} trace events reduced in {time.perf_counter() - t2:.1f} s")
    red.update(window_s=(t_end - t_start) / 1e6, wall_plain_s=wall_plain,
               operator_applications=apps, profile_step=k)
    log(f"[portbench] traced episode step {k}: plain {wall_plain:.4f} s, under the profiler "
        f"{traced_wall:.4f} s, device busy {red['busy_s']:.4f} s, {len(red['kernels'])} "
        f"kernel names, {apps} operator applications")
    return red
