"""Per-layer wall times of a time step on one GPU.

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
  2. layers: a `torch.cuda.synchronize()` around every call of each layer
     below, summed per layer (inclusive: an indented layer also counts in
     the one it is called from; the syncs inflate the total);
  3. trace: `torch.profiler` over the last of those steps alone: CUDA
     kernel time summed against that step's plain wall time (the device's
     busy share), kernel count, and the kernels that take the most time.

The timers replace functions of the port's modules for the life of the
process, so run this as its own process. Needs a CUDA device.
"""

import argparse
import time
from collections import defaultdict

import torch

__all__ = ["main"]


class _Timers:
    """Synchronized wall-time sums per label, taken only while `on`."""

    def __init__(self):
        self.on = False
        self.acc = defaultdict(lambda: [0, 0.0])

    def wrap(self, label, fn):
        def timed(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.acc[label][0] += 1
            self.acc[label][1] += time.perf_counter() - t0
            return out

        return timed

    def install(self, owner, attr, label):
        setattr(owner, attr, self.wrap(label, getattr(owner, attr)))


class _Assemble:
    """A timed coarse `assemble` that still shows the original's host_syncs."""

    def __init__(self, fn, timed):
        self.fn, self.timed = fn, timed

    def __call__(self, *args, **kwargs):
        return self.timed(*args, **kwargs)

    @property
    def host_syncs(self):
        return self.fn.host_syncs


def _install(timers, stepper, host):
    from ipc_tpu_torch import jit_step as JS
    from ipc_tpu_torch import step_terms as ST
    from ipc_tpu_torch.contact import pipeline as PL
    from ipc_tpu_torch.energy import elasticity as EL
    from ipc_tpu_torch.ops import compensated as CO

    targets = [
        (EL, "elasticity_hessian_blocks", "elasticity 12x12 blocks"),
        (EL, "elasticity_gradient", "elasticity gradient"),
        (EL, "elasticity_energy_per_elem", "elasticity energy"),
        (EL, "filter_step_size", "inversion step bound"),
        (ST, "pcg", "PCG solves (operator + preconditioner)"),
        (ST, "tet_hv", "  tet_hv (in PCG)"),
        (CO, "df_sum", "compensated sums (energies)"),
        (stepper, "_friction_energy", "friction energy"),
        (stepper, "_friction_gradient", "friction gradient"),
        (stepper, "_friction_hessians", "friction blocks"),
    ]
    if host:
        targets += [
            (stepper, "_sweep_clamp", "swept-span clamp (host read)"),
            (stepper, "_all_dist2", "kappa-doubling distances (host read)"),
            (stepper, "init_kappa", "kappa init"),
        ]
    if stepper.script is not None:
        closures = JS.device_closures

        def closures_timed(*args, **kwargs):
            disp_fn, fext_fn, turn = closures(*args, **kwargs)
            if disp_fn is not None:
                disp_fn = timers.wrap("scripted displacement (disp_fn)", disp_fn)
            return disp_fn, fext_fn, turn

        JS.device_closures = closures_timed
    sc = stepper.sc
    if sc is not None:
        targets += [
            (sc, "build_candidates", "broad phase (build_candidates)"),
            (sc, "ccd_alpha", f"CCD ({sc.ccd_method})"),
            (sc, "active_set", "active-set compaction"),
            (sc, "hessian_blocks_from_active", "pair Hessians + PSD"),
            (PL, "make_psd", "  PSD projection (in pair Hessians)"),
            (sc, "gradient_active", "barrier gradient"),
            (sc, "energy_active", "barrier energy (line search)"),
            (sc, "intersects_pairs", "intersection test (line search)"),
            (sc, "capture_friction", "friction capture"),
            (sc, "vert_sum", "active-set gather-sum tables"),
        ]
        if host:
            targets.append((sc, "has_intersection", "intersection test (fresh ET broad phase)"))
    for owner, attr, label in targets:
        timers.install(owner, attr, label)
    make = ST.make_coarse_assembler

    def make_timed(*args, **kwargs):
        assemble, term = make(*args, **kwargs)
        return (_Assemble(assemble, timers.wrap("coarse assembly", assemble)),
                timers.wrap("coarse correction (in PCG)", term))

    ST.make_coarse_assembler = make_timed


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
    timers = _Timers()
    _install(timers, st, host)
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

    timers.on = True
    _, synced = _run(step, counts, start, args.steps, host)
    timers.on = False
    total = sum(r[0] for r in synced)
    print(f"[profile] synced layers over the same {args.steps} steps: {total:.4f} s")
    for label, (calls, sec) in sorted(timers.acc.items(), key=lambda kv: -kv[1][1]):
        print(f"[profile] layer | {label} | calls={calls} | s={sec:.4f} | "
              f"share={100.0 * sec / total:.1f}%")

    last, _ = _run(step, counts, start, args.steps - 1, host)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step(last)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    w_last = plain[-1][0]
    print(f"[profile] trace of step {args.settle + args.steps - 1}: kernel time {busy:.4f} s "
          f"over {sum(e.count for e in kernels)} kernels; plain wall {w_last:.4f} s: "
          f"busy {100.0 * busy / w_last:.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile] kernel | {e.key[:90]} | count={e.count} | "
              f"s={e.self_device_time_total / 1e6:.4f}")


if __name__ == "__main__":
    main()
