"""Run artifacts: timers, per-iteration stats, conservation logs, checkpoints.

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
"""

import json
import os
import resource
import time
from collections import defaultdict

import numpy as np
import torch

from ipc_tpu_torch.timestepper import SimState

__all__ = [
    "Timers",
    "RunLogger",
    "save_status",
    "load_status",
    "save_status_text",
    "load_status_text",
    "peak_rss_mb",
]


class Timers:
    """Named cumulative wall-clock activity timers."""

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

        class _Ctx:
            def __enter__(self):
                timers.start(name)

            def __exit__(self, *a):
                timers.stop(name)

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
