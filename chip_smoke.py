#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ipc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and ends the run
with a non-zero exit code (nothing is caught):

  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: the CUDA kernels from csrc/ (nvcc, sm_90a) into build/kernels/;
  3. kernel vs plain: tet_hv against its plain PyTorch version on the card
     at the scene's shapes (n_cells 8 and 20; float32 and float64), with
     tolerances 1e-5 (f32) / 1e-12 (f64) x the plain result's max |.|,
     bitwise-equal repeats, and CUDA-event times (median of 20);
  4. main path: build_scene(n_cells=20, float32, "cuda") -> make_step for 10
     steps (96,000 tets; ground contact and friction active). Counts are
     zeroed just before: every kernel of the path must have launched, the
     Hv kernel once per Newton-operator application. Every state finite,
     ymin > 0, and one step taken twice from one state is bitwise equal;
  5. reference: 3 float64 steps at n_cells=2 on the card against the same
     steps on the CPU (the plain path the tests hold to the JAX package).

The line before the last is the kernels record, the last line
{"ok": true, "device": {...}}. Without a CUDA device the run fails in
phase 1 and prints neither.
"""

import json
import statistics
import subprocess
import time

import numpy as np


def time_ms(fn, reps=20):
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def phase_device():
    import torch

    from ipc_tpu_torch.device import require_cuda

    device = require_cuda()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {name}")
    print(smi)  # name, power limit: nvidia-smi's own line
    return device, name


def phase_build():
    from ipc_tpu_torch.build import build_kernels, load_kernels

    info = build_kernels(force=True)
    load_kernels()
    print(f"[build] {info['seconds']:.2f} s -> {info['path']}")
    for line in info["log"].splitlines():
        if "ptxas info" in line and ("registers" in line or "Compiling" in line):
            print(f"[build] {line.strip()}")


def phase_kernel_vs_plain(device):
    import torch

    from ipc_tpu_torch.ops.tet_hv import make_tet_hv_table, tet_hv, tet_hv_reference
    from ipc_tpu_torch.scenes import build_scene

    tol = {torch.float32: 1e-5, torch.float64: 1e-12}
    records = {}
    for n_cells in (8, 20):
        st = build_scene(n_cells, torch.float64, "cpu")
        tets = st.mesh.tets.numpy()
        n_verts = int(st.mesh.x_rest.shape[0])
        table = make_tet_hv_table(tets, n_verts, device)
        rng = np.random.default_rng(n_cells)
        M = rng.normal(size=(tets.shape[0], 12, 12))
        H_np = M @ np.swapaxes(M, 1, 2) / 12.0  # SPD-like blocks
        v_np = rng.normal(size=(n_verts, 3))
        v_np[rng.uniform(size=n_verts) < 0.2] = 0.0  # DBC rows of v
        for dtype in (torch.float32, torch.float64):
            H = torch.as_tensor(H_np, device=device).to(dtype).contiguous()
            v = torch.as_tensor(v_np, device=device).to(dtype).contiguous()
            out = tet_hv(H, v, table)
            again = tet_hv(H, v, table)
            plain = tet_hv_reference(H, table.tets, v, table.gsum)
            torch.cuda.synchronize()
            err = (out - plain).abs().max().item()
            scale = plain.abs().max().item()
            bitwise = bool(torch.equal(out, again))
            ms = time_ms(lambda: tet_hv(H, v, table))
            plain_ms = time_ms(lambda: tet_hv_reference(H, table.tets, v, table.gsum))
            name = str(dtype).replace("torch.", "")
            print(f"[kernel] tet_hv n_cells={n_cells} tets={tets.shape[0]} verts={n_verts} "
                  f"{name}: max_abs_err={err:.3e} (limit {tol[dtype] * scale:.3e}) "
                  f"bitwise_repeat={bitwise} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
            check(err <= tol[dtype] * scale, f"tet_hv {name} n_cells={n_cells} within tolerance")
            check(bitwise, f"tet_hv {name} n_cells={n_cells} bitwise repeatable")
            records[(n_cells, name)] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return records


def _check_state(s):
    import torch

    for t in (s.x, s.v):
        check(bool(torch.isfinite(t).all()), "finite state")
    ymin = s.x[:, 1].min().item()
    check(ymin > 0.0, "ymin > 0 (no vertex below the ground)")
    return ymin


def phase_main_path(device):
    import torch

    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.scenes import build_scene

    t0 = time.perf_counter()
    st = build_scene(20, torch.float32, device)
    step = make_step(st)
    state = st.initial_state()
    torch.cuda.synchronize()
    print(f"[main] scene n_cells=20 float32: {st.mesh.tets.shape[0]} tets, "
          f"{st.mesh.x_rest.shape[0]} verts, setup {time.perf_counter() - t0:.2f} s")
    tet_hv.launches = 0
    ops0, syncs0 = step.operator_applications, step.host_syncs
    total = 0.0
    for i in range(10):
        ops_i, syncs_i = step.operator_applications, step.host_syncs
        t0 = time.perf_counter()
        state, stats = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total += wall
        ymin = _check_state(state)
        print(f"[main] step {i}: newton_iters={stats.newton_iters} "
              f"pcg_iters_total={stats.pcg_iters_total} kappa={stats.kappa:.6g} "
              f"kappa_doublings={stats.kappa_doublings} sweep_clamps={stats.sweep_clamps} "
              f"operator_applications={step.operator_applications - ops_i} "
              f"host_syncs={step.host_syncs - syncs_i} ymin={ymin:.6g} wall_s={wall:.4f}")
    launches = tet_hv.launches
    ops = step.operator_applications - ops0
    print(f"[main] 10 steps in {total:.3f} s; tet_hv launches={launches} "
          f"operator applications={ops} host syncs={step.host_syncs - syncs0}")
    check(launches > 0, "tet_hv launched on the main path")
    check(launches == ops, "one tet_hv launch per operator application")
    a, _ = step(state)
    b, _ = step(state)
    torch.cuda.synchronize()
    same = bool(torch.equal(a.x, b.x))
    print(f"[main] one step twice from one state: bitwise_equal={same}")
    check(same, "step bitwise repeatable")
    return launches


def phase_reference(device):
    import torch

    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.scenes import build_scene

    runs = {}
    for dev in ("cpu", device):
        st = build_scene(2, torch.float64, dev)
        step = make_step(st)
        s = st.initial_state()
        rows = []
        for _ in range(3):
            s, stats = step(s)
            rows.append((s.x.cpu().numpy(), stats.newton_iters, stats.pcg_iters_total))
        runs[str(dev)] = rows
    (ref, got) = runs["cpu"], runs[str(device)]
    dx = max(float(np.abs(g[0] - r[0]).max()) for g, r in zip(got, ref))
    iters = [(g[1], g[2]) for g in got] == [(r[1], r[2]) for r in ref]
    print(f"[reference] n_cells=2 float64, 3 steps card vs CPU: max |dx|={dx:.3e} "
          f"same newton/pcg counts={iters}")
    check(dx <= 1e-9 and iters, "card agrees with the CPU reference")


def main():
    import torch

    device, name = phase_device()
    phase_build()
    records = phase_kernel_vs_plain(device)
    launches = phase_main_path(device)
    phase_reference(device)
    main_rec = records[(20, "float32")]  # the main path's shape and dtype
    print(json.dumps({"kernels": [dict(
        name="tet_hv", route="cuda", source="ipc_tpu_torch/csrc/tet_hv.cu",
        replaces="ipc_tpu/ops/pallas_hv.py:107", launches=launches, **main_rec,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
