#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ipc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines with its seconds; any failure raises
and ends the run with a non-zero exit code (nothing is caught):

  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: the CUDA kernels from csrc/ (nvcc, sm_90a) into build/kernels/;
  3. kernel vs plain: tet_hv against its plain PyTorch version on the card
     at the scene's shapes (n_cells 8 and 20: 6,144 and 96,000 tets;
     float32 and float64), with tolerances 1e-5 (f32) / 1e-12 (f64) x the
     plain result's max |.| and bitwise-equal repeats; device times
     (ipc_tpu_torch/hv_timing.py: CUDA events, median of 20, L2 flushed)
     of the kernel, the plain version and the library yardstick (cuSPARSE
     SpMV through a torch CSR matrix assembled from the same H, which must
     agree within the same tolerance), the assembly's time, the bound
     (bytes at 3.35 TB/s) with the kernel's share of it, and each device
     kernel's time per call (torch.profiler);
  4. ground path: build_scene(n_cells=20, float32, "cuda") -> make_step for
     10 steps (96,000 tets; ground contact and friction, no self-contact).
     Counts are zeroed just before: the Hv kernel must have launched once
     per Newton-operator application. Every state finite, ymin > 0, and
     one step taken twice from one state is bitwise equal;
  5. ground reference: 3 float64 steps at n_cells=2 on the card against
     the same steps on the CPU (the plain path the tests hold to the JAX
     package);
  6. broad phase: at n_cells=8, on 3 seeded swept displacements, the grid
     (spatial hash) and dense PT/EE/ET candidate sets are equal on the card;
  7. contact path, the main path: build_scene(n_cells=20, float32, "cuda",
     with_contact=True) -> make_step for 14 steps, through the boxes'
     impact (about step 8). Per step: iterations, candidate and active
     counts, friction pairs, kappa, host syncs, wall seconds. After every
     step: finite, ymin > 0, no edge-triangle intersection. Over the run:
     active and friction pairs appear, tet_hv launched once per operator
     application (counts zeroed just before), and a post-impact step taken
     twice from one state is bitwise equal;
  8. bench timing: the bench scene (n_cells=8, float32, with contact) as
     bench.py times it: one warm-up and 10 settling steps, then 20 timed
     steps; seconds per step and per Newton iteration;
  9. contact reference: at n_cells=2 in float64 with contact, the CPU runs
     8 steps, then each of steps 8-10 is taken from the CPU's state on the
     card and on the CPU. Newton and kappa-doubling counts must be equal;
     x within 1e-9, or within twice the CPU step's own response to a 1-ulp
     perturbation of x where that is larger (an ill-conditioned impact
     step), and the PCG count within the count change the same
     perturbation causes.

The line before the last is the kernels record, the last line
{"ok": true, "device": {...}}. Without a CUDA device the run fails in
phase 1 and prints neither.
"""

import json
import subprocess
import time

import numpy as np


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

    from ipc_tpu_torch.hv_timing import measure

    records = {}
    for n_cells in (8, 20):
        for dtype in (torch.float32, torch.float64):
            r = measure(n_cells, dtype, device)
            print(f"[kernel] tet_hv n_cells={n_cells} tets={r['tets']} verts={r['verts']} "
                  f"D={r['D']} {r['dtype']}: max_abs_err={r['max_abs_err']:.3e} (limit "
                  f"{r['limit']:.3e}) bitwise_repeat={r['bitwise_repeat']} "
                  f"kernel_ms={r['kernel_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
                  f"library_ms={r['library_ms']:.5f} (library_err={r['library_err']:.3e}, "
                  f"nnz={r['nnz']}, assembly_ms={r['assembly_ms']:.3f}) bytes={r['bytes']} "
                  f"bound_us={r['bound_us']:.3f} ({r['bound_by']}) "
                  f"share_of_bound={r['share_of_bound']:.4f} empty_ms={r['empty_ms']:.5f} "
                  f"split_us={json.dumps(r['split_us'])}")
            what = f"tet_hv {r['dtype']} n_cells={n_cells}"
            check(r["max_abs_err"] <= r["limit"], f"{what} within tolerance")
            check(r["bitwise_repeat"], f"{what} bitwise repeatable")
            check(r["library_err"] <= r["limit"], f"{what}: the yardstick computes the same map")
            records[(n_cells, r["dtype"])] = r
    return records


def _check_state(s):
    import torch

    for t in (s.x, s.v):
        check(bool(torch.isfinite(t).all()), "finite state")
    ymin = s.x[:, 1].min().item()
    check(ymin > 0.0, "ymin > 0 (no vertex below the ground)")
    return ymin


def _bitwise_repeat(step, state, tag):
    import torch

    a, _ = step(state)
    b, _ = step(state)
    torch.cuda.synchronize()
    same = bool(torch.equal(a.x, b.x))
    print(f"[{tag}] one step twice from one state: bitwise_equal={same}")
    check(same, f"{tag} step bitwise repeatable")


def phase_ground_path(device):
    import torch

    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.scenes import build_scene

    t0 = time.perf_counter()
    st = build_scene(20, torch.float32, device)
    step = make_step(st)
    state = st.initial_state()
    torch.cuda.synchronize()
    print(f"[ground] scene n_cells=20 float32: {st.mesh.tets.shape[0]} tets, "
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
        print(f"[ground] step {i}: newton_iters={stats.newton_iters} "
              f"pcg_iters_total={stats.pcg_iters_total} kappa={stats.kappa:.6g} "
              f"kappa_doublings={stats.kappa_doublings} sweep_clamps={stats.sweep_clamps} "
              f"operator_applications={step.operator_applications - ops_i} "
              f"host_syncs={step.host_syncs - syncs_i} ymin={ymin:.6g} wall_s={wall:.4f}")
    launches = tet_hv.launches
    ops = step.operator_applications - ops0
    print(f"[ground] 10 steps in {total:.3f} s; tet_hv launches={launches} "
          f"operator applications={ops} host syncs={step.host_syncs - syncs0}")
    check(launches > 0, "tet_hv launched on the ground path")
    check(launches == ops, "one tet_hv launch per operator application (ground)")
    _bitwise_repeat(step, state, "ground")


def phase_ground_reference(device):
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
    print(f"[ground-ref] n_cells=2 float64, 3 steps card vs CPU: max |dx|={dx:.3e} "
          f"same newton/pcg counts={iters}")
    check(dx <= 1e-9 and iters, "card agrees with the CPU reference (ground)")


def phase_broadphase(device):
    import torch

    from ipc_tpu_torch.contact import broadphase as BP
    from ipc_tpu_torch.contact import spatial_hash as SH
    from ipc_tpu_torch.scenes import build_scene

    st = build_scene(8, torch.float32, device, with_contact=True)
    m = st.mesh
    x = m.x_rest
    gap = float(np.sqrt(st.dHat))
    rng = np.random.default_rng(8)

    def as_set(pairs):
        return set(map(tuple, pairs.cpu().numpy().tolist()))

    for trial in range(3):
        disp = torch.as_tensor(rng.normal(scale=0.02, size=tuple(x.shape)),
                               device=device).to(x.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dense = dict(
            pt=BP.pt_candidates(x, m.surf_verts, m.surf_tris, m.dbc_mask, disp, gap)[0],
            ee=BP.ee_candidates(x, m.surf_edges, m.dbc_mask, disp, gap)[0],
            et=BP.et_candidates(x, m.surf_edges, m.surf_tris, disp, gap, m.dbc_mask)[0])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grid = SH.fused_candidates(x, m.surf_verts, m.surf_edges, m.surf_tris, m.dbc_mask,
                                   disp, gap, with_et=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        sizes = {k: int(dense[k].shape[0]) for k in dense}
        equal = all(as_set(dense[k]) == as_set(grid[k][0]) for k in dense)
        print(f"[broadphase] n_cells=8 float32 swept trial {trial}: pt/ee/et={sizes['pt']}/"
              f"{sizes['ee']}/{sizes['et']} grid==dense as sets: {equal} "
              f"dense_s={t1 - t0:.4f} grid_s={t2 - t1:.4f}")
        check(equal, "grid and dense candidate sets equal on the card")
        check(min(sizes.values()) > 0, "every family has swept candidates")


def phase_contact_path(device):
    import torch

    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.scenes import build_scene

    t0 = time.perf_counter()
    st = build_scene(20, torch.float32, device, with_contact=True)
    step = make_step(st)
    sc = st.sc
    state = st.initial_state()
    torch.cuda.synchronize()
    print(f"[contact] scene n_cells=20 float32 with self-contact: {st.mesh.tets.shape[0]} "
          f"tets, {st.mesh.x_rest.shape[0]} verts, broad phase {sc.broadphase}, setup "
          f"{time.perf_counter() - t0:.2f} s")
    tet_hv.launches = 0
    ops0, syncs0 = step.operator_applications, step.host_syncs
    total, newton = 0.0, 0
    saw_active = saw_fric = False
    post_impact = None
    for i in range(14):
        ops_i, syncs_i = step.operator_applications, step.host_syncs
        t0 = time.perf_counter()
        pre = state
        state, s = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total += wall
        newton += s.newton_iters
        ymin = _check_state(state)
        hit, _ = sc.has_intersection(state.x)
        hit = bool(hit)
        print(f"[contact] step {i}: newton_iters={s.newton_iters} "
              f"pcg_iters_total={s.pcg_iters_total} pt/ee/et={s.pt_count}/{s.ee_count}/"
              f"{s.et_count} active_pt/ee_max={s.active_pt_max}/{s.active_ee_max} "
              f"fric_count={s.fric_count} kappa={s.kappa:.6g} "
              f"kappa_doublings={s.kappa_doublings} "
              f"operator_applications={step.operator_applications - ops_i} "
              f"host_syncs={step.host_syncs - syncs_i} ymin={ymin:.6g} "
              f"intersection={hit} wall_s={wall:.4f}")
        check(not hit, "no edge-triangle intersection after a contact step")
        active = s.active_pt_max + s.active_ee_max > 0
        saw_active |= active
        saw_fric |= s.fric_count > 0
        if active and s.fric_count > 0:
            post_impact = pre
    launches = tet_hv.launches
    ops = step.operator_applications - ops0
    print(f"[contact] 14 steps in {total:.3f} s, {newton} Newton iterations "
          f"({total / max(newton, 1):.4f} s per iteration); tet_hv launches={launches} "
          f"operator applications={ops} host syncs={step.host_syncs - syncs0}")
    check(saw_active, "self-contact pairs became active")
    check(saw_fric, "self-friction pairs were captured")
    check(launches > 0, "tet_hv launched on the contact path")
    check(launches == ops, "one tet_hv launch per operator application (contact)")
    _bitwise_repeat(step, post_impact, "contact")
    return launches


def phase_bench_timing(device):
    import torch

    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.scenes import build_scene

    st = build_scene(8, torch.float32, device, with_contact=True)
    step = make_step(st)
    state = st.initial_state()
    for _ in range(11):  # warm-up + settle into the impact phase
        state, _ = step(state)
    torch.cuda.synchronize()
    n_steps, newton, syncs0 = 20, 0, step.host_syncs
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, s = step(state)
        newton += s.newton_iters
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ymin = _check_state(state)
    hit, _ = st.sc.has_intersection(state.x)
    print(f"[bench] n_cells=8 float32 with contact ({st.mesh.tets.shape[0]} tets), steps "
          f"11-30: {wall / n_steps:.4f} s per step, {wall / max(newton, 1):.4f} s per Newton "
          f"iteration ({newton} iterations, {(step.host_syncs - syncs0) / n_steps:.1f} "
          f"host syncs per step), ymin={ymin:.6g} intersection={bool(hit)}")
    check(not bool(hit), "no intersection in the bench scene")


def phase_contact_reference(device):
    import torch

    from ipc_tpu_torch.convert import state_from_numpy, state_to_numpy
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.scenes import build_scene

    steps = {}
    for dev in ("cpu", device):
        steps[str(dev)] = make_step(build_scene(2, torch.float64, dev, with_contact=True))
    cpu_step, card_step = steps["cpu"], steps[str(device)]
    s = build_scene(2, torch.float64, "cpu", with_contact=True).initial_state()
    for _ in range(8):
        s, _ = cpu_step(s)
    rng = np.random.default_rng(2)
    for i in range(8, 11):
        pre = state_to_numpy(s)
        nxt, ref = cpu_step(s)
        x_ref = nxt.x.numpy()
        # the CPU step's own response to a 1-ulp change of x (two signs)
        sens, flip = 0.0, 0
        for _ in range(2):
            pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                        * np.spacing(np.abs(pre["x"])))
            sp, rp = cpu_step(state_from_numpy(pert, "cpu", torch.float64))
            sens = max(sens, float(np.abs(sp.x.numpy() - x_ref).max()))
            flip = max(flip, abs(rp.pcg_iters_total - ref.pcg_iters_total))
        got, gs = card_step(state_from_numpy(pre, device, torch.float64))
        dx = float(np.abs(got.x.cpu().numpy() - x_ref).max())
        tol = max(1e-9, 2.0 * sens)
        print(f"[contact-ref] n_cells=2 float64 step {i}: card newton/pcg/doublings="
              f"{gs.newton_iters}/{gs.pcg_iters_total}/{gs.kappa_doublings} CPU "
              f"{ref.newton_iters}/{ref.pcg_iters_total}/{ref.kappa_doublings}; active "
              f"pt/ee={gs.active_pt_max}/{gs.active_ee_max} max |dx|={dx:.3e} (CPU 1-ulp "
              f"response {sens:.3e}, limit {tol:.3e}; PCG change {flip})")
        check(gs.newton_iters == ref.newton_iters, "same Newton count as the CPU")
        check(gs.kappa_doublings == ref.kappa_doublings, "same kappa doublings as the CPU")
        check(abs(gs.pcg_iters_total - ref.pcg_iters_total) <= flip,
              "PCG count within the CPU's own 1-ulp change")
        check(dx <= tol, "card agrees with the CPU reference (contact)")
        s = nxt


def main():
    import torch

    phases = []

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phases.append((name, time.perf_counter() - t0))
        print(f"[phase] {name}: {phases[-1][1]:.1f} s", flush=True)
        return out

    device, name = run("device", phase_device)
    run("build", phase_build)
    records = run("kernel_vs_plain", phase_kernel_vs_plain, device)
    run("ground_path", phase_ground_path, device)
    run("ground_reference", phase_ground_reference, device)
    run("broadphase", phase_broadphase, device)
    launches = run("contact_path", phase_contact_path, device)
    run("bench_timing", phase_bench_timing, device)
    run("contact_reference", phase_contact_reference, device)
    print(f"[phase] total {sum(s for _, s in phases):.1f} s")
    r = records[(20, "float32")]  # the main path's shape and dtype
    print(json.dumps({"kernels": [dict(
        name="tet_hv", route="cuda", source="ipc_tpu_torch/csrc/tet_hv.cu",
        replaces="ipc_tpu/ops/pallas_hv.py:107", launches=launches,
        max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"], library_ms=r["library_ms"],
        bound_us=r["bound_us"], share_of_bound=r["share_of_bound"],
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
