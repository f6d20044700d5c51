#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ipc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines with its seconds; any failure raises
and ends the run with a non-zero exit code (nothing is caught):

  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: the CUDA kernels from csrc/ (nvcc, sm_90a) into build/kernels/;
  3. kernel vs plain: tet_hv against its plain PyTorch version on the card
     at the scenes' shapes (the boxes at n_cells 8 and 20: 6,144 and
     96,000 tets; the twist at n = 100: 60,000 tets; float32 and float64), with tolerances 1e-5 (f32) / 1e-12 (f64) x the
     plain result's max |.| and bitwise-equal repeats; device times
     (ipc_tpu_torch/hv_timing.py: CUDA events, median of 20, L2 flushed)
     of the kernel, the plain version and the library yardstick (cuSPARSE
     SpMV through a torch CSR matrix assembled from the same H, which must
     agree within the same tolerance), the assembly's time, the bound
     (bytes at 3.35 TB/s) with the kernel's share of it, and each device
     kernel's time per call (torch.profiler);
  4. ground path: build_scene(n_cells=20, float32, "cuda") -> make_step for
     6 steps (96,000 tets; ground contact and friction, no self-contact).
     Counts are zeroed just before: the Hv kernel must have launched once
     per Newton-operator application. Every state finite, ymin > 0, and
     one step taken twice from one state is bitwise equal;
  5. ground reference: 3 float64 steps at n_cells=2 on the card against
     the same steps on the CPU (the plain path the tests hold to the JAX
     package);
  6. broad phase: at n_cells=8, on 3 seeded swept displacements, the grid
     (spatial hash) and dense PT/EE/ET candidate sets are equal on the card;
  7. contact path, the main path: build_scene(n_cells=20, float32, "cuda",
     with_contact=True) -> make_step for 10 steps, through the boxes'
     impact (about step 8). Per step: iterations, candidate and active
     counts, friction pairs, kappa, host syncs, wall seconds. After every
     step: finite, ymin > 0, no edge-triangle intersection. Over the run:
     active and friction pairs appear, tet_hv launched once per operator
     application (counts zeroed just before), and a post-impact step taken
     twice from one state is bitwise equal;
  8. bench timing: the bench scene (n_cells=8, float32, with contact) as
     bench.py times it, with a shorter window: one warm-up and 10 settling
     steps, then 6 timed steps; seconds per step and per Newton iteration;
  9. contact reference: at n_cells=2 in float64 with contact, the CPU runs
     8 steps, then each of steps 8-10 is taken from the CPU's state on the
     card and on the CPU. Newton and kappa-doubling counts must be equal;
     x within 1e-9, or within twice the CPU step's own response to a 1-ulp
     perturbation of x where that is larger (an ill-conditioned impact
     step), and the PCG count within the count change the same
     perturbation causes (the perturbed steps run only when x or the PCG
     count differ);
 10. twist path, this slice's path: build_twist_scene(100, float32,
     "cuda") (the paper's mat100x100 twist: 60,000 tets, 20,402 vertices,
     self-contact, scripted handles) -> make_step for 25 steps (1.0 s;
     each handle turns 72 degrees). Per step: Newton and PCG iterations,
     candidate and active counts, script_scale, al_iters, kappa, host
     syncs, wall seconds. After every step: finite, no edge-triangle
     intersection, every tet's det F > 0, script_scale == 1. At the end:
     the handle rows equal the exact rotation of their rest positions
     (numpy float64) within 25 x 4 eps(f32) x max|x| plus the Newton
     tolerance, the handles turned, tet_hv launched once per operator
     application (counts zeroed just before), and one step taken twice from
     one state is bitwise equal;
 11. variants reference: small scenes in float64 on the card against the
     CPU, held as phase 9 holds the contact step (same Newton, kappa-
     doubling and AL counts and script_scale; x within max(1e-9, twice the
     CPU's 1-ulp response); PCG within its 1-ulp change): Newmark, FCR,
     damping_stiff 1e-4 and coarse_precond=False (build_scene(2), 3 steps),
     ccd_method="ti" (with contact, steps 8-10 from phase 9's state before
     step 8), the turning-rule cube (8 steps), the two-plane ACO squash (6
     steps), the blocked press (3 steps; the AL must run) and the twist at
     mat(4) (4 steps).

The line before the last is the kernels record (its launches: the contact
and twist paths'), the last line
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

    from ipc_tpu_torch.hv_timing import SCENES, measure

    records = {}
    for scene, n_cells in SCENES:
        for dtype in (torch.float32, torch.float64):
            r = measure(n_cells, dtype, device, scene)
            print(f"[kernel] tet_hv {scene} n={n_cells} tets={r['tets']} verts={r['verts']} "
                  f"D={r['D']} {r['dtype']}: max_abs_err={r['max_abs_err']:.3e} (limit "
                  f"{r['limit']:.3e}) bitwise_repeat={r['bitwise_repeat']} "
                  f"kernel_ms={r['kernel_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
                  f"library_ms={r['library_ms']:.5f} (library_err={r['library_err']:.3e}, "
                  f"nnz={r['nnz']}, assembly_ms={r['assembly_ms']:.3f}) bytes={r['bytes']} "
                  f"bound_us={r['bound_us']:.3f} ({r['bound_by']}) "
                  f"share_of_bound={r['share_of_bound']:.4f} empty_ms={r['empty_ms']:.5f} "
                  f"split_us={json.dumps(r['split_us'])}")
            what = f"tet_hv {r['dtype']} {scene} n={n_cells}"
            check(r["max_abs_err"] <= r["limit"], f"{what} within tolerance")
            check(r["bitwise_repeat"], f"{what} bitwise repeatable")
            check(r["library_err"] <= r["limit"], f"{what}: the yardstick computes the same map")
            records[(scene, n_cells, r["dtype"])] = r
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
    for i in range(6):
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
    print(f"[ground] 6 steps in {total:.3f} s; tet_hv launches={launches} "
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
    for i in range(10):
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
    print(f"[contact] 10 steps in {total:.3f} s, {newton} Newton iterations "
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
    n_steps, newton, syncs0 = 6, 0, step.host_syncs
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, s = step(state)
        newton += s.newton_iters
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ymin = _check_state(state)
    hit, _ = st.sc.has_intersection(state.x)
    print(f"[bench] n_cells=8 float32 with contact ({st.mesh.tets.shape[0]} tets), steps "
          f"11-{10 + n_steps}: {wall / n_steps:.4f} s per step, "
          f"{wall / max(newton, 1):.4f} s per Newton "
          f"iteration ({newton} iterations, {(step.host_syncs - syncs0) / n_steps:.1f} "
          f"host syncs per step), ymin={ymin:.6g} intersection={bool(hit)}")
    check(not bool(hit), "no intersection in the bench scene")


def phase_contact_reference(device):
    """Steps 8-10 of the contact scene, card against CPU (_hold). Returns
    the CPU's state before step 8 (numpy), which the variants reference
    reuses."""
    import torch

    from ipc_tpu_torch.convert import state_to_numpy
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.scenes import build_scene

    cpu_st = build_scene(2, torch.float64, "cpu", with_contact=True)
    cpu_step = make_step(cpu_st)
    card_step = make_step(build_scene(2, torch.float64, device, with_contact=True))
    s = cpu_st.initial_state()
    for _ in range(8):
        s, _ = cpu_step(s)
    lead = state_to_numpy(s)
    rng = np.random.default_rng(2)
    for i in range(8, 11):
        s, gs = _hold(f"contact-ref n_cells=2 float64 step {i}", cpu_step, card_step,
                      state_to_numpy(s), rng, device)
        print(f"[contact-ref] step {i}: active pt/ee={gs.active_pt_max}/{gs.active_ee_max}")
    return lead


def _min_det(mesh, x):
    """Least det of the tets' edge matrices at x (float64): > 0 iff no tet
    is inverted (det F = det(Ds) det(Dm^-1), and det(Dm^-1) > 0)."""
    import torch

    X = x.to(torch.float64)[mesh.tets]
    Ds = (X[:, 1:] - X[:, :1]).transpose(1, 2)
    return torch.linalg.det(Ds).min().item()


def _rotation(axis, angle):
    axis = np.asarray(axis, float) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def phase_twist_path(device, n=100, n_steps=25):
    import torch

    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.models.primitives import mat
    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.scenes import build_twist_scene

    t0 = time.perf_counter()
    st = build_twist_scene(n, torch.float32, device)
    step = make_step(st)
    sc = st.sc
    state = st.initial_state()
    torch.cuda.synchronize()
    print(f"[twist] scene mat({n}) float32: {st.mesh.tets.shape[0]} tets, "
          f"{st.mesh.x_rest.shape[0]} verts, {st.mesh.surf_tris.shape[0]} surface triangles, "
          f"{int(st.mesh.dbc_mask.sum())} handle verts, broad phase {sc.broadphase}, setup "
          f"{time.perf_counter() - t0:.2f} s")
    tet_hv.launches = 0
    ops0, syncs0 = step.operator_applications, step.host_syncs
    total, newton, pcg = 0.0, 0, 0
    pre = state
    for i in range(n_steps):
        ops_i, syncs_i = step.operator_applications, step.host_syncs
        t0 = time.perf_counter()
        pre = state
        state, s = step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total += wall
        newton += s.newton_iters
        pcg += s.pcg_iters_total
        for t in (state.x, state.v):
            check(bool(torch.isfinite(t).all()), "finite state (twist)")
        hit = bool(sc.has_intersection(state.x)[0])
        det = _min_det(st.mesh, state.x)
        print(f"[twist] step {i}: newton_iters={s.newton_iters} "
              f"pcg_iters_total={s.pcg_iters_total} pt/ee/et={s.pt_count}/{s.ee_count}/"
              f"{s.et_count} active_pt/ee_max={s.active_pt_max}/{s.active_ee_max} "
              f"script_scale={s.script_scale} al_iters={s.al_iters} kappa={s.kappa:.6g} "
              f"kappa_doublings={s.kappa_doublings} "
              f"operator_applications={step.operator_applications - ops_i} "
              f"host_syncs={step.host_syncs - syncs_i} min_det={det:.4e} intersection={hit} "
              f"wall_s={wall:.4f}", flush=True)
        check(not hit, "no edge-triangle intersection after a twist step")
        check(det > 0.0, "no inverted tet after a twist step")
        check(s.script_scale == 1.0, "the scripted handle motion completes")
    launches = tet_hv.launches
    ops = step.operator_applications - ops0
    syncs = step.host_syncs - syncs0
    print(f"[twist] {n_steps} steps in {total:.3f} s ({total / n_steps:.4f} s per step), "
          f"{newton} Newton iterations ({total / max(newton, 1):.4f} s per iteration), {pcg} "
          f"PCG iterations; tet_hv launches={launches} operator applications={ops} host "
          f"syncs={syncs} ({syncs / n_steps:.1f} per step)")
    check(launches > 0, "tet_hv launched on the twist path")
    check(launches == ops, "one tet_hv launch per operator application (twist)")
    # the handles against the exact rotation of their rest positions
    V, _ = mat(n, size=1.0)
    x = state.x.double().cpu().numpy()
    t_end = state.t
    tol = n_steps * 4 * float(np.finfo(np.float32).eps) * float(np.abs(x).max()) + st.target_gres
    for hi, h in enumerate(st.script.handles):
        R = _rotation(h.axis, h.ang_vel * t_end)
        want = (V[h.verts] - h.center) @ R.T + h.center
        err = float(np.abs(x[h.verts] - want).max())
        turned = float(np.abs(x[h.verts] - V[h.verts]).max())
        print(f"[twist] handle {hi}: {len(h.verts)} verts, {np.degrees(h.ang_vel * t_end):.2f} "
              f"degrees; max |x - exact rotation|={err:.3e} (limit {tol:.3e}), moved "
              f"{turned:.4f}")
        check(err <= tol, "handle rows follow the exact rotation")
        check(turned > 1e-3, "the handles turned")
    _bitwise_repeat(step, pre, "twist")
    return launches


def _hold(tag, cpu_step, card_step, pre, rng, device):
    """One step from the numpy state `pre` on the CPU and on the card (both
    float64): counts equal, script_scale and al_iters equal, x within
    max(1e-9, twice the CPU step's response to a 1-ulp change of x), PCG
    within the count change that change causes (the response is the larger
    of two random sign patterns, measured only when x or the PCG count
    differ). Returns (CPU state, card stats)."""
    import torch

    from ipc_tpu_torch.convert import state_from_numpy

    nxt, ref = cpu_step(state_from_numpy(pre, "cpu", torch.float64))
    got, gs = card_step(state_from_numpy(pre, device, torch.float64))
    x_ref = nxt.x.numpy()
    dx = float(np.abs(got.x.cpu().numpy() - x_ref).max())
    sens, flip = 0.0, 0
    for _ in range(2 if dx > 1e-9 or gs.pcg_iters_total != ref.pcg_iters_total else 0):
        pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                    * np.spacing(np.abs(pre["x"])))
        sp, rp = cpu_step(state_from_numpy(pert, "cpu", torch.float64))
        sens = max(sens, float(np.abs(sp.x.numpy() - x_ref).max()))
        flip = max(flip, abs(rp.pcg_iters_total - ref.pcg_iters_total))
    tol = max(1e-9, 2.0 * sens)
    print(f"[{tag}]: card newton/pcg/doublings/al/scale={gs.newton_iters}/"
          f"{gs.pcg_iters_total}/{gs.kappa_doublings}/{gs.al_iters}/{gs.script_scale:.6g} CPU "
          f"{ref.newton_iters}/{ref.pcg_iters_total}/{ref.kappa_doublings}/{ref.al_iters}/"
          f"{ref.script_scale:.6g}; max |dx|={dx:.3e} (limit {tol:.3e}; PCG change {flip})")
    check(gs.newton_iters == ref.newton_iters, f"{tag}: same Newton count as the CPU")
    check(gs.kappa_doublings == ref.kappa_doublings, f"{tag}: same kappa doublings")
    check(gs.al_iters == ref.al_iters, f"{tag}: same AL iterations")
    check(gs.script_scale == ref.script_scale, f"{tag}: same script_scale")
    check(abs(gs.pcg_iters_total - ref.pcg_iters_total) <= flip,
          f"{tag}: PCG count within the CPU's own 1-ulp change")
    check(dx <= tol, f"{tag}: card agrees with the CPU reference")
    return nxt, gs


def _variant_scenes():
    """{name: (stepper factory on a device, steps compared, starts from the
    contact scene's state before step 8)} of the variants reference."""
    import torch

    from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
    from ipc_tpu_torch.contact.pipeline import SelfContact
    from ipc_tpu_torch.mesh import build_mesh, merge_meshes
    from ipc_tpu_torch.models.primitives import cube
    from ipc_tpu_torch.scenes import build_scene, build_twist_scene
    from ipc_tpu_torch.scripting import DBCGroup, Script, TurningRule
    from ipc_tpu_torch.timestepper import IPCStepper, SimParams

    f64 = torch.float64

    def boxes(**params):
        def make(dev):
            st = build_scene(2, f64, dev)
            return IPCStepper(st.mesh, st.meta, SimParams(**params), halfspaces=st.halfspaces)
        return make

    def ti(dev):
        st = build_scene(2, f64, dev, with_contact=True)
        sc = SelfContact(st.mesh, st.meta, friction=0.1, ccd_method="ti")
        return IPCStepper(st.mesh, st.meta, st.p, halfspaces=st.halfspaces, self_contact=sc)

    def turning(dev):
        V, T = cube(1)
        top = np.where(V[:, 1] > 0.999)[0]
        tp = int(top[0])
        script = Script(n_verts=len(V), dbc_groups=[DBCGroup(top, np.array([0.0, -1.0, 0.0]))],
                        turning=[TurningRule(vert=tp, axis=1, lo=V[tp, 1] - 0.1,
                                             hi=V[tp, 1] + 10.0, action="flip_band",
                                             group_ids=(0,))])
        mesh, meta = build_mesh(V, T, dbc_mask=script.dbc_mask(), dtype=f64, device=dev)
        return IPCStepper(mesh, meta, SimParams(gravity=(0, 0, 0)), script=script)

    def aco(dev):
        V, T = cube(1)
        script = Script(n_verts=len(V), aco_kind="squash",
                        aco_vel=np.array([[1.0, 0, 0], [-1.0, 0, 0]]))
        planes = [HalfSpaceParams(origin=(-0.3, 0.0, 0.0), normal=(1.0, 0.0, 0.0)),
                  HalfSpaceParams(origin=(1.3, 0.0, 0.0), normal=(-1.0, 0.0, 0.0))]
        mesh, meta = build_mesh(V, T, dtype=f64, device=dev)
        return IPCStepper(mesh, meta, SimParams(gravity=(0, 0, 0)),
                          halfspaces=[HalfSpace(q) for q in planes], script=script)

    def press(dev):
        V1, T1 = cube(1)
        V2, T2 = cube(1)
        V, T, comp, ranges = merge_meshes([(V1 + np.array([0.0, 0.002, 0.0]), T1),
                                           (V2 + np.array([0.0, 1.006, 0.0]), T2)])
        script = Script(n_verts=len(V), dbc_groups=[
            DBCGroup(np.arange(len(V1), len(V)), np.array([0.0, -2.0, 0.0]))])
        mesh, meta = build_mesh(V, T, vert_comp=comp, comp_ranges=ranges,
                                dbc_mask=script.dbc_mask(), dtype=f64, device=dev)
        return IPCStepper(mesh, meta, SimParams(), halfspaces=[HalfSpace(HalfSpaceParams())],
                          self_contact=SelfContact(mesh, meta, friction=0.0), script=script)

    return {
        "newmark": (boxes(time_integration="NM"), 3, False),
        "fcr": (boxes(model="FCR"), 3, False),
        "damping": (boxes(damping_stiff=1e-4), 3, False),
        "no_coarse": (boxes(coarse_precond=False), 3, False),
        "ccd_ti": (ti, 3, True),
        "turning": (turning, 8, False),
        "aco_squash": (aco, 6, False),
        "blocked_press": (press, 3, False),
        "twist_mat4": (lambda dev: build_twist_scene(4, f64, dev), 4, False),
    }


def phase_variants_reference(device, contact_lead):
    import torch
    from dataclasses import replace

    from ipc_tpu_torch.convert import state_from_numpy, state_to_numpy
    from ipc_tpu_torch.jit_step import initial_device_aux, make_step

    rng = np.random.default_rng(4)
    for name, (make, n_steps, from_contact) in _variant_scenes().items():
        t0 = time.perf_counter()
        cpu_st = make("cpu")
        cpu_step, card_step = make_step(cpu_st), make_step(make(device))
        s = replace(cpu_st.initial_state(), aux=initial_device_aux(cpu_st))
        first = 0
        if from_contact:
            s, first = state_from_numpy(contact_lead, "cpu", torch.float64), 8
        al_total = 0
        for i in range(first, first + n_steps):
            s, gs = _hold(f"variants {name} step {i}", cpu_step, card_step,
                          state_to_numpy(s), rng, device)
            al_total += gs.al_iters
        print(f"[variants] {name}: {n_steps} steps held, {time.perf_counter() - t0:.1f} s")
        if name == "blocked_press":
            check(al_total > 0, "the blocked press ran the moving-DBC AL")


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
    contact_lead = run("contact_reference", phase_contact_reference, device)
    launches += run("twist_path", phase_twist_path, device)
    run("variants_reference", phase_variants_reference, device, contact_lead)
    print(f"[phase] total {sum(s for _, s in phases):.1f} s")
    r = records[("boxes", 20, "float32")]  # the contact path's shape and dtype
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
