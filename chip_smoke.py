#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ipc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines with its seconds; any failure raises
and ends the run with a non-zero exit code (nothing is caught):

  1. device: the card's name and `nvidia-smi` name / power limit;
  2. build: the CUDA kernels from csrc/ (nvcc, sm_90a) into build/kernels/;
  3. kernel vs plain: tet_hv against its plain PyTorch version on the card
     at the scenes' shapes (the boxes at n_cells 8 and 20: 6,144 and
     96,000 tets; the twist at n = 100: 60,000 tets; the driver scene: the
     boxes at 20 plus the plate's 4 tet-less vertices, whose rows must be
     exact zeros; the shard of a 2-rank sharded step: rank 0's 48,000
     tets of the boxes at 20 over the padded mesh's 18,524 vertices, the
     rows its tets do not touch exact zeros; float32 and float64), with tolerances 1e-5 (f32) / 1e-12 (f64) x the
     plain result's max |.| and bitwise-equal repeats; device times
     (ipc_tpu_torch/hv_timing.py: CUDA events, median of 20, L2 flushed)
     of the kernel, the plain version and the library yardstick (cuSPARSE
     SpMV through a torch CSR matrix assembled from the same H, which must
     agree within the same tolerance), the assembly's time, the bound
     (bytes at 3.35 TB/s) with the kernel's share of it, and each device
     kernel's time per call (torch.profiler). Then ACCD (csrc/accd.cu)
     against its plain version `_accd` on the card
     (ipc_tpu_torch/accd_timing.py): the largest point-triangle and
     edge-edge candidate sets of one device step of the twist (n = 100,
     step 0) and of the landing (the boxes at 20, step 8), float32 and
     float64, every stencil's safe step equal bit for bit (within 1e-5
     (f32) / 1e-12 (f64) besides) and its live passes equal; over each step kernel launches == ACCD calls; the
     kernel's and the plain version's device time per call and the bound
     (stencils read once and t written once, at 3.35 TB/s). Then the grid
     broad phase's walk kernel (csrc/grid_pairs.cu) against its plain
     version `_run_plain` on the card (ipc_tpu_torch/grid_timing.py): the
     largest grid call of one device step of the twist (n = 100, step 0)
     and of the landing (step 8), float32 and float64, every family's
     pair array equal element for element; over each step
     broadphase.kernel_calls == broadphase.calls, one launch (the count
     pass) per family of each call and one more (the write pass) per
     family that keeps a grid pair, and one host read per call;
     the walk's device time, the whole call's wall time through the
     kernel and through the plain version, and the bytes read once;
  4. ground path: build_scene(n_cells=20, float32, "cuda") -> make_step for
     3 steps (96,000 tets; ground contact and friction, no self-contact).
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
     8 steps, then each of steps 8-9 is taken from the CPU's state on the
     card and on the CPU. Newton and kappa-doubling counts must be equal;
     x within 1e-9, or within twice the CPU step's own response to a 1-ulp
     perturbation of x where that is larger (an ill-conditioned impact
     step), and the PCG count within the count change the same
     perturbation causes (the perturbed steps run only when x or the PCG
     count differ);
 10. twist path: build_twist_scene(100, float32,
     "cuda") (the paper's mat100x100 twist: 60,000 tets, 20,402 vertices,
     self-contact, scripted handles) -> make_step for 12 steps (0.48 s;
     each handle turns 34.56 degrees). Per step: Newton and PCG iterations,
     candidate and active counts, script_scale, al_iters, kappa, host
     syncs, wall seconds. After every step: finite, no edge-triangle
     intersection, every tet's det F > 0, script_scale == 1. At the end:
     the handle rows equal the exact rotation of their rest positions
     (numpy float64) within 12 x 4 eps(f32) x max|x| plus the Newton
     tolerance, the handles turned, tet_hv launched once per operator
     application (counts zeroed just before), and one step taken twice from
     one state is bitwise equal;
 11. variants reference: small scenes in float64 on the card against the
     CPU, held as phase 9 holds the contact step (same Newton, kappa-
     doubling and AL counts and script_scale; x within max(1e-9, twice the
     CPU's 1-ulp response); PCG within its 1-ulp change): Newmark, FCR,
     damping_stiff 1e-4 and coarse_precond=False (build_scene(2), 3 steps),
     ccd_method="ti" (with contact, step 8 from phase 9's state before
     it), the turning-rule cube (8 steps), the two-plane ACO squash (6
     steps), the blocked press (2 steps; the AL must run), the twist at
     mat(4) (4 steps) and a box_grid(3) cube on a two-triangle kinematic
     plate (3 steps; grid broad phase with the dense sweep of the plate's
     oversized primitives, selfFric 0 and plate mu 0.2);
 12. driver path: a scene file run through the port's
     CLI entry point (ipc_tpu_torch.__main__.main, in this process):
     two box_grid(20) boxes written as .msh files (96,000 tets), NH, BE,
     dt 0.025, selfCollisionOn, selfFric 0.1, no ground but a meshCO
     plate (two triangles, 4 wide, friction 0.2; its primitives are
     oversized, so the grid takes the dense big sweep), `-n 10 --f32
     --jit-step --save-every 5`. Reads the artifacts: every one written,
     one iterStats line per Newton iteration, saved states finite, the
     lower box above the plate, no edge-triangle intersection at the end,
     the plate bitwise at its placement, friction pairs against the
     plate, tet_hv launched once per operator application (counts zeroed
     just before). Then a second scene file restarts from status5.npz in
     a fresh Simulation and runs steps 5-9: its status10.npz must equal
     the first run's bitwise;
 13. host path: the same scene file through the same
     CLI entry point without --jit-step, so the host-path stepper
     (IPCStepper.step: a fresh broad phase every Newton iteration, the
     host line search, the global intersection test) runs it: `-n 10
     --f32 --save-every 5`. Per step: Newton (search directions), line
     searches, PCG iterations, kappa doublings, intersection backtracks,
     sweep clamps, operator applications, host syncs, wall seconds; after
     every step (outside its time): finite, no edge-triangle intersection,
     the lower box above the plate. Over the run: tet_hv launched once per
     operator application (counts zeroed just before), info.txt's host
     syncs equal the steps', iterStats.txt one line per line-searched
     iteration, status10.npz finite with the plate in place, and one step
     taken twice from status5.npz in a fresh Simulation bitwise equal;
 14. host reference: host steps in float64 on the card against the CPU,
     each from the CPU's state (held as phase 9 holds a device step: every
     count, intersection backtracks and sweep clamps too, equal or within
     the CPU's own 1-ulp change, and the planes compared; the blocked
     press's AL step is such an ill-conditioned one): a cube dropping
     onto the ground (3 steps), the
     n_cells=2 boxes' step 8 from the device step's state before it (as
     phase 9's), warm_start=5
     (1), linsys "dense" and "sparse" (1 each), the fricDHat homotopy
     (fric_dhat0_rel 4x its target, 2), the ACO squashshear planes (3) and
     the blocked press through the moving-DBC AL (2). The CPU's steps and
     their 1-ulp responses run in two single-threaded worker processes
     started after phase 2; the card's steps run in a child process on the
     same card beside phases 5, 9 and 11. Both are stopped when the run
     ends;
 15. QP path: the QP/SQP comparison stepper at full width,
     QPStepper(mode="SQP", constraint_type="graphics") on the contact
     path's boxes (96,000 tets, the ground half-space and self-contact)
     from that phase's state after step 7, for 2 steps through the
     landing (steps 8-9). Per step: SQP iterations, the ADMM iteration
     list, active constraints, PCG iterations, tet_hv launches, operator
     applications, host syncs, wall seconds, and whether the edge-triangle
     test finds an intersection (the QP methods do not exclude one, so it
     is printed, not checked). Checked per step: finite, ymin > -0.05,
     the upper box's lowest vertex above the lower box's midplane, tet_hv
     launches equal to operator applications; then the last step taken
     again from the same state must be bitwise equal, and over its second
     ADMM call (active rows, its three CUDA graphs captured and replayed)
     the tet_hv calls the card ran (the kernel's own device counter)
     equal tet_hv.launches and the operator applications counted;
 16. QP reference: the QP stepper in float64, card against CPU from the
     CPU's state before each step (counts equal or the CPU's own under a
     1-ulp change of x, x within max(1e-9, twice its 1-ulp response)): a
     cube dropping onto the ground under SQP / graphics (2 steps), two
     stacked cubes in contact range under SQP / Verschoor and QP / volume
     (2 each), and a scene file with constraintSolver SQP through the CLI
     entry point on both (3 steps: iterStats.txt counts equal, status3
     x within 1e-9);
 17. diagnostic: `python -m ipc_tpu_torch.diagnostic all` on the card:
     every mode passes, the dtype modes in float64 and float32;
 18. sharded path: the contact path's boxes (96,000 tets, float32) split
     over 2 ranks (ipc_tpu_torch.parallel.launch of _sharded_job), from
     that phase's state after step 7, saved in build/sharded_path/, through
     steps 8-9, the landing. The backend is NCCL with one card per rank
     when the machine has two cards, else gloo with both ranks on card 0
     (NCCL refuses two ranks on one card). Printed: the backend, each
     rank's shard bytes (what is split, what replicated), per step the
     Newton and PCG iterations, the collectives, each rank's own
     candidate and active counts, wall seconds. Checked after every step
     on every rank: finite, ymin > 0, no edge-triangle intersection.
     Across the ranks: x bitwise equal; the union of the ranks' candidate
     pairs at step 8's start equals the single-rank fused_candidates set
     on the same padded x, each pair on one rank; each rank's tet_hv
     launches equal its operator applications; step 9 taken twice from
     one state bitwise equal. A rank that fails or dies fails the phase;
 19. sharded reference: the n_cells=2 boxes' steps 8-9 in float64 on the
     card, each step from the CPU's state before it. On 2 gloo ranks,
     held as phase 9 holds a contact step against the CPU's unsharded
     make_step over the same padded mesh (the 1-ulp response the largest
     of six random sign patterns, where phase 9 takes two: at the padded
     step 8 it ranges 7.6e-9 to 2.8e-8 over six on the CPU, so two can
     fall an order below it), the ranks bitwise equal. On a 1-rank NCCL
     group at the same time: x and stats bitwise equal to the card's own
     unsharded make_step over the padded mesh (a sum over one rank is the
     identity). The CPU side runs in a worker process of the host
     reference's pool, beside the timed phases;
 20. battery path: the port's paper battery (ipc_tpu_torch/tools/) on
     scene files written into build/battery/ (ipc_tpu_torch/tools/
     twist_scenes.py: scenes/matTwist20.txt's settings over a .msh of
     models/primitives.mat(n)). Timed, in this process, at full width:
     matTwist100.txt (60,000 tets, the paper's mat100x100 twist) through
     paper_battery.run_one in float32 on the device step for 4 steps; its
     record must be PASS (finite, every det > 0, no edge-triangle
     intersection at the end) with tet_hv launched once per operator
     application (counts zeroed just before); printed: the record, seconds
     per step, Newton iterations, peak device memory above what was
     allocated when run_one began. Untimed, in a child
     process beside the references: the parent sweep (paper_battery.main,
     one child process per scene, float32, 4 steps, budget 60 s + headroom
     30 s) over build/battery/sweep/: matTwist20.txt must be PASS on the
     device step, matTwist225.txt (its mesh absent) SKIP, and
     meshSeqStall.txt TIMEOUT (its mesh sequence's frame 2 is a pipe no
     one writes, so step 2 blocks until the kill on any host); then
     battery_summary and gen_status_battery --status build/battery/STATUS.md
     on the sweep's JSON (the tally printed), and batch over matTwist20.txt
     (--f32 --jit-step, 2 steps), which must exit 0 and write its
     artifacts.

Order: the timed phases 1-4, 6-8, 10, 12, 13, 15, 18 and 20's run_one run
first, alone on the card; then the references 5, 9 and 11, with 20's sweep
in one child process, 14 in another and 16, 17 and 19 in a third beside
them.

The line before the last is the kernels record: tet_hv, accd (the
ACCD wrappers' launches summed) and grid_pairs, each with its launches over
the contact, twist, driver, host, QP, sharded and battery paths (counts
zeroed before each path; the sharded one summed over its ranks; repeats
and restarts not counted; every path must launch all three), tet_hv timed
at the driver shape, accd at the landing's candidate sets in float32 (its
ms, plain_ms and bound_ms the two families' sum, its n per family),
grid_pairs at the landing's largest grid call in float32 (ms the walk's
device time, call_ms and plain_ms the whole call's through the kernel and
the plain version, rows walked and pairs kept), the last line
{"ok": true, "device": {...}}. Without a CUDA device the run fails in
phase 1 and prints neither.

`python3 chip_smoke.py --only qp_path,qp_reference,diagnostic` runs the
device and build phases and the phases named (a check of a few phases;
its kernels line counts only their launches and times tet_hv at the
driver shape, ACCD at the landing's candidate sets and the grid walk at
its largest grid call alone; qp_path alone first runs the contact scene's 8
device steps to reach its start; battery_path runs its run_one and its
sweep).
"""

import json
import subprocess
import time

import numpy as np


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _zero_launches():
    """tet_hv's, the ACCD wrappers' and the grid walk's launch counts set to
    0 before a path."""
    from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt
    from ipc_tpu_torch.contact.spatial_hash import grid_pairs
    from ipc_tpu_torch.ops.tet_hv import tet_hv

    tet_hv.launches = accd_pt.launches = accd_ee.launches = grid_pairs.launches = 0


def _kernel_counts():
    """(accd_pt's, accd_ee's, grid_pairs') launches: one per ccd_alpha call
    and family; one or two per grid call and family (count and write passes)."""
    from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt
    from ipc_tpu_torch.contact.spatial_hash import grid_pairs

    return accd_pt.launches, accd_ee.launches, grid_pairs.launches


def _restore_kernel_counts(counts):
    """Puts _kernel_counts() back after a repeat, which is not a main-path run."""
    from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt
    from ipc_tpu_torch.contact.spatial_hash import grid_pairs

    accd_pt.launches, accd_ee.launches, grid_pairs.launches = counts


def _path_launches(tag, hv, accd_pt, accd_ee, grid):
    """{"tet_hv": hv, "accd": accd_pt + accd_ee, "grid_pairs": grid} of one
    path, ACCD and the grid walk checked to have run."""
    accd = accd_pt + accd_ee
    print(f"[{tag}] accd launches={accd} grid_pairs launches={grid}", flush=True)
    check(accd > 0, f"ACCD launched on the {tag} path")
    check(grid > 0, f"the grid walk kernel launched on the {tag} path")
    return {"tet_hv": hv, "accd": accd, "grid_pairs": grid}


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
                  f"split_us={json.dumps(r['split_us'])} tetless_zero={r['tetless_zero']}")
            what = f"tet_hv {r['dtype']} {scene} n={n_cells}"
            check(r["max_abs_err"] <= r["limit"], f"{what} within tolerance")
            check(r["bitwise_repeat"], f"{what} bitwise repeatable")
            check(r["library_err"] <= r["limit"], f"{what}: the yardstick computes the same map")
            check(r["tetless_zero"] in (None, True), f"{what}: tet-less rows are exact zeros")
            records[(scene, n_cells, r["dtype"])] = r
    return records, accd_vs_plain(device, ("twist", "boxes")), grid_vs_plain(
        device, ("twist100", "boxes"))


ACCD_LIMIT = {"float32": 1e-5, "float64": 1e-12}


def accd_vs_plain(device, scenes):
    """ACCD's kernel against its plain version on the card (module
    docstring, phase 3) on the candidate sets of `scenes`
    (accd_timing.SCENES). Returns {(scene, family, dtype): record of
    accd_timing.measure}."""
    import torch

    from ipc_tpu_torch.accd_timing import measure, scene_calls

    records = {}
    for scene in scenes:
        kept, counters = scene_calls(scene, device)
        print(f"[kernel] accd {scene} step counters: {json.dumps(counters)}")
        check(counters["ccd.kernel_calls"] == counters["ccd.calls"] == counters["launches"] > 0,
              f"accd {scene}: one kernel launch per ACCD call")
        check(set(kept) == {"pt", "ee"}, f"accd {scene}: both families have candidates")
        for kind, (x4, p4) in sorted(kept.items()):
            for dtype in (torch.float32, torch.float64):
                r = measure(kind, x4.to(dtype), p4.to(dtype))
                name = str(dtype).replace("torch.", "")
                print(f"[kernel] accd_{kind} {scene} {name}: n={r['n']} max_abs_diff="
                      f"{r['max_abs_diff']:.3e} (limit {ACCD_LIMIT[name]:.0e}) bit_equal="
                      f"{r['bit_equal']:.6f} live_equal={r['live_equal']:.6f} "
                      f"live_pair_passes={r['live_pair_passes']} live_passes={r['live_passes']} "
                      f"kernel_ms={r['kernel_ms']:.5f} plain_ms={r['plain_ms']:.5f} "
                      f"bytes={r['bytes']} bound_us={r['bound_us']:.3f} "
                      f"share_of_bound={r['share_of_bound']:.4f}", flush=True)
                what = f"accd_{kind} {name} {scene}"
                check(r["max_abs_diff"] <= ACCD_LIMIT[name], f"{what} within tolerance")
                check(r["live_equal"] == 1.0, f"{what}: every stencil's live passes equal")
                check(r["bit_equal"] == 1.0, f"{what}: every safe step bit for bit")
                records[(scene, kind, name)] = r
    return records


def grid_vs_plain(device, scenes):
    """The grid walk kernel against its plain version on the card (module
    docstring, phase 3) on the largest grid call of one device step of each
    of `scenes` (grid_timing.SCENES). Returns {(scene, dtype): record of
    grid_timing.measure}."""
    import torch

    from ipc_tpu_torch.grid_timing import largest, launches_of, measure, parts, scene_calls

    records = {}
    for scene in scenes:
        calls, counters = scene_calls(scene, device)
        families = sum(len(parts(c)[0]) for c in calls)
        print(f"[kernel] grid_pairs {scene} step: {len(calls)} grid calls, {families} "
              f"families, counters {json.dumps(counters)}")
        check(counters["broadphase.kernel_calls"] == counters["broadphase.calls"] == len(calls)
              > 0, f"grid_pairs {scene}: every grid call ran the kernel")
        check(counters["launches"] == launches_of(calls),
              f"grid_pairs {scene}: a count pass per family, a write pass per family that "
              f"keeps a pair")
        check(counters["reads"] == {"broadphase.counts": len(calls)},
              f"grid_pairs {scene}: one host read per grid call")
        call = largest(calls)
        for dtype in (torch.float32, torch.float64):
            r = measure(call, dtype)
            name = str(dtype).replace("torch.", "")
            print(f"[kernel] grid_pairs {scene} {name}: rows={r['rows']} kept={r['kept']} "
                  f"equal={r['equal']} walk_ms={r['walk_ms']:.5f} call_ms={r['call_ms']:.3f} "
                  f"plain_ms={r['plain_ms']:.3f} bytes={r['bytes']} "
                  f"bound_us={r['bound_us']:.3f} row_bytes={r['row_bytes']}", flush=True)
            check(r["equal"], f"grid_pairs {name} {scene}: the plain version's pairs, "
                              f"element for element")
            records[(scene, name)] = r
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
    for i in range(3):
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
    print(f"[ground] 3 steps in {total:.3f} s; tet_hv launches={launches} "
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
    _zero_launches()
    ops0, syncs0 = step.operator_applications, step.host_syncs
    total, newton = 0.0, 0
    saw_active = saw_fric = False
    post_impact = qp_lead = None
    for i in range(10):
        ops_i, syncs_i = step.operator_applications, step.host_syncs
        t0 = time.perf_counter()
        pre = state
        if i == 8:
            qp_lead = pre  # after step 7, before the upper box lands
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
    counts = _path_launches("contact", launches, *_kernel_counts())
    _bitwise_repeat(step, post_impact, "contact")
    return counts, (st, qp_lead)


def _qp_lead(device):
    """The contact path's scene and its state after step 7 (8 device
    steps), for a run whose contact path phase was not asked for."""
    import torch

    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.scenes import build_scene

    st = build_scene(20, torch.float32, device, with_contact=True)
    step = make_step(st)
    state = st.initial_state()
    for _ in range(8):
        state, _ = step(state)
    return st, state


def phase_qp_path(device, lead, n_steps=2):
    """The QP/SQP comparison path at full width (module docstring, phase
    15): the contact path's boxes (96,000 tets, ground half-space and
    self-contact) from its state after step 7, through
    QPStepper(mode="SQP", constraint_type="graphics") for n_steps steps.
    Returns the run's tet_hv and ACCD launches (the repeat's not counted)."""
    import torch

    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.qp import stepper as qp_stepper
    from ipc_tpu_torch.qp.admm import admm_qp
    from ipc_tpu_torch.qp.stepper import QPStepper

    st, state = lead if lead is not None else _qp_lead(device)
    q = QPStepper(st.mesh, st.meta, st.p, halfspaces=st.halfspaces, self_contact=st.sc,
                  mode="SQP", constraint_type="graphics")
    n_lower = st.mesh.x_rest.shape[0] // 2
    mid = 0.5 * (st.mesh.x_rest[:n_lower, 1].min() + st.mesh.x_rest[:n_lower, 1].max()).item()
    _sync(device)
    _zero_launches()
    ops0 = q.operator_applications
    total, repeat = 0.0, None
    for i in range(n_steps):
        ops_i, syncs_i, pcg_i, hv_i = (q.operator_applications, q.host_syncs,
                                       q.pcg_iterations, tet_hv.launches)
        t0 = time.perf_counter()
        nxt, qs = q.step(state)
        _sync(device)
        wall = time.perf_counter() - t0
        total += wall
        for t in (nxt.x, nxt.v):
            check(bool(torch.isfinite(t).all()), "finite state (QP path)")
        ymin = nxt.x[:, 1].min().item()
        upper = nxt.x[n_lower:, 1].min().item()
        hit = bool(st.sc.has_intersection(nxt.x)[0])
        ops, hv = q.operator_applications - ops_i, tet_hv.launches - hv_i
        print(f"[qp] step {8 + i}: sqp_iters={qs.iters} admm_iters={qs.pcg_iters} "
              f"active={qs.n_constraints[-1]} pcg_iters={q.pcg_iterations - pcg_i} "
              f"tet_hv_launches={hv} operator_applications={ops} "
              f"host_syncs={q.host_syncs - syncs_i} ymin={ymin:.6g} "
              f"upper_min={upper:.6g} (midplane {mid:.6g}) intersection={hit} "
              f"wall_s={wall:.4f}", flush=True)
        check(ymin > -0.05, "QP path: ymin > -0.05")
        check(upper > mid, "QP path: the upper box stays above the lower box's midplane")
        check(hv == ops, "one tet_hv launch per operator application (QP path)")
        repeat = (state, nxt)
        state = nxt
    launches, kernels = tet_hv.launches, _kernel_counts()
    check(launches == q.operator_applications - ops0 > 0, "tet_hv launched on the QP path")
    print(f"[qp] {n_steps} steps in {total:.3f} s ({total / n_steps:.4f} s per step); "
          f"tet_hv launches={launches}", flush=True)
    pre, first = repeat  # the last step, the cheaper one after the landing
    traced = {}
    qp_stepper.admm_qp = _traced_second_call(admm_qp, q, traced)
    try:
        again, _ = q.step(pre)
    finally:
        qp_stepper.admm_qp = admm_qp
    _sync(device)
    same = bool(torch.equal(again.x, first.x))
    print(f"[qp] step {7 + n_steps} twice from one state: bitwise_equal={same}", flush=True)
    check(same, "QP step bitwise repeatable")
    print(f"[qp] its second ADMM call: {traced['rows']} rows, {traced['admm']} ADMM and "
          f"{traced['pcg']} PCG iterations; tet_hv calls the card ran={traced['device']} "
          f"tet_hv.launches={traced['counted']} operator applications={traced['ops']}",
          flush=True)
    check(traced["admm"] > 1 and traced["rows"] > 0, "the traced ADMM call ran its graphs")
    check(traced["device"] == traced["counted"] == traced["ops"],
          "the device ran one tet_hv launch per counted launch and operator application, "
          "graph replays included (QP path)")
    tet_hv.launches = launches  # the repeat's launches are not the main run's
    _restore_kernel_counts(kernels)
    return _path_launches("qp", launches, *kernels)


def _traced_second_call(admm_qp, q, traced):
    """admm_qp, whose second call (active rows, ADMM's three CUDA graphs
    captured and replayed) fills `traced` with the tet_hv calls the card
    ran (the kernel's device counter, hv_timing.device_launches) beside
    tet_hv.launches and q's operator applications over the call."""
    from ipc_tpu_torch.hv_timing import device_launches
    from ipc_tpu_torch.ops.tet_hv import tet_hv

    calls = []

    def admm(*a, **kw):
        calls.append(1)
        if len(calls) != 2:
            return admm_qp(*a, **kw)
        n0, ops0, pcg0 = tet_hv.launches, q.operator_applications, q.pcg_iterations
        out, n = device_launches(lambda: admm_qp(*a, **kw), q.device)
        traced.update(device=n, counted=tet_hv.launches - n0,
                      ops=q.operator_applications - ops0, admm=out[2],
                      pcg=q.pcg_iterations - pcg0, rows=int(a[2].shape[0]))
        return out

    return admm


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


def _contact_lead(cpu_step=None):
    """The contact scene's state before step 8 (numpy): 8 device steps of
    build_scene(2, float64, with_contact=True) on the CPU."""
    import torch

    from ipc_tpu_torch.convert import state_to_numpy
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.scenes import build_scene

    st = build_scene(2, torch.float64, "cpu", with_contact=True)
    cpu_step = cpu_step or make_step(st)
    s = st.initial_state()
    for _ in range(8):
        s, _ = cpu_step(s)
    return state_to_numpy(s)


def phase_contact_reference(device):
    """Steps 8-9 of the contact scene, card against CPU (_hold). Returns
    the CPU's state before step 8 (numpy), which the variants reference
    reuses."""
    import torch

    from ipc_tpu_torch.convert import state_from_numpy, state_to_numpy
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.scenes import build_scene

    cpu_step = make_step(build_scene(2, torch.float64, "cpu", with_contact=True))
    card_step = make_step(build_scene(2, torch.float64, device, with_contact=True))
    lead = _contact_lead(cpu_step)
    s = state_from_numpy(lead, "cpu", torch.float64)
    rng = np.random.default_rng(2)
    for i in range(8, 10):
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


def phase_twist_path(device, n=100, n_steps=12):
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
    _zero_launches()
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
    counts = _path_launches("twist", launches, *_kernel_counts())
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
    return counts


def _hold(tag, cpu_step, card_step, pre, rng, device):
    """One step from the numpy state `pre` on the CPU and on the card (both
    float64): counts equal, script_scale and al_iters equal, x within
    max(1e-9, twice the CPU step's response to a 1-ulp change of x), PCG
    within the count change that change causes (the response is the larger
    of two random sign patterns, measured only when x or the PCG count
    differ). Returns (CPU state, card stats)."""
    import torch

    from ipc_tpu_torch.convert import state_from_numpy

    got, gs = card_step(state_from_numpy(pre, device, torch.float64))
    return _held(tag, cpu_step, pre, got.x.cpu().numpy(), gs, rng)


def _held(tag, cpu_step, pre, got_x, gs, rng):
    """_hold's comparison of a card step's result (x as numpy, its stats)
    with cpu_step from the same numpy state `pre`."""
    import torch

    from ipc_tpu_torch.convert import state_from_numpy

    nxt, ref = cpu_step(state_from_numpy(pre, "cpu", torch.float64))
    x_ref = nxt.x.numpy()
    dx = float(np.abs(got_x - x_ref).max())
    sens, flip = 0.0, 0
    for _ in range(2 if dx > 1e-9 or gs.pcg_iters_total != ref.pcg_iters_total else 0):
        pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                    * np.spacing(np.abs(pre["x"])))
        sp, rp = cpu_step(state_from_numpy(pert, "cpu", torch.float64))
        sens = max(sens, float(np.abs(sp.x.numpy() - x_ref).max()))
        flip = max(flip, abs(rp.pcg_iters_total - ref.pcg_iters_total))
    _judge(tag, gs, ref, dx, sens, flip)
    return nxt, gs


def _judge(tag, gs, ref, dx, sens, flip):
    """The hold rule: Newton, kappa-doubling and AL counts and script_scale
    equal, PCG within `flip` (the CPU's count change under a 1-ulp change
    of x), x within max(1e-9, 2 sens) (sens: the CPU's 1-ulp response)."""
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


def _variant_scenes():
    """{name: (stepper factory on a device, steps compared, starts from the
    contact scene's state before step 8)} of the variants reference."""
    import torch

    from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
    from ipc_tpu_torch.contact.pipeline import SelfContact
    from ipc_tpu_torch.mesh import append_kinematic_surface, build_mesh, merge_meshes
    from ipc_tpu_torch.models.primitives import box_grid, cube
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

    def cube_on_plate(dev):
        V, T = box_grid(3, 3, 3)
        mesh, meta = build_mesh(V + np.array([0.0, 0.001, 0.0]), T, dtype=f64, device=dev)
        plate = np.array([[-2.0, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]]) + [0.5, 0, 0.5]
        mesh, meta, (p0, p1) = append_kinematic_surface(mesh, meta, plate,
                                                        np.array([[0, 2, 1], [0, 3, 2]]))
        vert_mu = np.where(np.arange(p1) >= p0, 0.2, 0.0)
        sc = SelfContact(mesh, meta, friction=0.0, vert_mu=vert_mu, broadphase="grid")
        check(sc.big is not None, "the plate's primitives take the dense big sweep")
        return IPCStepper(mesh, meta, SimParams(), self_contact=sc)

    return {
        "newmark": (boxes(time_integration="NM"), 3, False),
        "fcr": (boxes(model="FCR"), 3, False),
        "damping": (boxes(damping_stiff=1e-4), 3, False),
        "no_coarse": (boxes(coarse_precond=False), 3, False),
        "ccd_ti": (ti, 1, True),
        "turning": (turning, 8, False),
        "aco_squash": (aco, 6, False),
        "blocked_press": (press, 2, False),
        "twist_mat4": (lambda dev: build_twist_scene(4, f64, dev), 4, False),
        "cube_on_plate": (cube_on_plate, 3, False),
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
        if name == "cube_on_plate":
            check(gs.fric_count > 0, "friction against the plate is captured")


def _qp_counts(stats):
    """(outer iterations, ADMM iterations per outer iteration, active-set
    sizes) of a QP step."""
    return stats.iters, tuple(stats.pcg_iters), tuple(stats.n_constraints)


def _qp_scenes():
    """{name: (QPStepper factory on a device, steps compared)} of the QP
    reference, cube(1) scenes in float64: a cube 0.004 above the ground
    (SQP, graphics; its second step runs ADMM into its cap), and a cube on
    the ground with a second 0.004 above it (self-contact; the pair rows
    join in the second step) under SQP / Verschoor and QP / volume."""
    import torch

    from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
    from ipc_tpu_torch.contact.pipeline import SelfContact
    from ipc_tpu_torch.mesh import build_mesh, merge_meshes
    from ipc_tpu_torch.models.primitives import cube
    from ipc_tpu_torch.qp.stepper import QPStepper
    from ipc_tpu_torch.timestepper import SimParams

    def make(mode, ctype, two, y):
        def build(dev):
            V, T = cube(1)
            parts = [(V + np.array([0.0, y, 0.0]), T)]
            if two:
                parts.append((V + np.array([0.0, y + 1.004, 0.0]), T))
            V, T, comp, ranges = merge_meshes(parts)
            mesh, meta = build_mesh(V, T, vert_comp=comp, comp_ranges=ranges,
                                    dtype=torch.float64, device=dev)
            return QPStepper(mesh, meta, SimParams(), halfspaces=[HalfSpace(HalfSpaceParams())],
                             self_contact=SelfContact(mesh, meta) if two else None, mode=mode,
                             constraint_type=ctype)
        return build

    return {
        "drop_sqp_graphics": (make("SQP", "graphics", False, 0.004), 2),
        "cubes_sqp_verschoor": (make("SQP", "verschoor", True, 0.001), 2),
        "cubes_qp_volume": (make("QP", "volume", True, 0.001), 2),
    }


QP_SCENE = """shapes input 1
{msh} 0 0.004 0  0 0 0  1 1 1
time 0.2 0.025
density 1000
stiffness 1e5 0.4
halfSpace  0 0 0  0 1 0  0  0
constraintSolver SQP
constraintType graphics
"""


def _qp_hold(tag, cpu_st, card_st, pre, rng, device):
    """One QP step from the numpy state `pre` on the CPU and on the card
    (both float64), held as _hold holds a device step: the outer count,
    the ADMM list and the active-set sizes equal, or equal to the CPU's
    own under one of two 1-ulp changes of x; x within max(1e-9, twice the
    CPU's 1-ulp response), measured only when x or a count differ.
    Returns the CPU's state."""
    import torch

    from ipc_tpu_torch.convert import state_from_numpy

    nxt, ref = cpu_st.step(state_from_numpy(pre, "cpu", torch.float64))
    got, gs = card_st.step(state_from_numpy(pre, device, torch.float64))
    x_ref = nxt.x.numpy()
    dx = float(np.abs(got.x.cpu().numpy() - x_ref).max())
    rc, gc = _qp_counts(ref), _qp_counts(gs)
    sens, outcomes = 0.0, [rc]
    for _ in range(2 if dx > 1e-9 or gc != rc else 0):
        pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                    * np.spacing(np.abs(pre["x"])))
        sp, rp = cpu_st.step(state_from_numpy(pert, "cpu", torch.float64))
        sens = max(sens, float(np.abs(sp.x.numpy() - x_ref).max()))
        outcomes.append(_qp_counts(rp))
    tol = max(1e-9, 2.0 * sens)
    print(f"[{tag}]: card outer/admm/active={gc[0]}/{list(gc[1])}/{gc[2][-1]} CPU "
          f"{rc[0]}/{list(rc[1])}/{rc[2][-1]}; max |dx|={dx:.3e} (limit {tol:.3e})", flush=True)
    check(gc in outcomes, f"{tag}: the CPU's counts (or its own under a 1-ulp change)")
    check(dx <= tol, f"{tag}: card agrees with the CPU reference")
    return nxt


def phase_qp_reference(device):
    """The QP/SQP stepper in float64, card against CPU (module docstring,
    phase 16): the cube scenes of _qp_scenes, each step from the CPU's
    state before it, then a scene file with constraintSolver SQP through
    the CLI entry point on both (3 steps, in build/qp_reference/):
    iterStats.txt's counts equal, status3.npz's x within 1e-9."""
    import os
    import shutil

    import torch

    from ipc_tpu_torch import io_mesh
    from ipc_tpu_torch.__main__ import main as cli_main
    from ipc_tpu_torch.convert import state_to_numpy
    from ipc_tpu_torch.models.primitives import cube

    rng = np.random.default_rng(7)
    for name, (make, n_steps) in _qp_scenes().items():
        cpu_st, card_st = make("cpu"), make(device)
        s = cpu_st.initial_state()
        for i in range(n_steps):
            s = _qp_hold(f"qp-ref {name} step {i}", cpu_st, card_st, state_to_numpy(s), rng,
                         device)
        check(card_st.operator_applications > 0, f"qp-ref {name}: the card stepper ran")
    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "qp_reference")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    msh, scene = os.path.join(workdir, "cube.msh"), os.path.join(workdir, "qp.txt")
    io_mesh.write_msh(msh, *cube(1))
    with open(scene, "w") as f:
        f.write(QP_SCENE.format(msh=msh))
    runs = {}
    # the card is the CLI's default (a CPU rehearsal names its device)
    card = [] if torch.device(device).type == "cuda" else ["--device", str(device)]
    for who, extra in (("card", card), ("cpu", ["--device", "cpu"])):
        out = os.path.join(workdir, who)
        check(cli_main([scene, "-o", out, "-n", "3"] + extra) == 0,
              f"the constraintSolver SQP scene runs through the CLI ({who})")
        runs[who] = (_read_rows(os.path.join(out, "iterStats.txt")),
                     np.load(os.path.join(out, "status3.npz"))["x"])
    (card_rows, card_x), (cpu_rows, cpu_x) = runs["card"], runs["cpu"]
    dx = float(np.abs(card_x - cpu_x).max())
    same = [r[:3] for r in card_rows] == [r[:3] for r in cpu_rows]
    print(f"[qp-ref] scene file, 3 steps through the CLI: {len(card_rows)} iterStats lines, "
          f"same counts={same}, status3 max |dx|={dx:.3e}", flush=True)
    check(same and len(card_rows) > 3, "the SQP scene's iterStats.txt counts agree")
    check(dx <= 1e-9, "the SQP scene's status3.npz agrees with the CPU")


def phase_diagnostic():
    """python -m ipc_tpu_torch.diagnostic all on the card (module
    docstring, phase 17)."""
    from ipc_tpu_torch.diagnostic import main as diagnostic_main

    check(diagnostic_main(["all"]) == 0, "every diagnostic mode passes on the card "
          "(no --device: the card)")


DRIVER_SCENE = """energy NH
timeIntegration BE
time 0.25 0.025
density 1000
stiffness 1e5 0.4
shapes input 2
lower.msh 0 0.01 0  0 0 0  1 1 1
upper.msh 0 1.2 0  0 0 0  1 1 1
selfCollisionOn
selfFric 0.1
meshCO plate.obj 0.5 0 0.5 4 1e10 0.2
"""


def _read_rows(path):
    with open(path) as f:
        return [line.split() for line in f if line.strip()]


def _driver_scene_files(name, n_cells):
    """build/<name>/ of this checkout, emptied, with the driver scene:
    lower.msh and upper.msh (box_grid(n_cells)), plate.obj and driver.txt.
    Returns (workdir, scene path, one box's vertices)."""
    import os
    import shutil

    from ipc_tpu_torch import io_mesh
    from ipc_tpu_torch.models.primitives import box_grid

    workdir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", name)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    V, T = box_grid(n_cells, n_cells, n_cells)
    for mesh_name in ("lower.msh", "upper.msh"):
        io_mesh.write_msh(os.path.join(workdir, mesh_name), V, T)
    plate = np.array([[-2.0, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]])
    io_mesh.write_obj(os.path.join(workdir, "plate.obj"), plate, np.array([[0, 2, 1], [0, 3, 2]]))
    scene = os.path.join(workdir, "driver.txt")
    with open(scene, "w") as f:
        f.write(DRIVER_SCENE)
    return workdir, scene, V


def phase_driver_path(device, n_cells=20):
    """The scene-file driver at full width (module docstring, phase 12), in
    build/driver_path/ of this checkout. Returns the run's tet_hv and ACCD
    launches."""
    import os

    import torch

    from ipc_tpu_torch.__main__ import main as cli_main
    from ipc_tpu_torch.config import load_config
    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.sim import Simulation

    workdir, scene, V = _driver_scene_files("driver_path", n_cells)
    out = os.path.join(workdir, "out")
    args = ["-n", "10", "--f32", "--jit-step", "--save-every", "5"]
    if torch.device(device).type != "cuda":  # a CPU rehearsal; the card is the default
        args += ["--device", str(device)]

    _zero_launches()
    t0 = time.perf_counter()
    check(cli_main([scene, "-o", out] + args) == 0, "the CLI run exits 0")
    wall = time.perf_counter() - t0
    launches, kernels = tet_hv.launches, _kernel_counts()
    names = ["config.txt", "iterStats.txt", "sysE.txt", "sysM.txt", "sysL.txt", "info.txt",
             "resultsStats.txt"] + [f"{a}{k}.{b}" for k in (5, 10)
                                    for a, b in (("status", "npz"), ("surf", "obj"))]
    missing = [n for n in names if not os.path.exists(os.path.join(out, n))]
    check(not missing, f"every artifact is written (missing {missing})")
    with open(os.path.join(out, "info.txt")) as f:
        info = json.load(f)
    stats = info["step_stats"]
    newton = sum(s["newton_iters"] for s in stats)
    pcg = sum(s["pcg_iters_total"] for s in stats)
    step_s = info["timers_sec"]["step"]
    for i, s in enumerate(stats):
        print(f"[driver] step {i}: newton_iters={s['newton_iters']} "
              f"pcg_iters_total={s['pcg_iters_total']} pt/ee/et={s['pt_count']}/"
              f"{s['ee_count']}/{s['et_count']} active_pt/ee_max={s['active_pt_max']}/"
              f"{s['active_ee_max']} fric_count={s['fric_count']} kappa={s['kappa']:.6g} "
              f"kappa_doublings={s['kappa_doublings']}")
    print(f"[driver] wall seconds per step: {step_s / len(stats):.4f} (the steps: "
          f"{step_s:.3f} s; the whole CLI call {wall:.3f} s, artifact I/O "
          f"{info['timers_sec'].get('io', 0.0):.3f} s)")
    print(f"[driver] wall seconds per Newton iteration: {step_s / max(newton, 1):.4f}")
    print(f"[driver] Newton iterations: {newton}")
    print(f"[driver] PCG iterations: {pcg}")
    print(f"[driver] candidates pt/ee/et max: {max(s['pt_count'] for s in stats)}/"
          f"{max(s['ee_count'] for s in stats)}/{max(s['et_count'] for s in stats)}")
    print(f"[driver] active pairs pt/ee max: {max(s['active_pt_max'] for s in stats)}/"
          f"{max(s['active_ee_max'] for s in stats)}")
    print(f"[driver] friction pairs max: {max(s['fric_count'] for s in stats)}")
    print(f"[driver] host syncs: {info['host_syncs']} ({info['host_syncs'] / len(stats):.1f} "
          f"per step)")
    print(f"[driver] tet_hv launches={launches} operator applications="
          f"{info['operator_applications']}")
    check(len(stats) == 10, "10 steps ran")
    check(len(_read_rows(os.path.join(out, "iterStats.txt"))) == newton,
          "one iterStats line per Newton iteration")
    check(launches > 0 and launches == info["operator_applications"],
          "one tet_hv launch per operator application (driver)")

    # the invariants, on the saved states and a Simulation of the same file
    sim = Simulation(load_config(scene), dtype=torch.float32, device=device)
    sc = sim.stepper.sc
    p0, p1 = sim.mesh_co_ranges[0]
    n_lower = len(V)
    check(sc.broadphase == "grid" and sc.big is not None, "the grid takes the big sweep")
    z5, z10 = (np.load(os.path.join(out, f"status{k}.npz")) for k in (5, 10))
    for z in (z5, z10):
        check(all(np.isfinite(z[f]).all() for f in ("x", "v", "a")), "saved states finite")
        check(z["x"][:n_lower, 1].min() > 0.0, "the lower box stays above the plate")
        check(np.array_equal(z["x"][p0:p1], sim.mesh.x_rest[p0:p1].double().cpu().numpy()),
              "the plate stays bitwise at its placement")
    x = torch.as_tensor(z10["x"], device=device).to(torch.float32)
    hit = bool(sc.has_intersection(x)[0])
    dHat = sim.stepper.dHat
    cand = sc.build_candidates(x, None, float(np.sqrt(dHat)), with_et=False)
    fr = sc.capture_friction(x, cand, stats[-1]["kappa"], dHat)
    on_plate = int((fr["vids"] >= p0).any(dim=1).sum())
    print(f"[driver] end state: ymin lower box {z10['x'][:n_lower, 1].min():.6g}, "
          f"intersection={hit}, friction pairs {fr['count']} ({on_plate} against the plate)")
    check(not hit, "no edge-triangle intersection at the end")
    check(on_plate > 0, "friction pairs against the plate")

    # restart from status5.npz in a fresh Simulation: steps 5-9
    restart = os.path.join(workdir, "driver_restart.txt")
    with open(restart, "w") as f:
        f.write(DRIVER_SCENE + f"restart {os.path.join(out, 'status5.npz')}\n")
    out2 = os.path.join(workdir, "out_restart")
    t0 = time.perf_counter()
    check(cli_main([restart, "-o", out2] + args) == 0, "the restarted CLI run exits 0")
    r10 = np.load(os.path.join(out2, "status10.npz"))
    same = all(r10[f].tobytes() == z10[f].tobytes() for f in ("x", "v", "a"))
    print(f"[driver] restart from status5.npz, steps 5-9 in {time.perf_counter() - t0:.3f} s: "
          f"status10 bitwise equal={same}")
    check(same, "a restart from status5 reproduces status10 bitwise")
    tet_hv.launches = launches  # the restart's launches are not the main run's
    _restore_kernel_counts(kernels)
    return _path_launches("driver", launches, *kernels)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_counts(stats):
    """(Newton iterations: search directions, PCG iterations) of a host
    StepStats (lists over every sub-solve of the step)."""
    return len(stats.pcg_iters), sum(stats.pcg_iters)


def phase_host_path(device, n_cells=20, n_steps=10):
    """The host path at full width (module docstring, phase 13), in
    build/host_path/ of this checkout. Returns the run's tet_hv and ACCD
    launches."""
    import os

    import torch

    from ipc_tpu_torch.__main__ import main as cli_main
    from ipc_tpu_torch.config import load_config
    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.sim import Simulation
    from ipc_tpu_torch.timestepper import IPCStepper
    from ipc_tpu_torch.utils.observability import load_status

    workdir, scene, V = _driver_scene_files("host_path", n_cells)
    out = os.path.join(workdir, "out")
    args = ["-n", str(n_steps), "--f32", "--save-every", "5"]
    if torch.device(device).type != "cuda":  # a CPU rehearsal; the card is the default
        args += ["--device", str(device)]
    n_lower = len(V)
    rows = []
    host_step = IPCStepper.step

    def checked_step(self, state, verbose=False):
        """IPCStepper.step, timed, then the invariants (outside the time)."""
        ops0, syncs0 = self.operator_applications, self.host_syncs
        t0 = time.perf_counter()
        nxt, st = host_step(self, state, verbose)
        _sync(device)
        wall = time.perf_counter() - t0
        directions, pcg = _host_counts(st)
        for t in (nxt.x, nxt.v):
            check(bool(torch.isfinite(t).all()), "finite state (host path)")
        hit = bool(self.sc.has_intersection(nxt.x)[0])
        ymin = nxt.x[:n_lower, 1].min().item()
        rows.append(dict(wall=wall, directions=directions, pcg=pcg,
                         syncs=self.host_syncs - syncs0, ops=self.operator_applications - ops0))
        print(f"[host] step {state.step}: newton_iters={directions} line_searches="
              f"{len(st.alphas)} pcg_iters_total={pcg} kappa={st.kappa:.6g} kappa_doublings="
              f"{st.kappa_doublings} intersection_backtracks={st.intersection_backtracks} "
              f"sweep_clamps={st.sweep_clamps} max_constraints={max(st.n_constraints)} "
              f"operator_applications={rows[-1]['ops']} host_syncs={rows[-1]['syncs']} "
              f"ymin_lower={ymin:.6g} intersection={hit} wall_s={wall:.4f}", flush=True)
        check(not hit, "no edge-triangle intersection after a host step")
        check(ymin > 0.0, "the lower box stays above the plate")
        return nxt, st

    _zero_launches()
    IPCStepper.step = checked_step
    try:
        t0 = time.perf_counter()
        check(cli_main([scene, "-o", out] + args) == 0, "the host-path CLI run exits 0")
        wall = time.perf_counter() - t0
    finally:
        IPCStepper.step = host_step
    launches, kernels = tet_hv.launches, _kernel_counts()
    with open(os.path.join(out, "info.txt")) as f:
        info = json.load(f)
    stats = info["step_stats"]
    steps_s = sum(r["wall"] for r in rows)
    newton = sum(r["directions"] for r in rows)
    pcg = sum(r["pcg"] for r in rows)
    syncs = sum(r["syncs"] for r in rows)
    print(f"[host] {n_steps} steps in {steps_s:.3f} s ({steps_s / n_steps:.4f} s per step; the "
          f"whole CLI call {wall:.3f} s), {newton} Newton iterations ({steps_s / max(newton, 1):.4f} "
          f"s per iteration), {pcg} PCG iterations; host syncs {syncs} ({syncs / n_steps:.1f} per "
          f"step; info.txt {info['host_syncs']}); tet_hv launches={launches} operator "
          f"applications={info['operator_applications']}")
    check(len(stats) == len(rows) == n_steps, f"{n_steps} host steps ran")
    check(info["host_syncs"] == syncs, "info.txt counts the host path's syncs")
    check(launches > 0 and launches == info["operator_applications"],
          "one tet_hv launch per operator application (host path)")
    # iterStats.txt: one line per line-searched Newton iteration of the
    # last sub-solve (stats.iters), as the JAX package writes it
    it = _read_rows(os.path.join(out, "iterStats.txt"))
    check(len(it) == sum(s["iters"] for s in stats), "one iterStats line per Newton iteration")
    check(all(0.0 < float(r[1]) <= 1.0 for r in it), "iterStats step sizes in (0, 1]")
    sim = Simulation(load_config(scene), dtype=torch.float32, device=device)
    z10 = np.load(os.path.join(out, f"status{n_steps}.npz"))
    check(int(z10["step"]) == n_steps and all(np.isfinite(z10[f]).all() for f in ("x", "v", "a")),
          "status10.npz reads back finite")
    p0, p1 = sim.mesh_co_ranges[0]
    check(np.array_equal(z10["x"][p0:p1], sim.mesh.x_rest[p0:p1].double().cpu().numpy()),
          "the plate stays bitwise at its placement")
    print(f"[host] iterStats.txt {len(it)} lines; status{n_steps}.npz: ymin lower box "
          f"{z10['x'][:n_lower, 1].min():.6g}")
    # one step twice from the checkpoint of step 5, in a fresh Simulation
    state = load_status(os.path.join(out, "status5.npz"), sim.stepper)
    a, _ = sim.stepper.step(state)
    b, _ = sim.stepper.step(state)
    _sync(device)
    same = bool(torch.equal(a.x, b.x))
    print(f"[host] one step twice from status5.npz: bitwise_equal={same}")
    check(same, "host step bitwise repeatable")
    tet_hv.launches = launches  # the repeat's launches are not the main run's
    _restore_kernel_counts(kernels)
    return _path_launches("host", launches, *kernels)


def _host_snapshot(st):
    """A host stepper's mutable state: plane origins, the script (ACO
    velocities) and fricDHat."""
    import copy

    return st.hs_origin.copy(), copy.deepcopy(st.script), st.fric_dhat


def _host_restore(st, snap):
    import copy

    st.hs_origin[:] = snap[0]
    st.script = copy.deepcopy(snap[1])
    st.fric_dhat = snap[2]
    if st.hs_moving:
        st._refresh_hs_D()


def _host_step_counts(stats):
    """Every count the host reference holds: Newton, PCG, kappa doublings,
    AL iterations, intersection backtracks, sweep clamps."""
    return _host_counts(stats) + (stats.kappa_doublings, stats.al_iters,
                                  stats.intersection_backtracks, stats.sweep_clamps)


def _host_cpu_case(name):
    """The CPU side of one host-reference case in float64, run in a worker
    process beside the card's phases: per step, the state before it, x
    after it, its counts and planes, and its response to two 1-ulp changes
    of x (the largest |dx| and count change; the stepper's host state is
    restored before each); then the stepper's fricDHat values."""
    import torch

    from ipc_tpu_torch.convert import state_from_numpy, state_to_numpy

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    make, n_steps, v0, from_contact = _host_reference_scenes()[name]
    st = make("cpu")
    if from_contact:
        pre, first = dict(_contact_lead(), dx_el=None), 8
    else:
        v = None if v0 is None else np.tile(v0, (st.mesh.x_rest.shape[0], 1))
        pre, first = state_to_numpy(st.initial_state(v0=v)), 0
    rng = np.random.default_rng(6)
    steps = []
    for i in range(first, first + n_steps):
        before = _host_snapshot(st)
        nxt, ref = st.step(state_from_numpy(pre, "cpu", torch.float64))
        after = _host_snapshot(st)
        x_ref = nxt.x.numpy()
        rc = _host_step_counts(ref)
        sens, change = 0.0, [0] * len(rc)
        for _ in range(2):
            _host_restore(st, before)
            pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                        * np.spacing(np.abs(pre["x"])))
            sp, sr = st.step(state_from_numpy(pert, "cpu", torch.float64))
            sens = max(sens, float(np.abs(sp.x.numpy() - x_ref).max()))
            change = [max(c, abs(a - b)) for c, a, b in zip(change, _host_step_counts(sr), rc)]
        _host_restore(st, after)
        steps.append(dict(i=i, pre=pre, x=x_ref, counts=rc, hs_origin=st.hs_origin.copy(),
                          sens=sens, change=change))
        pre = state_to_numpy(nxt)
    return dict(steps=steps, fric_dhat=(st.fric_dhat, st.fric_dhat_target, st.fric_dhat0),
                seconds=time.perf_counter() - t0)


def _host_hold(tag, card_st, rec, device):
    """One host step on the card from the CPU's state before it, held
    against the CPU's step `rec` (_host_cpu_case) as _hold holds a device
    step: Newton, PCG, kappa-doubling, AL, intersection-backtrack and
    sweep-clamp counts each equal or within the change a 1-ulp change of x
    causes in the CPU's own count, x within max(1e-9, twice the CPU step's
    1-ulp response), the planes at the same place. The 1-ulp response
    counts only when x or a count differ; on a step that is not
    ill-conditioned it changes nothing, so the counts must be equal.
    Returns the card's stats."""
    import torch

    from ipc_tpu_torch.convert import state_from_numpy

    got, gs = card_st.step(state_from_numpy(rec["pre"], device, torch.float64))
    dx = float(np.abs(got.x.cpu().numpy() - rec["x"]).max())
    rc, gc = rec["counts"], _host_step_counts(gs)
    sens, change = 0.0, [0] * len(rc)
    if dx > 1e-9 or gc != rc:
        sens, change = rec["sens"], rec["change"]
    tol = max(1e-9, 2.0 * sens)
    names = "newton/pcg/doublings/al/backtracks/clamps"
    print(f"[{tag}]: card {names}={'/'.join(map(str, gc))} CPU {'/'.join(map(str, rc))}; "
          f"max |dx|={dx:.3e} (limit {tol:.3e}; the CPU's 1-ulp count change "
          f"{'/'.join(map(str, change))})", flush=True)
    for name, g, r, c in zip(names.split("/"), gc, rc, change):
        check(abs(g - r) <= c, f"{tag}: {name} count within the CPU's own 1-ulp change")
    check(np.array_equal(card_st.hs_origin, rec["hs_origin"]), f"{tag}: the planes agree")
    check(dx <= tol, f"{tag}: card agrees with the CPU reference")
    return gs


def _host_reference_scenes():
    """{name: (host stepper factory on a device, steps compared, initial
    velocity (3,) or None, starts from the contact scene's state before
    step 8)} of the host reference."""
    import torch

    from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
    from ipc_tpu_torch.mesh import build_mesh
    from ipc_tpu_torch.models.primitives import cube
    from ipc_tpu_torch.scenes import build_scene
    from ipc_tpu_torch.scripting import Script
    from ipc_tpu_torch.timestepper import IPCStepper, SimParams

    f64 = torch.float64

    def on_ground(n=1, y=0.01, mu=0.1, **params):
        def make(dev):
            V, T = cube(n)
            mesh, meta = build_mesh(V + np.array([0.0, y, 0.0]), T, dtype=f64, device=dev)
            return IPCStepper(mesh, meta, SimParams(**params),
                              halfspaces=[HalfSpace(HalfSpaceParams(friction=mu))])
        return make

    def boxes(dev):
        return build_scene(2, f64, dev, with_contact=True)

    def shear(dev):
        V, T = cube(1, size=0.5)
        script = Script(n_verts=len(V), aco_kind="squashshear",
                        aco_vel=np.array([[1.0, 0, 0], [-1.0, 0, 0]]))
        planes = [HalfSpaceParams(origin=(-0.0004, 0.0, 0.0), normal=(1.0, 0.0, 0.0),
                                  friction=0.2),
                  HalfSpaceParams(origin=(0.5004, 0.0, 0.0), normal=(-1.0, 0.0, 0.0),
                                  friction=0.2)]
        mesh, meta = build_mesh(V, T, dtype=f64, device=dev)
        return IPCStepper(mesh, meta, SimParams(gravity=(0, 0, 0)),
                          halfspaces=[HalfSpace(q) for q in planes], script=script)

    slide = np.array([0.5, 0.0, 0.0])
    return {
        "cube_drop": (on_ground(), 3, None, False),
        "boxes_contact": (boxes, 1, None, True),
        "warm_start5": (on_ground(n=2, y=0.3, mu=0.0, warm_start=5), 1, None, False),
        "dense": (on_ground(y=0.02, mu=0.2, linsys="dense"), 1, None, False),
        "sparse": (on_ground(y=0.02, mu=0.2, linsys="sparse"), 1, None, False),
        "fric_dhat": (on_ground(y=0.002, mu=0.4, fric_dhat0_rel=4e-3), 2, slide, False),
        "aco_squashshear": (shear, 3, None, False),
        # the device variants' press scene (_variant_scenes)
        "blocked_press": (_variant_scenes()["blocked_press"][0], 2, None, False),
    }


def start_host_reference(pool):
    """Start the host reference's CPU side (_host_cpu_case) in `pool`, the
    longest case first: {name: AsyncResult}, in the phase's order."""
    names = list(_host_reference_scenes())
    jobs = {n: pool.apply_async(_host_cpu_case, (n,)) for n in ["blocked_press"] + names}
    return {n: jobs[n] for n in names}


def phase_host_reference(device, cpu_refs):
    """The host path in float64, card against CPU (module docstring, phase
    14); `cpu_refs`: {name: _host_cpu_case's record}."""
    for name, ref in cpu_refs.items():
        t0 = time.perf_counter()
        card_st = _host_reference_scenes()[name][0](device)
        al = 0
        for rec in ref["steps"]:
            gs = _host_hold(f"host-ref {name} step {rec['i']}", card_st, rec, device)
            al += gs.al_iters
        print(f"[host-ref] {name}: {len(ref['steps'])} steps held, card "
              f"{time.perf_counter() - t0:.1f} s (the CPU side {ref['seconds']:.1f} s in its "
              f"worker)", flush=True)
        if name == "blocked_press":
            check(al > 0, "the blocked press ran the moving-DBC AL")
        if name == "fric_dhat":
            fric_dhat, target, start = ref["fric_dhat"]
            check(fric_dhat == target < start, "the fricDHat homotopy ran to its target")
        if name in ("dense", "sparse"):
            check(set(gs.pcg_iters) == {1}, f"the {name} solve ran")


def _host_reference_process(cpu_refs):
    """Process target: phase 14 on the card, from the CPU's records."""
    from ipc_tpu_torch.device import require_cuda

    t0 = time.perf_counter()
    phase_host_reference(require_cuda(), cpu_refs)
    print(f"[host-ref] card side done in {time.perf_counter() - t0:.1f} s", flush=True)


def start_host_reference_process(cpu_jobs):
    """Phase 14 in a child process on the same card, once the CPU side is
    in (None when the phase is not run)."""
    import multiprocessing

    if cpu_jobs is None:
        return None
    cpu_refs = {n: job.get() for n, job in cpu_jobs.items()}
    child = multiprocessing.get_context("spawn").Process(target=_host_reference_process,
                                                         args=(cpu_refs,))
    child.start()
    return child


def join_host_reference(child):
    child.join()
    check(child.exitcode == 0, f"the host reference passed (exit code {child.exitcode})")


def _pair_keys(pairs):
    return set(map(tuple, np.asarray(pairs).tolist()))


def _sharded_job(rank, world, device, spec):
    """Rank job of phases 18 and 19 (ipc_tpu_torch.parallel.launch): from
    each numpy state of spec["starts"], spec["chain"] (default 1) steps of
    spec's scene on the rank's shard (parallel.jobs.rank_step; `pad`: the
    rank count the mesh is padded for). `repeat_last`: the last step of
    each start taken again from its state (its launches not counted),
    `repeat_equal` in its record. `union`: the rank's candidate pairs at
    the first start and, on rank 0, the single-rank fused_candidates set on
    the same padded x. Returns parallel.jobs.rank_info plus rows and union."""
    import math

    import torch

    from ipc_tpu_torch.contact import spatial_hash as SH
    from ipc_tpu_torch.convert import state_from_numpy
    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.parallel import jobs
    from ipc_tpu_torch.parallel.sharding import replicate, shard_state

    st, step = jobs.rank_step(rank, world, device, spec, spec.get("pad"))
    out = dict(rows=[], union=None)
    for k, arrays in enumerate(spec["starts"]):
        s = replicate(shard_state(state_from_numpy(arrays, device, st.dtype), st.mesh))
        if spec.get("union") and k == 0:
            m, gap = st.mesh, math.sqrt(st.dHat)
            mine = st.sc.candidate_pairs(s.x, None, gap, with_et=True)
            full = None
            if rank == 0:
                f = SH.fused_candidates(s.x, m.surf_verts, m.surf_edges, m.surf_tris,
                                        m.dbc_mask, None, gap, with_et=True, big=st.sc.big)
                full = [f[n][0].cpu().numpy() for n in ("pt", "ee", "et")]
            out["union"] = dict(mine=[p.cpu().numpy() for p, _ in mine], full=full)
        pre, rows = jobs.steps(st, step, s, spec.get("chain", 1) - 1)
        s, last = jobs.steps(st, step, pre, 1)
        out["rows"] += rows + last
        if spec.get("repeat_last"):
            launches0, kernels0 = tet_hv.launches, _kernel_counts()
            again, _ = step(pre)
            tet_hv.launches = launches0  # a comparison, not a main-path run
            _restore_kernel_counts(kernels0)
            out["rows"][-1]["repeat_equal"] = bool(torch.equal(again.x, s.x))
    return dict(jobs.rank_info(st, rank), **out)


def phase_sharded_path(device, lead, ranks=2):
    """The contact path's boxes split over `ranks` ranks through steps 8-9
    (module docstring, phase 18). Returns the ranks' tet_hv and ACCD
    launches."""
    import os

    import torch

    from ipc_tpu_torch.convert import state_to_numpy
    from ipc_tpu_torch.parallel.launch import launch

    _, state = lead if lead is not None else _qp_lead(device)
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "sharded_path")
    os.makedirs(work, exist_ok=True)
    path = os.path.join(work, "state7.npz")
    arrays = state_to_numpy(state)
    np.savez(path, **{k: arrays[k] for k in ("x", "x_prev", "v", "a", "t", "step")})
    start = dict(np.load(path))
    backend = "nccl" if torch.cuda.device_count() >= ranks else "gloo"
    spec = dict(n_cells=20, dtype="float32", with_contact=True, starts=[start], chain=2,
                repeat_last=True, union=True)
    t0 = time.perf_counter()
    outs = launch(_sharded_job, ranks, backend, None, (spec,), timeout=600)
    wall = time.perf_counter() - t0
    print(f"[sharded] build_scene(20, float32, with_contact=True) from {path}: {ranks} ranks, "
          f"backend {outs[0]['backend']}, devices {[o['device'] for o in outs]}, "
          f"{wall:.1f} s in all (spawn, set-up, steps, checks)", flush=True)
    for o in outs:
        for name, total, mine, kind in o["report"]:
            print(f"[sharded] rank {o['rank']} {name} {total} B total, {mine} B on the rank "
                  f"({kind})")
        check(not o["foreign_modules"], "the rank processes load no jax")
    for k in range(2):
        rows = [o["rows"][k] for o in outs]
        s = rows[0]["stats"]
        print(f"[sharded] step {8 + k}: newton_iters={s['newton_iters']} "
              f"pcg_iters_total={s['pcg_iters_total']} pt/ee/et={s['pt_count']}/"
              f"{s['ee_count']}/{s['et_count']} active_pt/ee_max={s['active_pt_max']}/"
              f"{s['active_ee_max']} fric_count={s['fric_count']} kappa={s['kappa']:.6g} "
              f"collectives={[r['collectives'] for r in rows]} per-rank counts "
              f"{[r['rank_counts'] for r in rows]} operator_applications="
              f"{[r['operator_applications'] for r in rows]} tet_hv_launches="
              f"{[r['tet_hv_launches'] for r in rows]} accd_launches="
              f"{[r['accd_launches'] for r in rows]} ymin={[r['ymin'] for r in rows]} "
              f"intersection={[r['intersection'] for r in rows]} wall_s="
              f"{[round(r['wall_s'], 4) for r in rows]}", flush=True)
        for r in rows:
            check(r["finite"], "finite state (sharded path)")
            check(r["ymin"] > 0.0, "ymin > 0 (sharded path)")
            check(not r["intersection"], "no edge-triangle intersection (sharded path)")
            check(r["tet_hv_launches"] == r["operator_applications"] > 0,
                  "one tet_hv launch per operator application on each rank (sharded)")
            check(r["stats"] == s, "the ranks' stats agree")
        same = all(np.array_equal(r["x"], rows[0]["x"]) for r in rows)
        print(f"[sharded] step {8 + k}: ranks' x bitwise equal={same}")
        check(same, "the replicated state is bitwise equal on every rank")
    check(any(o["rows"][0]["stats"]["active_pt_max"] > 0 for o in outs),
          "self-contact pairs active in the sharded landing")
    full = outs[0]["union"]["full"]
    for f, name in enumerate(("pt", "ee", "et")):
        mine = [_pair_keys(o["union"]["mine"][f]) for o in outs]
        union = set().union(*mine)
        disjoint = sum(len(m) for m in mine) == len(union)
        equal = union == _pair_keys(full[f])
        print(f"[sharded] step 8 start {name}: per-rank {[len(m) for m in mine]}, union "
              f"{len(union)}, single-rank {len(full[f])}: equal={equal} disjoint={disjoint}")
        check(equal and disjoint, f"the ranks' {name} candidates partition the single-rank set")
    for o in outs:
        rep = o["rows"][-1]["repeat_equal"]
        print(f"[sharded] rank {o['rank']}: step 9 twice from one state: bitwise_equal={rep}")
        check(rep, "sharded step bitwise repeatable")
    return _path_launches("sharded", sum(r["tet_hv_launches"] for o in outs for r in o["rows"]),
                          sum(r["accd_launches"] for o in outs for r in o["rows"]), 0,
                          sum(r["grid_launches"] for o in outs for r in o["rows"]))


def _sharded_cpu_case(patterns=6):
    """The CPU side of phase 19, run in a worker process beside the card's
    phases: the n_cells=2 boxes' unsharded float64 step over the mesh
    padded for 2 ranks, for steps 8-9 from _contact_lead's state; per step
    the state before it, x after it, its stats, and its response to
    `patterns` random 1-ulp changes of x (the largest |dx| and PCG count
    change). Six patterns, where phase 9 takes two: at the padded step 8
    the response ranges 7.6e-9 to 2.8e-8 over six on the CPU, so two can
    fall an order below it."""
    import dataclasses

    import torch

    from ipc_tpu_torch.convert import state_from_numpy, state_to_numpy
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.parallel.sharding import shard_state, shard_stepper
    from ipc_tpu_torch.scenes import build_scene

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    st = shard_stepper(build_scene(2, torch.float64, "cpu", with_contact=True), 2)
    step = make_step(st)
    s = shard_state(state_from_numpy(_contact_lead(), "cpu", torch.float64), st.mesh)
    rng = np.random.default_rng(6)
    rows = []
    for _ in range(2):
        pre = state_to_numpy(s)
        s, ref = step(s)
        x_ref = s.x.numpy()
        sens, flip = 0.0, 0
        for _ in range(patterns):
            pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                        * np.spacing(np.abs(pre["x"])))
            sp, rp = step(state_from_numpy(pert, "cpu", torch.float64))
            sens = max(sens, float(np.abs(sp.x.numpy() - x_ref).max()))
            flip = max(flip, abs(rp.pcg_iters_total - ref.pcg_iters_total))
        rows.append(dict(pre=pre, x=x_ref, stats=dataclasses.asdict(ref), sens=sens,
                         flip=flip))
    return dict(rows=rows, seconds=time.perf_counter() - t0)


def phase_sharded_reference(device, cpu_job):
    """The n_cells=2 boxes' steps 8-9 in float64 on the card, from the
    CPU's state before each step (module docstring, phase 19): on 2 gloo
    ranks against the CPU's unsharded make_step over the same padded mesh,
    and on a 1-rank NCCL group bitwise against the card's unsharded
    make_step over that mesh; `cpu_job` is _sharded_cpu_case's result
    (None: run it here)."""
    import dataclasses
    import types
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ipc_tpu_torch.convert import state_from_numpy
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.parallel.launch import launch
    from ipc_tpu_torch.parallel.sharding import shard_state, shard_stepper
    from ipc_tpu_torch.scenes import build_scene

    cpu = cpu_job if cpu_job is not None else _sharded_cpu_case()
    rows = cpu["rows"]
    print(f"[sharded-ref] the CPU side: {cpu['seconds']:.1f} s in a worker process")
    spec = dict(n_cells=2, dtype="float64", with_contact=True, pad=2,
                starts=[r["pre"] for r in rows])
    # both groups at once, each in a thread that waits on its ranks
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        jobs = {(r, b): pool.submit(launch, _sharded_job, r, b, None, (spec,), 300)
                for r, b in ((2, "gloo"), (1, "nccl"))}
        runs = {key: job.result() for key, job in jobs.items()}
    print(f"[sharded-ref] the card side: {time.perf_counter() - t0:.1f} s for both groups")
    st = shard_stepper(build_scene(2, torch.float64, device, with_contact=True), 2)
    step = make_step(st)
    for (ranks, backend), outs in runs.items():
        check(all(o["backend"] == backend for o in outs), f"the {backend} backend ran")
        for k, i in enumerate((8, 9)):
            got = [o["rows"][k] for o in outs]
            for r in got:
                check(r["finite"] and r["ymin"] > 0.0 and not r["intersection"],
                      "sharded reference: finite, above the ground, no intersection")
            check(all(np.array_equal(r["x"], got[0]["x"]) for r in got),
                  "sharded reference: the ranks' x bitwise equal")
            tag = f"sharded-ref {backend} {ranks} rank(s) n_cells=2 float64 step {i}"
            if ranks > 1:
                ref = rows[k]
                _judge(tag, types.SimpleNamespace(**got[0]["stats"]),
                       types.SimpleNamespace(**ref["stats"]),
                       float(np.abs(got[0]["x"] - ref["x"]).max()), ref["sens"], ref["flip"])
                continue
            pre = state_from_numpy(rows[k]["pre"], device, torch.float64)
            s, stats = step(shard_state(pre, st.mesh))
            same = np.array_equal(got[0]["x"], s.x.cpu().numpy())
            same_stats = got[0]["stats"] == dataclasses.asdict(stats)
            print(f"[{tag}]: newton/pcg={stats.newton_iters}/{stats.pcg_iters_total}; "
                  f"against the card's unsharded step over the padded mesh: x bitwise "
                  f"equal={same}, stats equal={same_stats}")
            check(same and same_stats, f"{tag}: the 1-rank group is the unsharded step")


def _battery_dir(*parts):
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "battery", *parts)


def phase_battery_path(device, n=100, n_steps=4):
    """The paper battery's run_one at full width (module docstring, phase
    20), in build/battery/ of this checkout. Returns its tet_hv and ACCD
    launches."""
    import shutil

    import torch

    from ipc_tpu_torch.ops.tet_hv import tet_hv
    from ipc_tpu_torch.tools import paper_battery
    from ipc_tpu_torch.tools.twist_scenes import write_twist_scene

    shutil.rmtree(_battery_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    scene = write_twist_scene(_battery_dir(), n)
    print(f"[battery] wrote {scene} (mat({n}) as .msh) in {time.perf_counter() - t0:.2f} s")
    counts = {}
    _zero_launches()
    t0 = time.perf_counter()
    rec = paper_battery.run_one(scene, n_steps, 240.0, dtype=torch.float32, use_jit=True,
                                device=device, counts=counts)
    wall = time.perf_counter() - t0
    launches, kernels = tet_hv.launches, _kernel_counts()
    print(f"[battery] record {json.dumps(rec)}")
    print(f"[battery] matTwist{n}: {rec['tets']} tets, {rec['verts']} verts, path "
          f"{rec['path']}, {rec['steps']} steps in {rec['secs']} s "
          f"({rec['secs'] / max(rec['steps'], 1):.4f} s per step), newton_iters="
          f"{rec['newton_iters']}, kappa_doublings={rec['kappa_doublings']}, "
          f"peak_mem_bytes={rec['peak_mem_bytes']} ({rec['peak_mem_bytes'] / 2**30:.3f} GiB above "
          f"what was allocated when run_one began), "
          f"tet_hv launches={launches} operator applications="
          f"{counts['operator_applications']} host syncs={counts['host_syncs']}; run_one "
          f"{wall:.2f} s with assembly and the final checks")
    check(rec["status"] == "PASS", "the battery's matTwist100 record is PASS")
    check((rec["path"], rec["steps"], rec["tets"]) == ("jit", n_steps, 6 * n * n),
          "the battery ran the device step for every step at full width")
    check(launches > 0 and launches == counts["operator_applications"],
          "one tet_hv launch per operator application (battery)")
    return _path_launches("battery", launches, *kernels)


STALL_SCENE = """energy NH
timeIntegration BE
time 1 0.025
density 1000
stiffness 1e5 0.4
shapes input 2
input/tetMeshes/box2.msh 0 0.5 0  0 0 0  1 1 1
tri.obj 3 0 0  0 0 0  1 1 1  meshSeq seq
selfCollisionOff
"""


def _battery_sweep_process():
    """Process target: the untimed part of phase 20 (module docstring) on
    the card, in build/battery/."""
    import os

    from ipc_tpu_torch import io_mesh
    from ipc_tpu_torch.models.primitives import box_grid
    from ipc_tpu_torch.tools import batch, battery_summary, gen_status_battery, paper_battery
    from ipc_tpu_torch.tools.twist_scenes import TWIST_SCENE, write_twist_scene

    t0 = time.perf_counter()
    scenes = _battery_dir("sweep")
    os.makedirs(os.path.join(scenes, "seq"))
    write_twist_scene(scenes, 20)
    with open(os.path.join(scenes, "matTwist225.txt"), "w") as f:
        f.write(TWIST_SCENE.format(mesh="input/tetMeshes/mat225x225.msh"))  # absent
    io_mesh.write_msh(os.path.join(scenes, "input", "tetMeshes", "box2.msh"),
                      *box_grid(2, 2, 2))
    tri = (np.array([[0.0, 0, 0], [1, 0, 0], [0, 0, 1]]), np.array([[0, 1, 2]]))
    io_mesh.write_obj(os.path.join(scenes, "tri.obj"), *tri)
    for frame in (0, 1):
        io_mesh.write_obj(os.path.join(scenes, "seq", f"{frame}.obj"), *tri)
    # frame 2, read by step 2, is a pipe nobody writes: the child blocks
    # there for good and is killed at budget + headroom on any host
    os.mkfifo(os.path.join(scenes, "seq", "2.obj"))
    with open(os.path.join(scenes, "meshSeqStall.txt"), "w") as f:
        f.write(STALL_SCENE)
    out = _battery_dir("BATTERY.json")
    rc = paper_battery.main(["--scenes", scenes, "--dtype", "f32", "--steps", "4",
                             "--budget", "60", "--headroom", "30", "--out", out])
    check(rc == 0, "the sweep found its scenes")
    with open(out) as f:
        recs = {r["scene"]: r for r in json.load(f)}
    for r in recs.values():
        print(f"[battery-sweep] {json.dumps(r)}", flush=True)
    check(sorted(recs) == ["matTwist20.txt", "matTwist225.txt", "meshSeqStall.txt"],
          "the sweep recorded every scene")
    ok, skip, stall = (recs[k] for k in ("matTwist20.txt", "matTwist225.txt",
                                         "meshSeqStall.txt"))
    check((ok["status"], ok["path"], ok["steps"], ok["config"]) == ("PASS", "jit", 4, "cuda-f32"),
          "matTwist20 passes on the card's device step")
    check(skip["status"] == "SKIP" and "mat225x225.msh" in skip["reason"],
          "a scene with an absent mesh is SKIP")
    check(stall["status"] == "TIMEOUT", "the stalled child is killed at budget + headroom")
    battery_summary.main([out])
    status = _battery_dir("STATUS.md")
    with open(status, "w") as f:
        f.write("# Battery of the port\n")
    gen_status_battery.main([out, "--status", status])
    with open(status) as f:
        txt = f.read()
    check("generated by ipc_tpu_torch/tools/gen_status_battery.py from BATTERY.json" in txt
          and "**Battery tally over 3 scene records: 1 PASS / 1 SKIP / 1 TIMEOUT / 0 FAIL.**"
          in txt, "gen_status_battery wrote the tally and the table")
    folder, out_dir = _battery_dir("batch"), _battery_dir("batch_out")
    write_twist_scene(folder, 20)
    rc = batch.main([folder, "--out", out_dir, "--steps", "2", "--f32", "--jit-step"])
    written = sorted(os.listdir(os.path.join(out_dir, "matTwist20")))
    print(f"[battery-sweep] batch exit code {rc}, artifacts {written}", flush=True)
    check(rc == 0, "batch ran every scene")
    check({"iterStats.txt", "sysE.txt", "info.txt", "status2.npz", "surf2.obj"} <= set(written),
          "batch wrote its artifacts")
    print(f"[battery-sweep] done in {time.perf_counter() - t0:.1f} s", flush=True)


def start_battery_sweep_process():
    import multiprocessing

    child = multiprocessing.get_context("spawn").Process(target=_battery_sweep_process)
    child.start()
    return child


def join_battery_sweep(child):
    child.join()
    check(child.exitcode == 0, f"the battery sweep passed (exit code {child.exitcode})")


def _card_phases_process(names, sharded_cpu):
    """Process target: the named untimed phases on the card, in order;
    `sharded_cpu` is _sharded_cpu_case's result for the sharded reference."""
    from ipc_tpu_torch.device import require_cuda

    device = require_cuda()
    for name in names:
        t0 = time.perf_counter()
        if name == "diagnostic":
            phase_diagnostic()
        elif name == "sharded_reference":
            phase_sharded_reference(device, sharded_cpu)
        else:
            phase_qp_reference(device)
        print(f"[phase] {name} (child): {time.perf_counter() - t0:.1f} s", flush=True)


def start_card_phases_process(names, sharded_job=None):
    """Phases 16, 17 and 19 in a child process on the same card, beside the
    other references (None when none is run); `sharded_job`: the pool's
    _sharded_cpu_case, waited for here."""
    import multiprocessing

    if not names:
        return None
    sharded_cpu = sharded_job.get() if sharded_job is not None else None
    child = multiprocessing.get_context("spawn").Process(target=_card_phases_process,
                                                         args=(names, sharded_cpu))
    child.start()
    return child


def join_card_phases(child):
    child.join()
    check(child.exitcode == 0, f"the QP reference, the diagnostic and the sharded reference "
          f"passed (exit code {child.exitcode})")


def main(argv=None):
    import argparse
    import multiprocessing

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of ipc_tpu_torch on one GPU "
                                 "(module docstring).")
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after device and build (a check "
                         "of a few phases; the kernels line then counts only their launches)")
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))
    phases = []

    def run(name, fn, *a, always=False):
        if not always and only is not None and name not in only:
            return None
        t0 = time.perf_counter()
        out = fn(*a)
        phases.append((name, time.perf_counter() - t0))
        print(f"[phase] {name}: {phases[-1][1]:.1f} s", flush=True)
        return out

    device, name = run("device", phase_device, always=True)
    run("build", phase_build, always=True)
    # the host reference's CPU side runs in two single-threaded worker
    # processes beside the card phases before it
    pool = cpu_jobs = card_child = sharded_cpu = battery_child = None
    if only is None or {"host_reference", "sharded_reference"} & only:
        pool = multiprocessing.get_context("spawn").Pool(2)
    if only is None or "host_reference" in only:
        cpu_jobs = start_host_reference(pool)
    if only is None or "sharded_reference" in only:
        sharded_cpu = pool.apply_async(_sharded_cpu_case)
    child = None
    try:
        # the timed phases first, alone on the card
        launches = {"tet_hv": 0, "accd": 0, "grid_pairs": 0}

        def add(counts):
            for k, v in (counts or {}).items():
                launches[k] += v

        records, accd, grid = (run("kernel_vs_plain", phase_kernel_vs_plain, device)
                               or (None, None, None))
        run("ground_path", phase_ground_path, device)
        run("broadphase", phase_broadphase, device)
        contact = run("contact_path", phase_contact_path, device)
        qp_lead = None  # the contact path's scene and state after step 7
        if contact is not None:
            add(contact[0])
            qp_lead = contact[1]
        run("bench_timing", phase_bench_timing, device)
        add(run("twist_path", phase_twist_path, device))
        add(run("driver_path", phase_driver_path, device))
        add(run("host_path", phase_host_path, device))
        add(run("qp_path", phase_qp_path, device, qp_lead))
        add(run("sharded_path", phase_sharded_path, device, qp_lead))
        add(run("battery_path", phase_battery_path, device))
        # then the references, which are not timed: the battery's sweep, the
        # host reference, and the QP reference with the diagnostic, in
        # three child processes on the same card beside the others
        if only is None or "battery_path" in only:
            battery_child = start_battery_sweep_process()
        child = start_host_reference_process(cpu_jobs)
        card_child = start_card_phases_process(
            [n for n in ("qp_reference", "diagnostic", "sharded_reference")
             if only is None or n in only], sharded_cpu)
        run("ground_reference", phase_ground_reference, device)
        contact_lead = run("contact_reference", phase_contact_reference, device)
        if contact_lead is None and (only is None or "variants_reference" in only):
            contact_lead = _contact_lead()
        run("variants_reference", phase_variants_reference, device, contact_lead)
        if card_child is not None:
            run("qp_reference+diagnostic+sharded_reference", join_card_phases, card_child,
                always=True)
        run("host_reference", join_host_reference, child)
        if battery_child is not None:
            run("battery_path sweep (child)", join_battery_sweep, battery_child, always=True)
    finally:
        for c in (child, card_child, battery_child):
            if c is not None and c.is_alive():
                c.terminate()
                c.join()
        if pool is not None:
            pool.terminate()
            pool.join()
    print(f"[phase] total {sum(s for _, s in phases):.1f} s")
    if records is None:  # a partial run: time the kernels at one shape alone
        from ipc_tpu_torch.hv_timing import measure

        records = {("driver", 20, "float32"): measure(20, torch.float32, device, "driver")}
        accd = accd_vs_plain(device, ("boxes",))
        grid = grid_vs_plain(device, ("boxes",))
    r = records[("driver", 20, "float32")]  # the driver path's shape and dtype
    a = [accd[("boxes", kind, "float32")] for kind in ("pt", "ee")]  # the landing's sets
    g = grid[("boxes", "float32")]  # the landing's largest grid call
    bound_us = sum(x["bound_us"] for x in a)
    ms = sum(x["kernel_ms"] for x in a)
    print(json.dumps({"kernels": [dict(
        name="tet_hv", route="cuda", source="ipc_tpu_torch/csrc/tet_hv.cu",
        replaces="ipc_tpu/ops/pallas_hv.py:107", launches=launches["tet_hv"],
        max_abs_err=r["max_abs_err"], ms=r["kernel_ms"], plain_ms=r["plain_ms"],
        bound_ms=r["bound_us"] / 1e3, bound_by=r["bound_by"], library_ms=r["library_ms"],
        bound_us=r["bound_us"], share_of_bound=r["share_of_bound"],
    ), dict(
        name="accd", route="cuda", source="ipc_tpu_torch/csrc/accd.cu",
        replaces="ipc_tpu/contact/ccd.py:64", launches=launches["accd"],
        n={"pt": a[0]["n"], "ee": a[1]["n"]}, max_abs_err=max(x["max_abs_diff"] for x in a),
        ms=ms, plain_ms=sum(x["plain_ms"] for x in a), bound_ms=bound_us / 1e3,
        bound_by="bytes", library_ms=None, bound_us=bound_us,
        share_of_bound=bound_us / (1e3 * ms),
    ), dict(
        name="grid_pairs", route="cuda", source="ipc_tpu_torch/csrc/grid_pairs.cu",
        replaces="ipc_tpu/contact/spatial_hash.py:814", launches=launches["grid_pairs"],
        rows=sum(g["rows"]), kept=sum(g["kept"]), equal=g["equal"], ms=g["walk_ms"],
        call_ms=g["call_ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_us"] / 1e3,
        bound_by="bytes", library_ms=None, bound_us=g["bound_us"],
        share_of_bound=g["bound_us"] / (1e3 * g["walk_ms"]),
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
