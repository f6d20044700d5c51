"""The rank processes' work for `python -m ipc_tpu_torch.parallel`.

A job is `fn(rank, world, device, spec)`, run by parallel/launch.py on
every rank, with a dict `spec` of plain values; it returns plain values.
Collectives inside a job run in the same order on every rank.

  rank_step  (stepper, step): spec's two-box scene on the device, cut to
             the rank's shard, and its make_step;
  steps      a rank's records of n steps from a state: the stats, the
             rank's own pair counts, operator applications, tet_hv,
             ACCD and grid walk launches (over the step), collectives, wall seconds, the state's checks
             (finite, ymin, the edge-triangle test) and x;
  rank_info  the rank, backend, device, shard_report and the modules of
             jax or the JAX package the process has loaded (none);
  step_job   the CLI's run: spec["steps"] steps from rest.
"""

import dataclasses
import sys
import time

import torch

__all__ = ["rank_step", "steps", "rank_info", "step_job"]


def rank_step(rank, world, device, spec, pad=None):
    """(stepper, step) of scenes.build_scene(spec's n_cells, dtype,
    with_contact) on device, sharded for rank of world (pad: the rank count
    the mesh is padded for, default world)."""
    from ipc_tpu_torch.jit_step import make_step
    from ipc_tpu_torch.parallel.sharding import shard_stepper
    from ipc_tpu_torch.scenes import build_scene

    st = build_scene(spec["n_cells"], spec["dtype"], device,
                     with_contact=spec.get("with_contact", True))
    st = shard_stepper(st, world, rank, pad=pad)
    return st, make_step(st)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def steps(st, step, s, n):
    """(the state after n steps of `step` from s, [one record per step])
    (module docstring)."""
    from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt
    from ipc_tpu_torch.contact.spatial_hash import grid_pairs
    from ipc_tpu_torch.ops.tet_hv import tet_hv

    rows = []
    for _ in range(n):
        ops0, launches0, coll0 = step.operator_applications, tet_hv.launches, step.collectives
        accd0 = accd_pt.launches + accd_ee.launches
        grid0 = grid_pairs.launches
        _sync(st.device)
        t0 = time.perf_counter()
        s, stats = step(s)
        _sync(st.device)
        wall = time.perf_counter() - t0
        grid = grid_pairs.launches - grid0
        hit, _ = st.sc.has_intersection(s.x) if st.sc is not None else (False, 0)
        rows.append(dict(
            stats=dataclasses.asdict(stats), wall_s=wall,
            operator_applications=step.operator_applications - ops0,
            tet_hv_launches=tet_hv.launches - launches0,
            accd_launches=accd_pt.launches + accd_ee.launches - accd0, grid_launches=grid,
            collectives=step.collectives - coll0, rank_counts=dict(step.rank_counts or {}),
            finite=bool(torch.isfinite(s.x).all() and torch.isfinite(s.v).all()),
            ymin=s.x[:, 1].min().item(), intersection=bool(hit), x=s.x.cpu().numpy()))
    return s, rows


def rank_info(st, rank):
    """dict(rank, backend, device, report, foreign_modules) of this rank."""
    import torch.distributed as dist

    from ipc_tpu_torch.parallel import spmd
    from ipc_tpu_torch.parallel.sharding import shard_report

    return dict(rank=rank, backend=dist.get_backend(spmd.active_group()),
                device=str(st.device), report=shard_report(st.mesh, None, st.shard),
                foreign_modules=sorted(m for m in sys.modules
                                       if m.split(".")[0] in ("jax", "jaxlib", "ipc_tpu")))


def step_job(rank, world, device, spec):
    """spec["steps"] (default 1) steps of spec's scene from rest on rank's
    shard: rank_info plus rows, the steps' records."""
    from ipc_tpu_torch.parallel.sharding import replicate

    st, step = rank_step(rank, world, device, spec)
    _, rows = steps(st, step, replicate(st.initial_state()), spec.get("steps", 1))
    return dict(rank_info(st, rank), rows=rows)
