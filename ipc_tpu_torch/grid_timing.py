"""Time the grid broad phase's walk kernel (csrc/grid_pairs.cu via
contact/spatial_hash.py) on the card beside its plain version, on the grid
calls of the benchmark's three scenes.

    python -m ipc_tpu_torch.grid_timing [twist100 twist225 boxes]

Builds each scene on the card in float32 and steps it with the device step
(jit_step.make_step): the mat twists (n = 100: 60,000 tets; n = 225:
303,750 tets) from rest, the two-box scene (n_cells = 20: 96,000 tets)
after steps 0-7, where the upper cube lands. One step of each
(`scene_calls`) runs with the program's tracing on and the arguments of
every grid call (`fused_candidates`, `et_candidates`) recorded; the call
that walks the most rows is kept. Prints one JSON object per scene with
the step's `broadphase.*` counters, the walk kernel's launches and the
broad phase's host reads over it,
and one per (scene, dtype: the scene's float32 and the same call in
float64):

  rows, kept            (query cell, target) rows the call walks, and the
                        pairs the grid keeps, per family
  equal                 the kernel's pair arrays equal the plain
                        version's on the same card, element for element
  walk_ms               median device ms of the walk alone: every family's
                        count and write passes (hv_timing.device_ms: queued
                        behind a device sleep, L2 flushed before each)
  call_ms, plain_ms     median wall ms of the whole call through the
                        kernel and through the plain version (geometry,
                        cells, registries, the host read and the sorts
                        included)
  bytes, bound_us       what the walk reads once (the query and target
                        columns, the registries and the query cells' ranges)
                        and writes (counts and keys), at 3.35 TB/s
  row_bytes             the bytes a row reads when every row is fetched
                        anew (target id, cell key and box): what the walk
                        reads from L2
"""

import json
import statistics
import sys
import time

import torch

from ipc_tpu_torch.hv_timing import FLUSH_BYTES, HBM_BYTES_PER_S, device_ms

__all__ = ["SCENES", "scene_calls", "twist_sweep", "parts", "largest", "launches_of", "compare",
           "measure"]

# (builder, size, steps before the recorded one)
SCENES = {"twist100": ("build_twist_scene", 100, 0), "twist225": ("build_twist_scene", 225, 0),
          "boxes": ("build_scene", 20, 8)}


def scene_calls(name, device):
    """(calls, counters): the arguments of every grid call in one device
    step of scene `name` (SCENES) on `device`, each (kind, args, kwargs)
    with kind "fused" or "et", and that step's `broadphase.*` counters
    under tracing, with "launches": the walk kernel's launches over it,
    and "reads": its host reads at the broad phase's sites."""
    import dataclasses

    from ipc_tpu_torch import jit_step, scenes
    from ipc_tpu_torch.contact import spatial_hash as SH
    from ipc_tpu_torch.utils import observability as obs

    builder, size, before = SCENES[name]
    kw = {"with_contact": True} if builder == "build_scene" else {}
    st = getattr(scenes, builder)(size, "float32", device, **kw)
    step = jit_step.make_step(st)
    state = st.initial_state()
    aux = jit_step.initial_device_aux(st)
    if aux is not None:
        state = dataclasses.replace(state, aux=aux)
    for _ in range(before):
        state, _ = step(state)
    calls = []
    originals = {"fused": SH.fused_candidates, "et": SH.et_candidates}

    def recorder(kind):
        def call(*args, **kwargs):
            calls.append((kind, [a.clone() if torch.is_tensor(a) else a for a in args],
                          {k: v.clone() if torch.is_tensor(v) else v
                           for k, v in kwargs.items()}))
            return originals[kind](*args, **kwargs)
        return call

    SH.fused_candidates, SH.et_candidates = recorder("fused"), recorder("et")
    launches = SH.grid_pairs.launches
    obs.set_tracing(True)
    try:
        step(state)
    finally:
        obs.set_tracing(False)
        SH.fused_candidates, SH.et_candidates = originals["fused"], originals["et"]
    rec = obs.collect()
    counters = {k: v for k, v in rec["counters"].items() if k.startswith("broadphase.")}
    counters["launches"] = SH.grid_pairs.launches - launches
    counters["reads"] = {k: v for k, v in rec["reads"].items() if k.startswith("broadphase.")}
    return calls, counters


def twist_sweep(n, dtype, device):
    """The grid call of the mat twist's scripted prologue at rest, as the
    device step makes it (jit_step's `scripted_motion` at t = 0, the CCD
    clamp aside): ("fused", args, kwargs) with the script's displacement
    over the first step in the co-moving frame and gap sqrt(dHat)."""
    import math

    from ipc_tpu_torch.scenes import build_twist_scene
    from ipc_tpu_torch.scripting import device_closures

    st = build_twist_scene(n, dtype, device)
    disp_fn, _, _ = device_closures(st.script, st.dtype, st.dt, device)
    x = st.initial_state().x
    disp = st.sc._comoving(disp_fn(x, 0.0, None, None))
    m = st.mesh
    return ("fused", [x, m.surf_verts, m.surf_edges, m.surf_tris, m.dbc_mask, disp,
                      math.sqrt(st.dHat)], {"with_et": True})


def parts(call, dtype=None):
    """`_run`'s arguments (families, gap, tops, swept) of a recorded call,
    its floating tensors cast to `dtype` when given."""
    from ipc_tpu_torch.contact import spatial_hash as SH

    kind, args, kwargs = call
    if dtype is not None:
        args = [a.to(dtype) if torch.is_tensor(a) and a.is_floating_point() else a
                for a in args]
        kwargs = {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v
                  for k, v in kwargs.items()}
    return (SH._fused_parts if kind == "fused" else SH._et_parts)(*args, **kwargs)


def _rows(p):
    return [int(f.n.sum()) for f in p[0]]


def largest(calls):
    """The recorded call that walks the most rows."""
    return max(calls, key=lambda c: sum(_rows(parts(c))))


def launches_of(calls):
    """The walk kernel's launches that `calls` make through `_run_kernel`:
    a count pass per family with queries and a write pass per family whose
    grid keeps a pair. The launches made to find them are not counted."""
    from ipc_tpu_torch.contact import spatial_hash as SH

    launches, n = SH.grid_pairs.launches, 0
    for call in calls:
        fams, gap = parts(call)[:2]
        for f in fams:
            if f.q_boxes.shape[0]:
                n += 1 + int(int(SH.grid_pairs(f, gap).sum()) > 0)
    SH.grid_pairs.launches = launches
    return n


def compare(call, dtype=None):
    """The kernel against the plain version on one call, on its device:
    dict(rows, kept, equal). The launches are not counted as main-path
    launches."""
    from ipc_tpu_torch.contact import spatial_hash as SH

    launches = SH.grid_pairs.launches
    p = parts(call, dtype)
    got = SH._run_kernel(*p)
    want = SH._run_plain(*p)
    SH.grid_pairs.launches = launches
    return dict(rows=_rows(p), kept=[n for _, n in got],
                equal=all(a.shape == b.shape and torch.equal(a, b) and m == n
                          for (a, m), (b, n) in zip(got, want)))


def _wall_ms(fn, reps):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def _walk_bytes(p, kept):
    """(bytes read once and written, bytes a row reads) of the walk."""
    fams = p[0]
    once = 0
    for f, k in zip(fams, kept):
        cols = [f.qc.i0, f.lo, f.n, f.reg.prims, f.q_boxes, f.t_boxes, *f.q_motion,
                *f.t_motion, f.topo.q_v, f.topo.t_v]
        cols += [c for c in (f.topo.q_dbc, f.topo.t_dbc) if c is not None]
        once += sum(c.numel() * c.element_size() for c in cols)
        once += f.reg.cells.key.shape[0] * 8  # target cell keys
        once += 2 * f.qc.i0.shape[0] * 8 + k * 8  # counts, offsets, keys
    row = 8 + 8 + 6 * fams[0].q_boxes.element_size()
    return once, row


def measure(call, dtype=None, reps=5):
    """One record (module docstring) of one recorded call."""
    from ipc_tpu_torch.contact import spatial_hash as SH

    launches = SH.grid_pairs.launches
    rec = compare(call, dtype)
    p = parts(call, dtype)
    fams, gap = p[0], p[1]
    counts = [SH.grid_pairs(f, gap) for f in fams]
    scans = [torch.cumsum(c, dim=0) - c for c in counts]
    totals = [int(c.sum()) for c in counts]
    flush_buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=fams[0].n.device)

    def walk():
        for f, s, t in zip(fams, scans, totals):
            SH.grid_pairs(f, gap)
            SH.grid_pairs(f, gap, s, t)

    rec["walk_ms"] = device_ms(walk, lambda: flush_buf.sum())
    rec["call_ms"] = _wall_ms(lambda: SH._run_kernel(*parts(call, dtype)), reps)
    rec["plain_ms"] = _wall_ms(lambda: SH._run_plain(*parts(call, dtype)), reps)
    SH.grid_pairs.launches = launches  # comparison and timing calls are not main-path launches
    once, row = _walk_bytes(p, rec["kept"])
    rec.update(bytes=once, bound_us=1e6 * once / HBM_BYTES_PER_S, row_bytes=row)
    return rec


def main(argv=None):
    from ipc_tpu_torch.device import require_cuda

    names = (argv if argv is not None else sys.argv[1:]) or list(SCENES)
    device = require_cuda()
    print(f"[grid_timing] {torch.cuda.get_device_name(0)}", flush=True)
    for name in names:
        calls, counters = scene_calls(name, device)
        print(json.dumps(dict(scene=name, calls=len(calls), **counters)), flush=True)
        call = largest(calls)
        for dtype in (torch.float32, torch.float64):
            rec = measure(call, dtype)
            print(json.dumps(dict(scene=name, kind=call[0],
                                  dtype=str(dtype).replace("torch.", ""), **rec)), flush=True)


if __name__ == "__main__":
    main()
