"""Uniform-grid spatial hash: the broad phase above `DENSE_LIMIT`.

Port of the single-device half of ipc_tpu/contact/spatial_hash.py
(`fused_candidates` :814-908, `et_candidates` :788). The contract is the
candidate SET: for each family, every (query, target) pair whose swept,
gap-inflated AABBs overlap and that passes the family's validity and
reach filters — the set the dense path (contact/broadphase.py) emits. The
port returns it in the dense path's order too (ascending (query, target)),
so grid and dense runs give identical arrays.

The TPU design (fixed-K bucket table, packed int32 payload rows, tiled
queries, overflow regrow) serves fixed shapes. This is the usual GPU
design instead:

  1. cell size = the largest finite AABB extent (x 1.001), so every box
     spans at most 2 cells per axis: at most 8 cells, keyed exactly by
     their coordinates (21 bits each in an int64; no hash, no collisions);
  2. targets register in each of their cells; one stable sort by key;
  3. each query cell finds its targets' range by binary search
     (`searchsorted`);
  4. a (query cell, target) row is kept only in the pair's canonical cell
     max(q_i0, t_i0) (it lies in both spans whenever the boxes overlap, so
     every overlapping pair is found exactly once), then the exact AABB
     test in the working dtype, the family's validity test and the float32
     reach test (broadphase.reach_ok) — the dense path's arithmetic, bit
     for bit. The kept keys q * n_t + t are sorted once.

Step 4 has two routes, chosen by the device and by nothing else. On a CUDA
device the walk kernel (csrc/grid_pairs.cu, `grid_pairs`) tests the rows
in registers, one warp per query primitive striding its cells' registry
ranges, and writes no row out: a count pass writes each query's kept
pairs; their exclusive scan (`cumsum`) gives each query its offset; one
host read ("broadphase.counts") brings back every family's kept total,
the dense sweep's counts and the largest cell coordinate (the 21-bit
check); the write pass (none for a family that keeps nothing) writes
the kept keys at their offsets, placed within a warp by ballot and popc,
so their order is the same in every run. No tensor has an element per
row: the expansion of the largest mat twist (303,750 tets) is some 357M
rows a call, of which 0.6% are kept.
On the CPU, and only there, the plain version (`_run_plain`) expands the
rows to exact size (`repeat_interleave`) in chunks of at most BUDGET rows
and tests them in PyTorch, with one host read for the expansion sizes and
the range check ("broadphase.totals"), one for the kept counts
("broadphase.counts") and one more per family whose expansion is split
("broadphase.chunks"). A CUDA tensor never reaches it: the kernel
launches or the call raises. Each launch counts in `grid_pairs.launches`
(utils/observability). Both routes keep the same pairs (reach_ok writes its
rounding order out).

Counters (utils/observability.py): on the host, always,
`broadphase.calls` (grid calls) and `broadphase.kernel_calls` (calls that
launched the kernel); while tracing is on, `broadphase.rows` ((query cell,
target) rows walked, summed on the device) and `broadphase.kept` (pairs
the grid kept, big sweep aside, from the read that happens anyway). kept /
rows is the share of the walk that the cell size spends on pairs it
rejects.

Boxes with non-finite coordinates register nowhere and query nothing, and
they do not move the grid's origin or cell size.

Oversized ("big") primitives (ipc_tpu/contact/spatial_hash.py:453-910):
one kinematic plane triangle would set the cell size until every
deformable primitive shares a handful of cells. `SelfContact._classify_big`
names them once from the rest shape; `big` = dict(tri_ids, tri_mask,
edge_ids, edge_mask) (None entries where a family has none). They stay out
of the geometry, the registries and the query rows, and a dense sweep
tests every query primitive against each of them: one masked (Q, B)
product, chunked over Q, with the same AABB, validity and reach tests.
Its pairs join the grid's before the one sort, so grid plus sweep returns
the dense path's pairs in the dense path's order (an edge-edge pair as
(lower, higher) id). The passes, complete and disjoint with the grid's
small x small pairs: PT vertices x big triangles; EE all edges x big edges
(a big-big pair once); ET all edges x big triangles, then small triangles
x big edges.

Sharded (`fused_candidates(..., shard=(rank, world))`, the counterpart of
the JAX package's `fused_candidates_spmd`; `et_candidates` takes `shard=`
too):
every rank holds the whole replicated x, so it builds the geometry and both
registries over ALL targets and expands only ITS contiguous share of the
query rows (the PT query vertices, the EE and ET query edges: `q_range`).
Its pairs are the full set's pairs whose query falls in its share, so the
ranks' sets are disjoint and their union is `fused_candidates`' set, in
rank order the same ascending order. The JAX package's ring instead
builds each rank's registry over its target shard and passes the shards
round with `ppermute`; that needs point-to-point transfers, which gloo
does not take on CUDA tensors. The cost of this choice: the AABBs (6
floats per primitive), the motion columns and the two registries (8 int64
keys plus 8 int64 ids per target triangle and edge) are replicated on every
rank, O(S + E) each, where the ring holds 1/n of them. Only the walk (the
rows of the rank's queries) and the emitted pairs shrink with n. At 96,000 tets (9,600 surface triangles,
14,400 surface edges) the registries are 3.1 MB per rank.
"""

from collections import namedtuple

import torch

from ipc_tpu_torch.contact import broadphase as BP
from ipc_tpu_torch.parallel.sharding import row_range
from ipc_tpu_torch.utils.observability import count, count_device, host_read, tracing

__all__ = ["grid_geometry", "fused_candidates", "et_candidates", "grid_pairs"]

_BITS = 21  # per-axis cell coordinate bits of the int64 key
_BIG = torch.iinfo(torch.int64).max
_OFFS = [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)]
BUDGET = 1 << 25  # expanded (query cell, target) rows per chunk


def _finite(boxes):
    return torch.isfinite(boxes).all(dim=2).all(dim=1)


def grid_geometry(*box_groups, excludes=None):
    """(origin (3,), cell 0-d) shared by several AABB sets; non-finite
    boxes, and those of `excludes` (per-group bool masks or None), are left
    out of both."""
    ref = box_groups[0]
    exts, los = [], []
    for b, ex in zip(box_groups, excludes or (None,) * len(box_groups)):
        if b.shape[0] == 0:
            continue
        fin = _finite(b)
        if ex is not None:
            fin = fin & ~ex
        fin = fin[:, None]
        exts.append(torch.where(fin, b[:, 1] - b[:, 0], torch.zeros_like(b[:, 0])).amax())
        los.append(torch.where(fin, b[:, 0], torch.full_like(b[:, 0], float("inf")))
                   .amin(dim=0))
    zero = torch.zeros((), dtype=ref.dtype, device=ref.device)
    ext = torch.clamp(torch.stack(exts).amax(), min=0.0) if exts else zero
    # margin >> f32 eps so floor((lo+ext)/cell) - floor(lo/cell) <= 1
    cell = torch.clamp(ext, min=1e-30) * 1.001
    origin = torch.stack(los).amin(dim=0) if los else zero.expand(3)
    origin = torch.where(torch.isfinite(origin), origin, torch.zeros_like(origin))
    return origin, cell


class _Cells:
    """Cells of one AABB set: i0 (N,3) int64, corner keys (N,8), corner ok
    (N,8) (a real, distinct cell of a finite box not in `exclude`), and the
    largest cell coordinate (0-d, for the range check)."""

    def __init__(self, boxes, origin, cell, exclude=None):
        fin = _finite(boxes)
        if exclude is not None:
            fin = fin & ~exclude
        b = torch.where(fin[:, None, None], boxes, origin.expand_as(boxes))
        i0 = torch.floor((b[:, 0] - origin) / cell).to(torch.int64)
        i1 = torch.floor((b[:, 1] - origin) / cell).to(torch.int64)
        span = torch.clamp(i1 - i0, 0, 1)
        offs = torch.tensor(_OFFS, dtype=torch.int64, device=boxes.device)
        corner = i0[:, None, :] + offs[None]
        self.i0 = i0
        self.corner = corner
        self.ok = (offs[None] <= span[:, None, :]).all(dim=-1) & fin[:, None]
        self.key = (corner[..., 0] << (2 * _BITS)) | (corner[..., 1] << _BITS) | corner[..., 2]
        self.top = i1.amax() if i1.shape[0] else torch.zeros((), dtype=torch.int64,
                                                             device=boxes.device)


class _Registry:
    """Targets registered in their cells, sorted by cell key (stable:
    ascending target id within a cell). Invalid corners carry the key
    _BIG, which no query cell asks for."""

    def __init__(self, cells):
        n = cells.key.shape[0]
        keys = torch.where(cells.ok, cells.key, torch.full_like(cells.key, _BIG)).reshape(-1)
        prims = torch.arange(n, device=keys.device).repeat_interleave(8)
        self.keys, order = torch.sort(keys, stable=True)
        self.prims = prims[order]
        self.cells = cells


Topo = namedtuple("Topo", "kind q_v t_v q_dbc t_dbc")
Topo.__doc__ = """One family's validity inputs: kind ("pt", "ee" or "et"), the
query and target vertex ids (Nq, KQ) / (Nt, KT) int64, and their all-DBC
bits (Nq,) / (Nt,) bool, or None for no DBC test."""


def _topology(kind, surf_verts, surf_edges, surf_tris, dbc_mask):
    """Topo of family `kind` over the surface."""
    q_v = surf_verts[:, None] if kind == "pt" else surf_edges
    t_v = surf_edges if kind == "ee" else surf_tris
    if dbc_mask is None:
        return Topo(kind, q_v, t_v, None, None)
    return Topo(kind, q_v, t_v, dbc_mask[q_v].all(dim=1), dbc_mask[t_v].all(dim=1))


def _valid(topo):
    """valid(q, t): no shared vertex, not both all-DBC, and q < t for
    edge-edge pairs."""

    def valid(q, t):
        shared = (topo.q_v[q][:, :, None] == topo.t_v[t][:, None, :]).any(dim=2).any(dim=1)
        ok = ~shared
        if topo.kind == "ee":
            ok = ok & (q < t)
        if topo.q_dbc is not None:
            ok = ok & ~(topo.q_dbc[q] & topo.t_dbc[t])
        return ok

    return valid


class _Family:
    """One query family against one registry: query cells, their target
    ranges and the per-pair filter."""

    def __init__(self, qcells, reg, q_boxes, t_boxes, q_motion, t_motion, topo, n_t,
                 q_range=None):
        self.qc, self.reg = qcells, reg
        self.q_boxes, self.t_boxes = q_boxes, t_boxes
        self.q_motion, self.t_motion = q_motion, t_motion
        self.topo = topo
        self.n_t = n_t
        qk = qcells.key.reshape(-1)
        self.lo = torch.searchsorted(reg.keys, qk, side="left")
        hi = torch.searchsorted(reg.keys, qk, side="right")
        ok = qcells.ok
        if q_range is not None:
            # a rank's share of the queries: the other rows expand nothing
            q = torch.arange(ok.shape[0], device=ok.device)[:, None]
            ok = ok & (q >= q_range[0]) & (q < q_range[1])
        self.n = torch.where(ok.reshape(-1), hi - self.lo, torch.zeros_like(self.lo))

    def keys(self, a, b, total, gap):
        """Sort keys q * n_t + t of the kept pairs among query cells [a, b)
        (total expanded rows; rejected rows get _BIG): the plain version."""
        dev = self.n.device
        n = self.n[a:b]
        qc = a + torch.repeat_interleave(torch.arange(b - a, device=dev), n,
                                         output_size=total)
        start = torch.cumsum(n, dim=0) - n
        off = torch.arange(total, device=dev) - start[qc - a]
        t = self.reg.prims[self.lo[qc] + off]
        q = qc // 8
        read = self.qc.corner.reshape(-1, 3)[qc]
        canon = (read == torch.maximum(self.qc.i0[q], self.reg.cells.i0[t])).all(dim=-1)
        qb, tb = self.q_boxes[q], self.t_boxes[t]
        sep = ((qb[:, 0] > tb[:, 1]) | (tb[:, 0] > qb[:, 1])).any(dim=-1)
        qm = [m[q] for m in self.q_motion]
        tm = [m[t] for m in self.t_motion]
        keep = canon & ~sep & _valid(self.topo)(q, t) & BP.reach_ok(*qm, *tm, gap)
        return torch.where(keep, q * self.n_t + t, torch.full_like(q, _BIG))


def grid_pairs(fam, gap, offsets=None, total=0):
    """One pass of the walk kernel (csrc/grid_pairs.cu) over family `fam`
    on its CUDA device: the count pass (offsets None) returns each query's
    kept pairs (Nq,) int64; the write pass, given their exclusive scan
    `offsets` and their sum `total`, returns the kept keys q * n_t + t
    (total,) int64 in the kernel's order. A launch (none without queries,
    and no write pass when `total` is 0) counts in `grid_pairs.launches`."""
    from ipc_tpu_torch.build import load_kernels

    q_box = fam.q_boxes
    dev, nq = q_box.device, int(q_box.shape[0])
    write = offsets is not None
    out = torch.empty((total if write else nq,), dtype=torch.int64, device=dev)
    if write and total == 0:
        return out

    topo = fam.topo
    fn = getattr(load_kernels(),
                 f"ipc_grid_{topo.kind}_{'f32' if q_box.dtype == torch.float32 else 'f64'}")
    # held until the launch is queued: a temporary's memory could be reused
    args = [None if a is None else a.contiguous() for a in (
        fam.qc.i0, fam.lo, fam.n, fam.reg.prims, fam.reg.cells.key[:, 0], q_box, fam.t_boxes,
        *fam.q_motion, *fam.t_motion, topo.q_v, topo.t_v, topo.q_dbc, topo.t_dbc, offsets)]
    err = fn(*[None if a is None else a.data_ptr() for a in args[:-1]], nq, fam.n_t,
             float(gap), int(write), None if write else out.data_ptr(),
             args[-1].data_ptr() if write else None, out.data_ptr() if write else None,
             torch.cuda.current_stream(dev).cuda_stream)
    if nq:
        count("grid_pairs.launches")
    if err != 0:
        raise RuntimeError(f"grid_pairs ({topo.kind}): CUDA launch failed with error {err}")
    return out


def _chunks(fam, total):
    """Query-cell ranges [a, b) with their expanded sizes, each at most
    BUDGET rows unless one query cell alone exceeds it (one host read when
    it splits)."""
    QC = int(fam.n.shape[0])
    if total <= BUDGET:
        return [(0, QC, total)]
    cum = torch.cumsum(fam.n, dim=0)
    cum_pad = torch.cat([torch.zeros(1, dtype=cum.dtype, device=cum.device), cum])
    marks = torch.arange(1, -(-total // BUDGET), device=cum.device,
                         dtype=torch.int64) * BUDGET
    cuts = torch.searchsorted(cum, marks, side="right")  # non-decreasing
    cuts_h, at_h = host_read("broadphase.chunks", cuts, cum_pad[cuts])
    bounds = [(0, 0)] + list(zip(cuts_h, at_h)) + [(QC, total)]
    return [(a, b, sb - sa) for (a, sa), (b, sb) in zip(bounds, bounds[1:]) if b > a]


def _check_top(top):
    if top >= (1 << _BITS):
        raise ValueError("broad phase: a cell coordinate exceeds the grid key's 21 bits")


def _pairs(f, sk):
    """(pairs (n,2), n) of family f from its sorted kept keys."""
    pairs = torch.stack([sk // f.n_t, sk % f.n_t], dim=1)
    return pairs, int(pairs.shape[0])


def _run(families, gap, tops, swept=None):
    """Pairs of every family: list of ((n,2) int64, n). swept: per family,
    the key tensors of its dense big sweep. The walk kernel on a CUDA
    device, the plain version on the CPU."""
    dev = families[0].n.device
    count("broadphase.calls")
    if tracing():
        count_device("broadphase.rows", torch.stack([f.n.sum() for f in families]).sum())
    return (_run_kernel if dev.type == "cuda" else _run_plain)(families, gap, tops, swept)


def _run_kernel(families, gap, tops, swept=None):
    """`_run` on the card: the count pass of every family, one host read
    (the kept totals, the dense sweep's counts and the range check), then
    the write pass of each family that keeps a pair and one sort per
    family."""
    counts = [grid_pairs(f, gap) for f in families]
    count("broadphase.kernel_calls")
    dense = swept or [[] for _ in families]
    read = host_read("broadphase.counts", torch.stack(
        [c.sum() for c in counts] + [(k != _BIG).sum() for ks in dense for k in ks]
        + [torch.stack(tops).amax()]))
    _check_top(read[-1])
    totals, kept_dense = read[:len(families)], iter(read[len(families):-1])
    if tracing():
        count("broadphase.kept", sum(totals))
    out = []
    for f, c, total, ks in zip(families, counts, totals, dense):
        parts = [grid_pairs(f, gap, torch.cumsum(c, dim=0) - c, total)]
        parts += [torch.sort(k).values[:next(kept_dense)] for k in ks]
        out.append(_pairs(f, torch.sort(torch.cat(parts)).values))
    return out


def _run_plain(families, gap, tops, swept=None):
    """`_run`'s plain version: each family's rows expanded to exact size in
    chunks of at most BUDGET (`_Family.keys`), then sorted."""
    totals = host_read("broadphase.totals", *[f.n.sum() for f in families],
                       torch.stack(tops).amax())
    _check_top(totals[-1])
    keys, grid = [], 0
    for i, (f, total) in enumerate(zip(families, totals[:-1])):
        ks = [f.keys(a, b, size, gap) for a, b, size in _chunks(f, total) if size > 0]
        keys.append((len(ks), ks + (swept[i] if swept else [])))
    flat = [(k != _BIG).sum() for _, ks in keys for k in ks]
    flat = host_read("broadphase.counts", torch.stack(flat)) if flat else []
    out, i = [], 0
    for f, (n_grid, ks) in zip(families, keys):
        grid += sum(flat[i:i + n_grid])
        parts = [torch.sort(k).values[:m] for k, m in zip(ks, flat[i:])]
        sk = torch.sort(torch.cat(parts)).values if len(parts) > 1 else (
            parts[0] if parts else torch.zeros((0,), dtype=torch.int64, device=f.n.device))
        out.append(_pairs(f, sk))
        i += len(ks)
    if tracing():
        count("broadphase.kept", grid)
    return out


def _ee_dense_valid(topo, edge_big):
    """EE validity of the dense pass (t a big edge): a big-big pair once
    (q < t), a small-big pair whatever the order."""
    base = _valid(topo)

    def valid(q, t):
        return base(torch.minimum(q, t), torch.maximum(q, t)) & (~edge_big[q] | (q < t))

    return valid


def _te_dense_valid(topo, tri_big):
    """Triangle (q) against big edge (t): the ET validity; big triangles
    left out (the all-edges x big-triangles pass has them)."""
    base = _valid(topo)

    def valid(q, t):
        ok = base(t, q)
        return ok if tri_big is None else ok & ~tri_big[q]

    return valid


def _dense_keys(q_boxes, q_motion, t_ids, t_boxes, t_motion, valid_fn, gap, key_fn):
    """The dense sweep of one family: every query row q against each big
    target t of `t_ids` (B of them), in chunks of at most BUDGET pairs.
    Returns a list of key tensors, key_fn(q, t) for a kept pair and _BIG
    for a rejected one; the tests are the grid's (AABB overlap in the
    working dtype, validity, float32 reach)."""
    Q, B = int(q_boxes.shape[0]), int(t_ids.shape[0])
    dev = t_ids.device
    out = []
    rows = max(1, BUDGET // max(B, 1))
    for a in range(0, Q if B else 0, rows):
        n = min(Q, a + rows) - a
        q = torch.arange(a, a + n, dtype=torch.int64, device=dev).repeat_interleave(B)
        j = torch.arange(B, dtype=torch.int64, device=dev).repeat(n)
        t = t_ids[j]
        qb, tb = q_boxes[q], t_boxes[j]
        sep = ((qb[:, 0] > tb[:, 1]) | (tb[:, 0] > qb[:, 1])).any(dim=-1)
        qm = [m[q] for m in q_motion]
        tm = [m[j] for m in t_motion]
        keep = ~sep & valid_fn(q, t) & BP.reach_ok(*qm, *tm, gap)
        out.append(torch.where(keep, key_fn(q, t), torch.full_like(q, _BIG)))
    return out


def _gather(m, ids):
    return [a[ids] for a in m]


def _big_parts(big):
    """(tri_ids, tri_mask, edge_ids, edge_mask) of a `big` dict or None."""
    if not big:
        return None, None, None, None
    return big.get("tri_ids"), big.get("tri_mask"), big.get("edge_ids"), big.get("edge_mask")


def _et_dense(eb, em, tb, tm, et_topo, big, gap):
    """The two dense ET passes: all edges x big triangles, then small
    triangles x big edges (keys edge * nS + triangle)."""
    bt_ids, bt_mask, be_ids, _ = _big_parts(big)
    nS = int(tb.shape[0])
    keys = []
    if bt_ids is not None:
        keys += _dense_keys(eb, em, bt_ids, tb[bt_ids], _gather(tm, bt_ids), _valid(et_topo),
                            gap, lambda q, t: q * nS + t)
    if be_ids is not None:
        keys += _dense_keys(tb, tm, be_ids, eb[be_ids], _gather(em, be_ids),
                            _te_dense_valid(et_topo, bt_mask), gap,
                            lambda q, t: t * nS + q)
    return keys


def _share(n_rows, shard):
    """(start, stop) of the rows of shard = (rank, world), or None."""
    return None if shard is None else row_range(n_rows, *shard)


def _check(x, disp, index_arrays, widths):
    """The refusals of fused_candidates / et_candidates: x (V,3) float32 or
    float64 on the CPU or a CUDA device, disp None or x's like, index
    arrays int64 (n,) or (n, width) on x's device."""
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"broad phase: x {tuple(x.shape)} must be (V,3)")
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"broad phase: x {x.dtype} must be float32 or float64")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"broad phase: unsupported device {x.device}")
    if disp is not None and (disp.shape != x.shape or disp.dtype != x.dtype
                             or disp.device != x.device):
        raise ValueError(f"broad phase: disp {tuple(disp.shape)} {disp.dtype} on {disp.device}"
                         f" must match x {tuple(x.shape)} {x.dtype} on {x.device}")
    for a, w in zip(index_arrays, widths):
        shape_ok = a.dim() == 1 if w is None else (a.dim() == 2 and a.shape[1] == w)
        if not shape_ok or a.dtype != torch.int64 or a.device != x.device:
            raise ValueError(f"broad phase: index array {tuple(a.shape)} {a.dtype} on "
                             f"{a.device} must be int64 {'(n,)' if w is None else (-1, w)} "
                             f"on {x.device}")


def _fused_parts(x, surf_verts, surf_edges, surf_tris, dbc_mask, disp=None, gap=0.0,
                 with_et=True, big=None, shard=None):
    """fused_candidates' arguments of `_run`: (families, gap, tops, swept)."""
    if shard is not None and big:
        raise ValueError("fused_candidates: a sharded query takes no big primitives")
    _check(x, disp, (surf_verts, surf_edges, surf_tris), (None, 2, 3))
    vb = BP.vert_aabbs(x, surf_verts, disp, gap)
    eb = BP.edge_aabbs(x, surf_edges, disp, gap)
    tb = BP.tri_aabbs(x, surf_tris, disp, gap)
    vm = BP.prim_motion(x, surf_verts, disp)
    em = BP.prim_motion(x, surf_edges, disp)
    tm = BP.prim_motion(x, surf_tris, disp)
    bt_ids, bt_mask, be_ids, be_mask = _big_parts(big)
    origin, cell = grid_geometry(vb, eb, tb, excludes=(None, be_mask, bt_mask))
    vc = _Cells(vb, origin, cell)
    ec = _Cells(eb, origin, cell, be_mask)
    tc = _Cells(tb, origin, cell, bt_mask)
    treg, ereg = _Registry(tc), _Registry(ec)
    nS, nE = int(surf_tris.shape[0]), int(surf_edges.shape[0])
    topo = {k: _topology(k, surf_verts, surf_edges, surf_tris, dbc_mask)
            for k in ("pt", "ee", "et")}
    vr = _share(int(surf_verts.shape[0]), shard)
    er = _share(nE, shard)
    fams = [
        _Family(vc, treg, vb, tb, vm, tm, topo["pt"], nS, vr),
        _Family(ec, ereg, eb, eb, em, em, topo["ee"], nE, er),
    ]
    if with_et:
        fams.append(_Family(ec, treg, eb, tb, em, tm, topo["et"], nS, er))
    swept = None
    if big:
        swept = [[], []]
        if bt_ids is not None:
            swept[0] = _dense_keys(vb, vm, bt_ids, tb[bt_ids], _gather(tm, bt_ids),
                                   _valid(topo["pt"]), gap, lambda q, t: q * nS + t)
        if be_ids is not None:
            swept[1] = _dense_keys(eb, em, be_ids, eb[be_ids], _gather(em, be_ids),
                                   _ee_dense_valid(topo["ee"], be_mask), gap,
                                   lambda q, t: torch.minimum(q, t) * nE + torch.maximum(q, t))
        if with_et:
            swept.append(_et_dense(eb, em, tb, tm, topo["et"], big, gap))
    return fams, gap, [vc.top, ec.top, tc.top], swept


def fused_candidates(x, surf_verts, surf_edges, surf_tris, dbc_mask, disp=None, gap=0.0,
                     with_et=True, big=None, shard=None):
    """One broad phase serving the three queries of a Newton iteration:
    one shared geometry, one triangle registry (PT and ET queries) and one
    edge registry (EE), plus the dense sweep of the `big` primitives.
    Returns dict(pt=(pairs, n), ee=(pairs, n), et=(pairs, n)); with_et=False
    gives an empty ET set. shard = (rank, world) keeps the pairs of rank's
    share of the query rows (module docstring; not with `big`)."""
    out = _run(*_fused_parts(x, surf_verts, surf_edges, surf_tris, dbc_mask, disp, gap,
                             with_et, big, shard))
    if not with_et:
        out.append((torch.zeros((0, 2), dtype=torch.int64, device=x.device), 0))
    return dict(pt=out[0], ee=out[1], et=out[2])


def _et_parts(x, surf_edges, surf_tris, disp=None, gap=0.0, dbc_mask=None, big=None,
              shard=None):
    """et_candidates' arguments of `_run`: (families, gap, tops, swept)."""
    if shard is not None and big:
        raise ValueError("et_candidates: a sharded query takes no big primitives")
    _check(x, disp, (surf_edges, surf_tris), (2, 3))
    eb = BP.edge_aabbs(x, surf_edges, disp, gap)
    tb = BP.tri_aabbs(x, surf_tris, disp, gap)
    em = BP.prim_motion(x, surf_edges, disp)
    tm = BP.prim_motion(x, surf_tris, disp)
    _, bt_mask, _, be_mask = _big_parts(big)
    origin, cell = grid_geometry(eb, tb, excludes=(be_mask, bt_mask))
    ec, tc = _Cells(eb, origin, cell, be_mask), _Cells(tb, origin, cell, bt_mask)
    topo = _topology("et", None, surf_edges, surf_tris, dbc_mask)
    fam = _Family(ec, _Registry(tc), eb, tb, em, tm, topo, int(surf_tris.shape[0]),
                  _share(int(surf_edges.shape[0]), shard))
    swept = [_et_dense(eb, em, tb, tm, topo, big, gap)] if big else None
    return [fam], gap, [ec.top, tc.top], swept


def et_candidates(x, surf_edges, surf_tris, disp=None, gap=0.0, dbc_mask=None, big=None,
                  shard=None):
    """Edge-triangle pairs alone (with the dense sweep of the `big`
    primitives): ((n,2) int64, n). shard = (rank, world): the
    pairs of rank's share of the edges (not with `big`)."""
    (res,) = _run(*_et_parts(x, surf_edges, surf_tris, disp, gap, dbc_mask, big, shard))
    return res
