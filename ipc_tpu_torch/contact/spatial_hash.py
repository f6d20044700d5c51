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
     (`searchsorted`), and the (query, target) pairs of all ranges expand
     to exact size (`repeat_interleave`);
  4. a pair is kept only in its canonical cell max(q_i0, t_i0) (it lies in
     both spans whenever the boxes overlap, so every overlapping pair is
     found exactly once), then the exact AABB test in the working dtype,
     the family's validity test and the float32 reach test
     (broadphase.reach_ok) — the dense path's arithmetic, bit for bit.

Boxes with non-finite coordinates register nowhere and query nothing, and
they do not move the grid's origin or cell size. Host reads: one for the
expansion sizes (and the coordinate-range check), one for the kept counts;
one more when the expansion is split into chunks (`budget`).

Not ported yet: the dense sweep of oversized ("big") primitives and the
SPMD ring query (`fused_candidates_spmd`); `SelfContact` refuses scenes
that need the first.
"""

import torch

from ipc_tpu_torch.contact import broadphase as BP

__all__ = ["grid_geometry", "fused_candidates", "et_candidates"]

_BITS = 21  # per-axis cell coordinate bits of the int64 key
_BIG = torch.iinfo(torch.int64).max
_OFFS = [[a, b, c] for a in (0, 1) for b in (0, 1) for c in (0, 1)]
BUDGET = 1 << 25  # expanded (query cell, target) rows per chunk


def _finite(boxes):
    return torch.isfinite(boxes).all(dim=2).all(dim=1)


def grid_geometry(*box_groups):
    """(origin (3,), cell 0-d) shared by several AABB sets; non-finite
    boxes are left out of both."""
    ref = box_groups[0]
    exts, los = [], []
    for b in box_groups:
        if b.shape[0] == 0:
            continue
        fin = _finite(b)[:, None]
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
    (N,8) (a real, distinct cell of a finite box), and the largest cell
    coordinate (0-d, for the range check)."""

    def __init__(self, boxes, origin, cell):
        fin = _finite(boxes)
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


class _Family:
    """One query family against one registry: query cells, their target
    ranges and the per-pair filter."""

    def __init__(self, qcells, reg, q_boxes, t_boxes, q_motion, t_motion, valid_fn, n_t):
        self.qc, self.reg = qcells, reg
        self.q_boxes, self.t_boxes = q_boxes, t_boxes
        self.q_motion, self.t_motion = q_motion, t_motion
        self.valid_fn = valid_fn
        self.n_t = n_t
        qk = qcells.key.reshape(-1)
        self.lo = torch.searchsorted(reg.keys, qk, side="left")
        hi = torch.searchsorted(reg.keys, qk, side="right")
        self.n = torch.where(qcells.ok.reshape(-1), hi - self.lo, torch.zeros_like(self.lo))

    def keys(self, a, b, total, gap):
        """Sort keys q * n_t + t of the kept pairs among query cells [a, b)
        (total expanded rows; rejected rows get _BIG)."""
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
        keep = canon & ~sep & self.valid_fn(q, t) & BP.reach_ok(*qm, *tm, gap)
        return torch.where(keep, q * self.n_t + t, torch.full_like(q, _BIG))


def _chunks(fam, total):
    """Query-cell ranges [a, b) with their expanded sizes, each at most
    BUDGET rows unless one query cell alone exceeds it. Returns the list
    and the number of host reads it took (0 or 1)."""
    QC = int(fam.n.shape[0])
    if total <= BUDGET:
        return [(0, QC, total)], 0
    cum = torch.cumsum(fam.n, dim=0)
    cum_pad = torch.cat([torch.zeros(1, dtype=cum.dtype, device=cum.device), cum])
    marks = torch.arange(1, -(-total // BUDGET), device=cum.device,
                         dtype=torch.int64) * BUDGET
    cuts = torch.searchsorted(cum, marks, side="right")  # non-decreasing
    cuts_h, at_h = torch.stack([cuts, cum_pad[cuts]]).tolist()
    bounds = [(0, 0)] + list(zip(cuts_h, at_h)) + [(QC, total)]
    return [(a, b, sb - sa) for (a, sa), (b, sb) in zip(bounds, bounds[1:]) if b > a], 1


def _run(families, gap, tops):
    """Pairs of every family: list of ((n,2) int64, n), and the host reads
    made."""
    totals = torch.stack([f.n.sum() for f in families] + [torch.stack(tops).amax()]).tolist()
    syncs = 1
    if totals[-1] >= (1 << _BITS):
        raise ValueError("broad phase: a cell coordinate exceeds the grid key's 21 bits")
    keys = []
    for f, total in zip(families, totals[:-1]):
        chunks, s = _chunks(f, total)
        syncs += s
        keys.append([f.keys(a, b, size, gap) for a, b, size in chunks if size > 0])
    counts = [[(k != _BIG).sum() for k in ks] for ks in keys]
    flat = [c for cs in counts for c in cs]
    flat = torch.stack(flat).tolist() if flat else []
    syncs += 1 if flat else 0
    out = []
    i = 0
    for f, ks in zip(families, keys):
        parts = []
        for k in ks:
            parts.append(torch.sort(k).values[:flat[i]])
            i += 1
        sk = torch.sort(torch.cat(parts)).values if len(parts) > 1 else (
            parts[0] if parts else torch.zeros((0,), dtype=torch.int64, device=f.n.device))
        pairs = torch.stack([sk // f.n_t, sk % f.n_t], dim=1)
        out.append((pairs, int(pairs.shape[0])))
    return out, syncs


def _pt_valid(surf_verts, surf_tris, dbc_mask):
    v_dbc = dbc_mask[surf_verts]
    t_dbc = dbc_mask[surf_tris].all(dim=1)

    def valid(q, t):
        vid = surf_verts[q][:, None]
        in_tri = (vid == surf_tris[t]).any(dim=1)
        return ~in_tri & ~(v_dbc[q] & t_dbc[t])

    return valid


def _ee_valid(surf_edges, dbc_mask):
    e_dbc = dbc_mask[surf_edges].all(dim=1)

    def valid(q, t):
        shared = (surf_edges[q][:, :, None] == surf_edges[t][:, None, :]).any(dim=2).any(dim=1)
        return (q < t) & ~shared & ~(e_dbc[q] & e_dbc[t])

    return valid


def _et_valid(surf_edges, surf_tris, dbc_mask):
    e_dbc = None if dbc_mask is None else dbc_mask[surf_edges].all(dim=1)
    t_dbc = None if dbc_mask is None else dbc_mask[surf_tris].all(dim=1)

    def valid(q, t):
        shared = (surf_edges[q][:, :, None] == surf_tris[t][:, None, :]).any(dim=2).any(dim=1)
        ok = ~shared
        if e_dbc is not None:
            ok = ok & ~(e_dbc[q] & t_dbc[t])
        return ok

    return valid


def fused_candidates(x, surf_verts, surf_edges, surf_tris, dbc_mask, disp=None, gap=0.0,
                     with_et=True):
    """One broad phase serving the three queries of a Newton iteration:
    one shared geometry, one triangle registry (PT and ET queries) and one
    edge registry (EE). Returns dict(pt=(pairs, n), ee=(pairs, n),
    et=(pairs, n), host_syncs=int); with_et=False gives an empty ET set."""
    vb = BP.vert_aabbs(x, surf_verts, disp, gap)
    eb = BP.edge_aabbs(x, surf_edges, disp, gap)
    tb = BP.tri_aabbs(x, surf_tris, disp, gap)
    vm = BP.prim_motion(x, surf_verts, disp)
    em = BP.prim_motion(x, surf_edges, disp)
    tm = BP.prim_motion(x, surf_tris, disp)
    origin, cell = grid_geometry(vb, eb, tb)
    vc, ec, tc = (_Cells(b, origin, cell) for b in (vb, eb, tb))
    treg, ereg = _Registry(tc), _Registry(ec)
    nS, nE = int(surf_tris.shape[0]), int(surf_edges.shape[0])
    fams = [
        _Family(vc, treg, vb, tb, vm, tm, _pt_valid(surf_verts, surf_tris, dbc_mask), nS),
        _Family(ec, ereg, eb, eb, em, em, _ee_valid(surf_edges, dbc_mask), nE),
    ]
    if with_et:
        fams.append(_Family(ec, treg, eb, tb, em, tm,
                            _et_valid(surf_edges, surf_tris, dbc_mask), nS))
    out, syncs = _run(fams, gap, [vc.top, ec.top, tc.top])
    if not with_et:
        out.append((torch.zeros((0, 2), dtype=torch.int64, device=x.device), 0))
    return dict(pt=out[0], ee=out[1], et=out[2], host_syncs=syncs)


def et_candidates(x, surf_edges, surf_tris, disp=None, gap=0.0, dbc_mask=None):
    """Edge-triangle pairs alone: ((n,2) int64, n, host_syncs)."""
    eb = BP.edge_aabbs(x, surf_edges, disp, gap)
    tb = BP.tri_aabbs(x, surf_tris, disp, gap)
    em = BP.prim_motion(x, surf_edges, disp)
    tm = BP.prim_motion(x, surf_tris, disp)
    origin, cell = grid_geometry(eb, tb)
    ec, tc = _Cells(eb, origin, cell), _Cells(tb, origin, cell)
    fam = _Family(ec, _Registry(tc), eb, tb, em, tm,
                  _et_valid(surf_edges, surf_tris, dbc_mask), int(surf_tris.shape[0]))
    (res,), syncs = _run([fam], gap, [ec.top, tc.top])
    return res[0], res[1], syncs
