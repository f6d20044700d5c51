"""Dense broad phase: all-pairs AABB overlap over exact-size outputs.

Port of ipc_tpu/contact/broadphase.py, the path `SelfContact` takes below
`DENSE_LIMIT` primitives per side. Primitive AABBs are built from current
positions, optionally swept along a displacement and inflated by a gap; the
(N_a, N_b) overlap mask, the topology/DBC exclusions and the relative-motion
reachability filter select the pairs.

Outputs are exact-size: (n, 2) int64 index pairs from `torch.nonzero`, whose
row-major order is `jnp.nonzero`'s, and the count n as a host int (the JAX
package's fixed capacities and -1 padding are TPU devices; the count stays
so the step's stats compare). `torch.nonzero` reads its size back to the
host: one sync per family (`reading` site "broadphase.nonzero",
utils/observability.py).

`reach_mask` runs in float32 with the 1e-5 threshold inflation whatever the
working dtype, exactly as the JAX package's dense and grid paths do: that is
what makes the dense and grid candidate sets identical. Its sums and its root
are written out in one order (`reach_ok`), so the CPU, the card and the grid's
kernel keep the same pairs.
"""

import torch

from ipc_tpu_torch.ops.distance import dot_ordered, sqrt_rn
from ipc_tpu_torch.utils.observability import reading

__all__ = [
    "vert_aabbs",
    "edge_aabbs",
    "tri_aabbs",
    "prim_motion",
    "reach_ok",
    "reach_mask",
    "overlap_pairs",
    "pt_candidates",
    "ee_candidates",
    "et_candidates",
]


def vert_aabbs(x, verts, disp=None, gap=0.0):
    """(n,2,3) AABBs of vertices, swept along disp and inflated by gap."""
    p = x[verts]
    lo, hi = p, p
    if disp is not None:
        q = p + disp[verts]
        lo, hi = torch.minimum(lo, q), torch.maximum(hi, q)
    return torch.stack([lo - gap, hi + gap], dim=1)


def _prim_aabbs(x, prims, disp, gap):
    p = x[prims]  # (n,k,3)
    lo = p.amin(dim=1)
    hi = p.amax(dim=1)
    if disp is not None:
        q = p + disp[prims]
        lo = torch.minimum(lo, q.amin(dim=1))
        hi = torch.maximum(hi, q.amax(dim=1))
    return torch.stack([lo - gap, hi + gap], dim=1)


def edge_aabbs(x, edges, disp=None, gap=0.0):
    return _prim_aabbs(x, edges, disp, gap)


def tri_aabbs(x, tris, disp=None, gap=0.0):
    return _prim_aabbs(x, tris, disp, gap)


def prim_motion(x, prims, disp):
    """Relative-motion filter inputs of one primitive family: (raw_boxes
    (N,2,3) position AABBs, u (N,3) mean vertex displacement, w (N,) max
    |disp_v - u| over the primitive's vertices); disp=None is a zero
    sweep."""
    p = x[prims] if prims.dim() == 2 else x[prims][:, None, :]
    rb = torch.stack([p.amin(dim=1), p.amax(dim=1)], dim=1)
    if disp is None:
        return rb, torch.zeros_like(rb[:, 0]), torch.zeros_like(rb[:, 0, 0])
    d = disp[prims] if prims.dim() == 2 else disp[prims][:, None, :]
    u = d.mean(dim=1)
    w = torch.sqrt(((d - u[:, None, :]) ** 2).sum(dim=2)).amax(dim=1)
    return rb, u, w


def _f32(t):
    return t.to(torch.float32)


def reach_ok(rb_a, u_a, w_a, rb_b, u_b, w_b, gap):
    """Elementwise (broadcasting) reachability of primitive a against b:
    box_dist(raw_a, raw_b) <= (gap + |u_a - u_b| + w_a + w_b)(1 + 1e-5),
    all in float32, summed as ((0 + 1) + 2) with roots rounded to nearest
    on every device (`dot_ordered`, `sqrt_rn`), as the grid's kernel
    (csrc/grid_pairs.cu) rounds. rb (...,2,3), u (...,3), w (...)."""
    g = torch.clamp(torch.maximum(_f32(rb_a[..., 0, :]) - _f32(rb_b[..., 1, :]),
                                  _f32(rb_b[..., 0, :]) - _f32(rb_a[..., 1, :])), min=0.0)
    d2 = dot_ordered(g, g)
    du = _f32(u_a) - _f32(u_b)
    rel = sqrt_rn(dot_ordered(du, du)) + _f32(w_a) + _f32(w_b)
    gap32 = torch.tensor(gap, dtype=torch.float32, device=rb_a.device)
    infl = torch.tensor(1.0 + 1e-5, dtype=torch.float32, device=rb_a.device)
    reach = (gap32 + rel) * infl
    return d2 <= reach * reach


def reach_mask(motion_a, motion_b, gap):
    """(na, nb) bool: the pair CAN come within `gap` along the sweep."""
    rb_a, u_a, w_a = motion_a
    rb_b, u_b, w_b = motion_b
    return reach_ok(rb_a[:, None], u_a[:, None], w_a[:, None],
                    rb_b[None], u_b[None], w_b[None], gap)


def overlap_pairs(boxes_a, boxes_b, valid_mask):
    """(i, j) with overlapping AABBs and valid_mask[i, j], row-major:
    ((n,2) int64, n)."""
    lo_a, hi_a = boxes_a[:, 0], boxes_a[:, 1]
    lo_b, hi_b = boxes_b[:, 0], boxes_b[:, 1]
    sep = ((lo_a[:, None, :] > hi_b[None, :, :])
           | (lo_b[None, :, :] > hi_a[:, None, :])).any(dim=2)
    mask = ~sep & valid_mask
    with reading("broadphase.nonzero"):
        pairs = torch.nonzero(mask)
    return pairs, int(pairs.shape[0])


def pt_candidates(x, surf_verts, surf_tris, dbc_mask, disp=None, gap=0.0):
    """Point-triangle candidates (svI, sfI): no vertex of its own triangle,
    not all four vertices DBC."""
    vb = vert_aabbs(x, surf_verts, disp, gap)
    tb = tri_aabbs(x, surf_tris, disp, gap)
    in_tri = (surf_verts[:, None, None] == surf_tris[None, :, :]).any(dim=2)
    all_dbc = dbc_mask[surf_verts][:, None] & dbc_mask[surf_tris].all(dim=1)[None, :]
    valid = ~in_tri & ~all_dbc
    valid = valid & reach_mask(prim_motion(x, surf_verts, disp),
                               prim_motion(x, surf_tris, disp), gap)
    return overlap_pairs(vb, tb, valid)


def et_candidates(x, surf_edges, surf_tris, disp=None, gap=0.0, dbc_mask=None):
    """Edge-triangle candidates (eI, sfI) for the intersection check: no
    shared vertex, not all-DBC on both sides."""
    eb = edge_aabbs(x, surf_edges, disp, gap)
    tb = tri_aabbs(x, surf_tris, disp, gap)
    shared = (surf_edges[:, None, :, None] == surf_tris[None, :, None, :]).any(dim=3).any(dim=2)
    valid = ~shared
    if dbc_mask is not None:
        e_dbc = dbc_mask[surf_edges].all(dim=1)
        t_dbc = dbc_mask[surf_tris].all(dim=1)
        valid = valid & ~(e_dbc[:, None] & t_dbc[None, :])
    valid = valid & reach_mask(prim_motion(x, surf_edges, disp),
                               prim_motion(x, surf_tris, disp), gap)
    return overlap_pairs(eb, tb, valid)


def ee_candidates(x, surf_edges, dbc_mask, disp=None, gap=0.0):
    """Edge-edge candidates (eI, eJ), eI < eJ: no shared vertex, not both
    edges all-DBC."""
    eb = edge_aabbs(x, surf_edges, disp, gap)
    ne = surf_edges.shape[0]
    shared = (surf_edges[:, None, :, None] == surf_edges[None, :, None, :]).any(dim=3).any(dim=2)
    idx = torch.arange(ne, device=surf_edges.device)
    upper = idx[:, None] < idx[None, :]
    all_dbc = dbc_mask[surf_edges].all(dim=1)
    valid = upper & ~shared & ~(all_dbc[:, None] & all_dbc[None, :])
    em = prim_motion(x, surf_edges, disp)
    valid = valid & reach_mask(em, em, gap)
    return overlap_pairs(eb, eb, valid)
