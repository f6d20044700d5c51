"""Surface proximity for the reference: candidate pairs, closest points and
edge-triangle crossings, in plain PyTorch (float64).

`near_pairs` finds every pair of primitives whose bounding boxes come
within `r` of each other with a uniform grid (cell side at least the
largest box plus r, so only the 27 neighbouring cells can hold a partner).
`pt_closest` and `ee_closest` give the closest points of point-triangle
and segment-segment pairs as barycentric weights over the pair's four
vertices: the squared distance is |sum_i w_i x_i|^2, and with the weights
held fixed its gradient is the distance's own (the closest point is a
minimiser). `segment_crosses_triangle` is the exact test of an edge
passing through a triangle.
"""

import torch

__all__ = ["near_pairs", "pt_closest", "ee_closest", "segment_crosses_triangle"]


def _boxes(x, prims):
    p = x[prims]
    return p.amin(dim=1), p.amax(dim=1)


def near_pairs(x, prims_a, prims_b, r, chunk=1 << 22):
    """(ia, ib) int64: every pair whose boxes (over the primitives' vertex
    positions x) lie within r of each other on all three axes."""
    lo_a, hi_a = _boxes(x, prims_a)
    lo_b, hi_b = _boxes(x, prims_b)
    ext = torch.maximum((hi_a - lo_a).max(), (hi_b - lo_b).max())
    cell = float(ext) + r + 1e-12
    base = torch.minimum(lo_a.amin(0), lo_b.amin(0))
    ca = torch.floor(((lo_a + hi_a) * 0.5 - base) / cell).to(torch.int64)
    cb = torch.floor(((lo_b + hi_b) * 0.5 - base) / cell).to(torch.int64)
    dims = torch.maximum(ca.amax(0), cb.amax(0)) + 3
    key_b = ((cb[:, 0] + 1) * dims[1] + cb[:, 1] + 1) * dims[2] + cb[:, 2] + 1
    key_b, order = torch.sort(key_b)
    out_a, out_b = [], []
    offs = torch.tensor([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
                        device=x.device)
    na = prims_a.shape[0]
    step = max(1, chunk // 27)
    for s in range(0, na, step):
        ia0 = torch.arange(s, min(na, s + step), device=x.device)
        c = ca[ia0][:, None, :] + offs[None] + 1  # (n,27,3)
        key = (c[..., 0] * dims[1] + c[..., 1]) * dims[2] + c[..., 2]
        start = torch.searchsorted(key_b, key.reshape(-1), right=False)
        stop = torch.searchsorted(key_b, key.reshape(-1), right=True)
        cnt = stop - start
        total = int(cnt.sum())
        if total == 0:
            continue
        ia = torch.repeat_interleave(ia0.repeat_interleave(27), cnt)
        first = torch.repeat_interleave(start - torch.cumsum(cnt, 0) + cnt, cnt)
        ib = order[first + torch.arange(total, device=x.device)]
        ok = ((lo_a[ia] <= hi_b[ib] + r) & (lo_b[ib] <= hi_a[ia] + r)).all(dim=1)
        out_a.append(ia[ok])
        out_b.append(ib[ok])
    if not out_a:
        z = torch.zeros(0, dtype=torch.int64, device=x.device)
        return z, z
    return torch.cat(out_a), torch.cat(out_b)


def _dot(a, b):
    return (a * b).sum(-1)


def _seg_param(p, a, b):
    ab = b - a
    den = _dot(ab, ab)
    return torch.clamp(_dot(p - a, ab) / torch.where(den > 0, den, torch.ones_like(den)),
                       0.0, 1.0)


def pt_closest(p, t0, t1, t2):
    """Weights (N,4) over (p, t0, t1, t2) of p minus its closest point on
    the triangle (Ericson, Real-Time Collision Detection, 5.1.5)."""
    ab, ac, ap = t1 - t0, t2 - t0, p - t0
    d1, d2 = _dot(ab, ap), _dot(ac, ap)
    bp = p - t1
    d3, d4 = _dot(ab, bp), _dot(ac, bp)
    cp = p - t2
    d5, d6 = _dot(ab, cp), _dot(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    den = va + vb + vc
    den = torch.where(den != 0, den, torch.ones_like(den))
    # interior
    v, w = vb / den, vc / den
    bary = torch.stack([1.0 - v - w, v, w], dim=-1)

    def on_edge(i, j, pt, a, b):
        s = _seg_param(pt, a, b)
        out = torch.zeros_like(bary)
        out[:, i] = 1.0 - s
        out[:, j] = s
        return out

    e01 = on_edge(0, 1, p, t0, t1)
    e02 = on_edge(0, 2, p, t0, t2)
    e12 = on_edge(1, 2, p, t1, t2)
    sel = [
        ((d1 <= 0) & (d2 <= 0), torch.tensor([1.0, 0.0, 0.0], dtype=p.dtype, device=p.device)),
        ((d3 >= 0) & (d4 <= d3), torch.tensor([0.0, 1.0, 0.0], dtype=p.dtype, device=p.device)),
        ((d6 >= 0) & (d5 <= d6), torch.tensor([0.0, 0.0, 1.0], dtype=p.dtype, device=p.device)),
        ((vc <= 0) & (d1 >= 0) & (d3 <= 0), e01),
        ((vb <= 0) & (d2 >= 0) & (d6 <= 0), e02),
        ((va <= 0) & ((d4 - d3) >= 0) & ((d5 - d6) >= 0), e12),
    ]
    taken = torch.zeros_like(d1, dtype=torch.bool)
    for cond, val in sel:
        use = cond & ~taken
        bary = torch.where(use[:, None], val.expand_as(bary), bary)
        taken = taken | cond
    return torch.cat([torch.ones_like(bary[:, :1]), -bary], dim=1)


def ee_closest(a0, a1, b0, b1):
    """Weights (N,4) over (a0, a1, b0, b1) of the closest points' difference
    on two segments (Ericson 5.1.9, with the parallel case handled)."""
    d1, d2, r = a1 - a0, b1 - b0, a0 - b0
    a, e, f = _dot(d1, d1), _dot(d2, d2), _dot(d2, r)
    c, b = _dot(d1, r), _dot(d1, d2)
    den = a * e - b * b
    par = den <= 1e-14 * a * e
    s = torch.where(par, torch.zeros_like(a),
                    torch.clamp((b * f - c * e) / torch.where(par, torch.ones_like(den), den),
                                0.0, 1.0))
    t = (b * s + f) / torch.where(e > 0, e, torch.ones_like(e))
    s = torch.where(t < 0, torch.clamp(-c / a, 0.0, 1.0), s)
    s = torch.where(t > 1, torch.clamp((b - c) / a, 0.0, 1.0), s)
    t = torch.clamp(t, 0.0, 1.0)
    # one more pass: the point of b nearest a's chosen point
    t = _seg_param(a0 + s[:, None] * d1, b0, b1)
    s = _seg_param(b0 + t[:, None] * d2, a0, a1)
    t = _seg_param(a0 + s[:, None] * d1, b0, b1)
    return torch.stack([1.0 - s, s, -(1.0 - t), -t], dim=1)


def segment_crosses_triangle(e0, e1, t0, t1, t2):
    """(N,) bool: the closed segment e0-e1 meets the triangle's interior
    or boundary at a single point (coplanar touching is left out)."""
    n = torch.cross(t1 - t0, t2 - t0, dim=-1)
    s0 = _dot(e0 - t0, n)
    s1 = _dot(e1 - t0, n)
    straddle = (s0 * s1 <= 0) & (s0 != s1)
    lam = s0 / torch.where(s0 != s1, s0 - s1, torch.ones_like(s0))
    q = e0 + lam[:, None] * (e1 - e0)
    c0 = _dot(torch.cross(t1 - t0, q - t0, dim=-1), n)
    c1 = _dot(torch.cross(t2 - t1, q - t1, dim=-1), n)
    c2 = _dot(torch.cross(t0 - t2, q - t2, dim=-1), n)
    inside = ((c0 >= 0) & (c1 >= 0) & (c2 >= 0)) | ((c0 <= 0) & (c1 <= 0) & (c2 <= 0))
    return straddle & inside
