"""Edge-triangle intersection test: the line-search and post-step failsafe.

Port of ipc_tpu/contact/intersection.py (reference checkEdgeTriIntersection).
Signed-volume orientation tests with a position-aware noise filter: a
determinant below 16 eps X mpp counts as degenerate (0), with eps 1e-15 in
float64 and 1.2e-7 in float32 (ipc_tpu/contact/intersection.py:43).
Batched over a leading axis of points (N,3).

`any_edge_tri_intersection`, the test the step runs, evaluates in float64
whatever the working dtype; the JAX package evaluates in the working dtype.
In float32 a flat box face that has warped by ~1e-5 puts the endpoints of
an in-face edge on both sides of a neighbouring in-face triangle's plane
(a real crossing of the plane, just above the noise filter), while the
three in-plane volumes that decide "through the triangle" are float32
noise and filter to 0, which counts as inside: a phantom intersection
between disjoint primitives of one face. The line search then rejects
every trial down to alpha ~1e-6. Float32 coordinates are exact in float64,
whose volumes resolve that geometry (a 96,000-tet float32 scene hit it
from its third step; a float64 scene gives the same answers either way).
"""

import torch

from ipc_tpu_torch.ops.distance import cross, dot

__all__ = ["segment_triangle_intersects", "any_edge_tri_intersection"]


def _orient_sign(a, b, c, d):
    u, v, w = b - a, c - a, d - a
    det = dot(cross(u, v), w)
    X = torch.stack([a, b, c, d], dim=-2).abs().amax(dim=(-2, -1))
    um, vm, wm = u.abs().amax(dim=-1), v.abs().amax(dim=-1), w.abs().amax(dim=-1)
    mpp = torch.maximum(torch.maximum(um * vm, um * wm), vm * wm)
    eps = 1e-15 if det.dtype == torch.float64 else 1.2e-7
    thr = 16.0 * eps * X * mpp
    return torch.where(det.abs() <= thr, torch.zeros_like(det), torch.sign(det))


def segment_triangle_intersects(p, q, a, b, c):
    """True where segment (p,q) properly crosses triangle (a,b,c): the
    endpoints strictly on opposite sides of the plane and the segment
    through the closed triangle; coplanar or touching is False."""
    crosses = _orient_sign(a, b, c, p) * _orient_sign(a, b, c, q) < 0.0
    s1 = _orient_sign(p, q, a, b)
    s2 = _orient_sign(p, q, b, c)
    s3 = _orient_sign(p, q, c, a)
    inside = ((s1 >= 0) & (s2 >= 0) & (s3 >= 0)) | ((s1 <= 0) & (s2 <= 0) & (s3 <= 0))
    return crosses & inside


def any_edge_tri_intersection(x, edge_vids, tri_vids, pairs):
    """0-d bool: any proper intersection among (edge, tri) index pairs
    (n,2) (shared-vertex pairs already excluded by the broad phase),
    evaluated in float64."""
    if pairs.shape[0] == 0:
        return torch.zeros((), dtype=torch.bool, device=x.device)
    e = edge_vids[pairs[:, 0]]
    t = tri_vids[pairs[:, 1]]

    def at(ids):
        return x[ids].to(torch.float64)

    hit = segment_triangle_intersects(at(e[:, 0]), at(e[:, 1]), at(t[:, 0]), at(t[:, 1]),
                                      at(t[:, 2]))
    return hit.any()
