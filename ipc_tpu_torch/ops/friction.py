"""Lagged smoothed-Coulomb friction kernels.

Port of ipc_tpu/ops/friction.py (reference FrictionUtils.hpp): the static-
friction clamping functions f0/f1/f2 (x2 is the squared tangential relative
displacement norm, eps the smoothing band; valid for x2 <= eps^2, callers
switch to the linear |x| regime above), and for self-contact the per-type
tangent bases, closest-point coordinates and relative-displacement weights.
The stencil functions are batched over a leading axis: ctype (N,) int64,
stencils (N, 4, 3); `jax.lax.switch` over the type becomes every branch
evaluated and one selected (ops/distance.select).
"""

import torch

from ipc_tpu_torch.ops.distance import cross, dot, select

__all__ = [
    "f0_sf",
    "f1_sf_over_x",
    "f2_sf",
    "tangent_basis",
    "closest_point_coords",
    "rel_dx",
    "rel_dx_weights",
]


def f0_sf(x2, eps, order: int = 1):
    if order == 0:
        return x2 / (2.0 * eps) + eps / 2.0
    if order == 1:
        return x2 * (-torch.sqrt(x2) / 3.0 + eps) / (eps * eps) + eps / 3.0
    if order == 2:
        return x2 * (0.25 * x2 - (torch.sqrt(x2) - 1.5 * eps) * eps) / (eps**3) + eps / 4.0
    raise ValueError(f"unsupported clamping order {order}")


def f1_sf_over_x(x2, eps, order: int = 1):
    """f0'(|x|) / |x| — the factor applied to the tangential direction."""
    if order == 0:
        return torch.ones_like(x2) / eps
    if order == 1:
        return (-torch.sqrt(x2) + 2.0 * eps) / (eps * eps)
    if order == 2:
        return (x2 - (3.0 * torch.sqrt(x2) - 3.0 * eps) * eps) / (eps**3)
    raise ValueError(f"unsupported clamping order {order}")


def f2_sf(x2, eps, order: int = 1):
    """Curvature term used by the friction Hessian."""
    if order == 0:
        return torch.ones_like(x2) / eps
    if order == 1:
        return 2.0 * (eps - torch.sqrt(x2)) / (eps * eps)
    if order == 2:
        return 3.0 * (x2 - (2.0 * torch.sqrt(x2) - eps) * eps) / (eps**3)
    raise ValueError(f"unsupported clamping order {order}")


# ---------------------------------------------------------------------------
# tangent bases (N,3,2): columns orthonormal, spanning the sliding plane
# ---------------------------------------------------------------------------


def _normalize(v):
    n = torch.sqrt(dot(v, v))
    return v / torch.where(n > 0, n, torch.ones_like(n))[..., None]


def _basis_pt(x):
    v12 = x[:, 2] - x[:, 1]
    c0 = _normalize(v12)
    c1 = _normalize(cross(cross(v12, x[:, 3] - x[:, 1]), v12))
    return torch.stack([c0, c1], dim=-1)


def _basis_ee(x):
    v01 = x[:, 1] - x[:, 0]
    c0 = _normalize(v01)
    c1 = _normalize(cross(cross(v01, x[:, 3] - x[:, 2]), v01))
    return torch.stack([c0, c1], dim=-1)


def _basis_pe(x):
    v12 = x[:, 2] - x[:, 1]
    c0 = _normalize(v12)
    c1 = _normalize(cross(v12, x[:, 0] - x[:, 1]))
    return torch.stack([c0, c1], dim=-1)


def _basis_pp(x):
    v01 = x[:, 1] - x[:, 0]
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=x.dtype, device=x.device).expand_as(v01)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=x.dtype, device=x.device).expand_as(v01)
    xc = cross(ex, v01)
    yc = cross(ey, v01)
    first = torch.where((dot(xc, xc) > dot(yc, yc))[:, None], xc, yc)
    c0 = _normalize(first)
    c1 = _normalize(cross(v01, first))
    return torch.stack([c0, c1], dim=-1)


def tangent_basis(ctype, x):
    """(N,3,2) tangent bases of stencils x (N,4,3) of types ctype (N,)."""
    return select(ctype[:, None, None],
                  [_basis_pp(x), _basis_pe(x), _basis_pt(x), _basis_ee(x)])


# ---------------------------------------------------------------------------
# closest-point coordinates (N,2); unused slots zero
# ---------------------------------------------------------------------------


def _cp_pt(x):
    e1 = x[:, 2] - x[:, 1]
    e2 = x[:, 3] - x[:, 1]
    r = x[:, 0] - x[:, 1]
    a = dot(e1, e1)
    b = dot(e1, e2)
    c = dot(e2, e2)
    det = a * c - b * b
    det = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
    b1 = (c * dot(e1, r) - b * dot(e2, r)) / det
    b2 = (a * dot(e2, r) - b * dot(e1, r)) / det
    return torch.stack([b1, b2], dim=-1)


def _cp_ee(x):
    e01 = x[:, 1] - x[:, 0]
    e23 = x[:, 3] - x[:, 2]
    e20 = x[:, 0] - x[:, 2]
    a = dot(e01, e01)
    b = -dot(e23, e01)
    c = dot(e23, e23)
    det = a * c - b * b
    det = torch.where(torch.abs(det) > 0, det, torch.ones_like(det))
    r0 = -dot(e20, e01)
    r1 = dot(e20, e23)
    g1 = (c * r0 - b * r1) / det
    g2 = (a * r1 - b * r0) / det
    return torch.stack([g1, g2], dim=-1)


def _cp_pe(x):
    e12 = x[:, 2] - x[:, 1]
    eta = dot(x[:, 0] - x[:, 1], e12) / dot(e12, e12)
    return torch.stack([eta, torch.zeros_like(eta)], dim=-1)


def closest_point_coords(ctype, x):
    """(N,2) closest-point coordinates of stencils x (N,4,3)."""
    zero = torch.zeros(x.shape[:1] + (2,), dtype=x.dtype, device=x.device)
    return select(ctype[:, None], [zero, _cp_pe(x), _cp_pt(x), _cp_ee(x)])


# ---------------------------------------------------------------------------
# relative displacement: relDX = sum_i w_i dx_i with per-type weights
# ---------------------------------------------------------------------------


def rel_dx_weights(ctype, coords):
    """(N,4) weights: PP (1,-1,0,0), PE (1,eta-1,-eta,0),
    PT (1,b1+b2-1,-b1,-b2), EE (1-g1,g1,g2-1,-g2)."""
    c0, c1 = coords[:, 0], coords[:, 1]
    one = torch.ones_like(c0)
    zero = torch.zeros_like(c0)
    return select(ctype[:, None], [
        torch.stack([one, -one, zero, zero], dim=-1),
        torch.stack([one, c0 - 1.0, -c0, zero], dim=-1),
        torch.stack([one, c0 + c1 - 1.0, -c0, -c1], dim=-1),
        torch.stack([1.0 - c0, c0, c1 - 1.0, -c1], dim=-1),
    ])


def rel_dx(ctype, coords, dx):
    """(N,3) relative displacements of stencil displacements dx (N,4,3)."""
    return torch.einsum("ni,nij->nj", rel_dx_weights(ctype, coords), dx)
