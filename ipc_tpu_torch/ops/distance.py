"""Unsigned SQUARED distance kernels for contact stencils, the closest-point
type classifiers and the parallel edge-edge mollifier.

Port of ipc_tpu/ops/distance.py (reference MeshCollisionUtils.hpp). Every
function is batched over leading axes: points are (..., 3) tensors, stencils
(..., 4, 3), codes (...,) int64 tensors; the same code runs on one stencil
under `torch.func.vmap` (the pair derivatives of contact/selfcollision.py).

`jax.lax.switch` over a traced code, as the JAX package writes it under
`vmap`, evaluates every branch and selects; the port says so directly: each
branch is computed and `torch.where` picks one. `_safe_div` keeps every
branch finite on any input, so an unselected branch never puts a NaN into a
value or into a derivative taken through the selection.

ctype codes (CTYPE_*): 0 = PP (x0,x1), 1 = PE (x0; x1,x2),
2 = PT (x0; x1,x2,x3), 3 = EE (x0,x1; x2,x3).

Not ported: `stencil_dist2_grad` / `stencil_dist2_hess` (jax.grad /
jax.hessian of one stencil); the port differentiates the pair energies
with `torch.func` instead (contact/selfcollision.py).
"""

import numpy as np
import torch

__all__ = [
    "CTYPE_PP",
    "CTYPE_PE",
    "CTYPE_PT",
    "CTYPE_EE",
    "d_PP",
    "d_PE",
    "d_PT",
    "d_EE",
    "stencil_dist2",
    "point_edge_dist2",
    "point_triangle_dist2",
    "edge_edge_dist2",
    "dtype_PT",
    "dtype_EE",
    "dot_ordered",
    "sqrt_rn",
    "ee_cross_sq_norm",
    "eps_x_ee",
    "mollifier_ee",
]

CTYPE_PP = 0
CTYPE_PE = 1
CTYPE_PT = 2
CTYPE_EE = 3


def dot(a, b):
    return (a * b).sum(-1)


def dot_ordered(a, b):
    """dot(a, b) of 3-vectors summed as ((0 + 1) + 2) on every device: the
    order of ATen's CPU sum, where its CUDA sum takes (0 + 2) + 1. The
    plain ACCD (contact/ccd.py) and the broad phase's reach test
    (contact/broadphase.reach_ok) compute with it, so that the CPU, the card
    and the kernels (csrc/accd.cu, csrc/grid_pairs.cu) round alike."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def sqrt_rn(v):
    """Square roots rounded to nearest, as CUDA's and the kernels' are:
    ATen's CPU sqrt misses the nearest value for about 1% of inputs (a
    vectorised approximation), numpy's does not."""
    if v.device.type == "cpu":
        return torch.from_numpy(np.sqrt(v.detach().numpy()))
    return torch.sqrt(v)


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _safe_div(num, den):
    """num/den with a guarded denominator: degenerate lanes give finite
    garbage instead of NaN (callers select or mask them out)."""
    ok = den > 0
    return torch.where(ok, num, torch.zeros_like(num)) / torch.where(
        ok, den, torch.ones_like(den))


def select(code, branches):
    """branches[code] elementwise: every branch evaluated, one selected."""
    out = branches[0]
    for k in range(1, len(branches)):
        out = torch.where(code == k, branches[k], out)
    return out


# ---------------------------------------------------------------------------
# squared distances (smooth in the interior of their classification region)
# ---------------------------------------------------------------------------


def d_PP(p0, p1, dot=dot):
    d = p0 - p1
    return dot(d, d)


def d_PE(p, e0, e1, dot=dot):
    e = e1 - e0
    c = cross(e, p - e0)
    return _safe_div(dot(c, c), dot(e, e))


def d_PT(p, t0, t1, t2, dot=dot):
    n = cross(t1 - t0, t2 - t0)
    q = dot(p - t0, n)
    return _safe_div(q * q, dot(n, n))


def d_EE(a0, a1, b0, b1, dot=dot):
    n = cross(a1 - a0, b1 - b0)
    q = dot(a0 - b0, n)
    return _safe_div(q * q, dot(n, n))


def stencil_dist2(ctype, x):
    """Squared distance of reduced stencils x (..., 4, 3) of types ctype."""
    x0, x1, x2, x3 = x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :]
    return select(ctype, [d_PP(x0, x1), d_PE(x0, x1, x2), d_PT(x0, x1, x2, x3),
                          d_EE(x0, x1, x2, x3)])


# ---------------------------------------------------------------------------
# region-aware distances (broad-phase checks, CCD)
# ---------------------------------------------------------------------------


def point_edge_dist2(p, e0, e1):
    e = e1 - e0
    t = torch.clamp(_safe_div(dot(p - e0, e), dot(e, e)), 0.0, 1.0)
    d = p - (e0 + t[..., None] * e)
    return dot(d, d)


def point_triangle_dist2(p, t0, t1, t2, dot=dot):
    """Region-aware squared point-triangle distance via the dType code;
    `dot` sums every dot product (dot_ordered for a fixed order)."""
    return select(dtype_PT(p, t0, t1, t2, dot), [
        d_PP(p, t0, dot), d_PP(p, t1, dot), d_PP(p, t2, dot),
        d_PE(p, t0, t1, dot), d_PE(p, t1, t2, dot), d_PE(p, t2, t0, dot),
        d_PT(p, t0, t1, t2, dot),
    ])


def edge_edge_dist2(a0, a1, b0, b1, dot=dot):
    """Region-aware squared edge-edge distance via the dType code; `dot`
    as in point_triangle_dist2."""
    return select(dtype_EE(a0, a1, b0, b1, dot), [
        d_PP(a0, b0, dot), d_PP(a0, b1, dot), d_PE(a0, b0, b1, dot),
        d_PP(a1, b0, dot), d_PP(a1, b1, dot), d_PE(a1, b0, b1, dot),
        d_PE(b0, a0, a1, dot), d_PE(b1, a0, a1, dot),
        d_EE(a0, a1, b0, b1, dot),
    ])


# ---------------------------------------------------------------------------
# closest-point-type classifiers
# ---------------------------------------------------------------------------


def _edge_region_params(p, e0, e1, n, dot=dot):
    e = e1 - e0
    out = cross(e, n)
    r = p - e0
    return _safe_div(dot(r, e), dot(e, e)), _safe_div(dot(r, out), dot(out, out))


def _code(*pairs, default):
    """Nested where: the first true condition's code, else `default`."""
    out = torch.full_like(pairs[0][0], default, dtype=torch.int64)
    for cond, code in reversed(pairs):
        out = torch.where(cond, torch.full_like(out, code), out)
    return out


def dtype_PT(p, t0, t1, t2, dot=dot):
    """Closest-point type of point vs triangle: 0,1,2 = PP with t0/t1/t2;
    3,4,5 = PE with (t0,t1)/(t1,t2)/(t2,t0); 6 = interior PT."""
    n = cross(t1 - t0, t2 - t0)
    ta, sa = _edge_region_params(p, t0, t1, n, dot)
    tb, sb = _edge_region_params(p, t1, t2, n, dot)
    tc, sc = _edge_region_params(p, t2, t0, n, dot)
    in_a = (ta > 0.0) & (ta < 1.0) & (sa >= 0.0)
    in_b = (tb > 0.0) & (tb < 1.0) & (sb >= 0.0)
    in_c = (tc > 0.0) & (tc < 1.0) & (sc >= 0.0)
    pp0 = (ta <= 0.0) & (tc >= 1.0)
    pp1 = (tb <= 0.0) & (ta >= 1.0)
    pp2 = (tc <= 0.0) & (tb >= 1.0)
    # reference precedence: edge01, edge12, edge20, then PP checks, else PT
    return _code((in_a, 3), (in_b, 4), (in_c, 5), (pp0, 0), (pp1, 1), (pp2, 2),
                 default=6)


def dtype_EE(a0, a1, b0, b1, dot=dot):
    """Closest-point type of edge (a0,a1) vs edge (b0,b1): 0 = PP a0b0,
    1 = PP a0b1, 2 = PE a0-(b0,b1), 3 = PP a1b0, 4 = PP a1b1,
    5 = PE a1-(b0,b1), 6 = PE b0-(a0,a1), 7 = PE b1-(a0,a1), 8 = EE.

    The nearly-parallel deflection threshold is dtype-aware, as in the JAX
    package (ipc_tpu/ops/distance.py:243): 1e-20 in float64, 1e-6 in
    float32, where the interior-EE formula is cancellation noise for
    near-parallel grid edges."""
    u = a1 - a0
    v = b1 - b0
    w = a0 - b0
    a = dot(u, u)
    b = dot(u, v)
    c = dot(v, v)
    d = dot(u, w)
    e = dot(v, w)
    D = a * c - b * b
    sN = b * e - c * d
    tN_mid = a * e - b * d
    uxv = cross(u, v)
    para_eps = 1e-20 if a0.dtype == torch.float64 else 1e-6
    para = (dot(uxv, w) == 0.0) | (dot(uxv, uxv) < para_eps * a * c)
    mid_deflect = (tN_mid > 0.0) & (tN_mid < D) & para
    mid_low = mid_deflect & (sN < D / 2)
    # case_s: 0 -> s=0 edge, 1 -> s=1 edge, 2 -> interior
    case_s = _code((sN <= 0.0, 0), (sN >= D, 1), (mid_low, 0), (mid_deflect, 1),
                   default=2)
    tN = torch.where(case_s == 0, e, torch.where(case_s == 1, e + b, tN_mid))
    tD = torch.where(case_s == 2, D, c)
    default = select(case_s, [torch.full_like(case_s, 2), torch.full_like(case_s, 5),
                              torch.full_like(case_s, 8)])
    t_lo = _code((-d <= 0.0, 0), (-d >= a, 3), default=6)
    t_hi = _code(((-d + b) <= 0.0, 1), ((-d + b) >= a, 4), default=7)
    return torch.where(tN <= 0.0, t_lo, torch.where(tN >= tD, t_hi, default))


# ---------------------------------------------------------------------------
# parallel edge-edge mollifier
# ---------------------------------------------------------------------------


def ee_cross_sq_norm(a0, a1, b0, b1):
    c = cross(a1 - a0, b1 - b0)
    return dot(c, c)


def eps_x_ee(a0_rest, a1_rest, b0_rest, b1_rest):
    """Mollifier threshold eps_x = 1e-3 |ea|^2 |eb|^2 in rest positions."""
    ea = a0_rest - a1_rest
    eb = b0_rest - b1_rest
    return 1e-3 * dot(ea, ea) * dot(eb, eb)


def mollifier_ee(x, eps_x):
    """e(x) on EE stencils x (..., 4, 3): (2 - c/eps_x) c/eps_x below eps_x,
    else 1."""
    c = ee_cross_sq_norm(x[..., 0, :], x[..., 1, :], x[..., 2, :], x[..., 3, :])
    r = c / eps_x
    return torch.where(c < eps_x, (2.0 - r) * r, torch.ones_like(r))
