"""Collision constraint values and gradients for the QP/SQP comparison path.

Port of ipc_tpu/qp/constraints.py, batched over K stencils (K,4,3) where
the JAX package vmaps one stencil. The reference's three constraint
formula families (src/CollisionObject/CollisionConstraints.cpp):

  volume     (:146-167)  tet volume of the 4-point stencil; also serves
                         NONSMOOTH_NEWMARK
  graphics   (:208-315)  plane/normal gap at the current configuration
                         [Harmon et al. 2008]; also serves GAP_FUNCTION
  verschoor  (:317-520)  normal gap at the contact point located by the
                         CCD toi between x_prev and x [Verschoor et al.
                         2019]; also serves CMR and STIV

Each returns (c (K,), grad_c (K,4,3)) on PT stencils (p, t0, t1, t2) or EE
stencils (a0, a1, b0, b1); the QP linearizes grad_c . dx >= -c + offset.

As in the JAX package: the volume family swaps triangle points 1 and 2
("counter-clockwise", CollisionConstraints.cpp:36-41); its gradient is the
closed form of the triple product's derivative (JAX takes `jax.grad`).
The EE line parameters come from a batched 3x3 solve behind a
|det| > 1e-30 guard; a guarded row, and a Verschoor row whose toi is
outside [0, 1] or not finite, gives c = 1e28 and a zero gradient.
"""

import torch

__all__ = ["constraint_c_grad", "FAMILY_OF_TYPE"]

# reference enum name (lowercased) -> formula family
FAMILY_OF_TYPE = {
    "volume": "volume",
    "nonsmooth_newmark": "volume",
    "graphics": "graphics",
    "gap_function": "graphics",
    "verschoor": "verschoor",
    "cmr": "verschoor",
    "stiv": "verschoor",
}

_SENTINEL = 1e28


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _normalize(v, eps=1e-30):
    n = torch.sqrt(_dot(v, v))
    return v / torch.clamp(n, min=eps)[..., None]


def _barycentric(p, a, b, c):
    """(K,3) barycentric coordinates of p in the plane of (a,b,c)
    (reference barycentric_coordinates, CollisionConstraints.cpp:181-207)."""
    v0, v1, v2 = b - a, c - a, p - a
    d00 = _dot(v0, v0)
    d01 = _dot(v0, v1)
    d11 = _dot(v1, v1)
    d20 = _dot(v2, v0)
    d21 = _dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(torch.abs(denom) > 1e-30, denom, torch.ones_like(denom))
    w1 = (d11 * d20 - d01 * d21) / denom
    w2 = (d00 * d21 - d01 * d20) / denom
    return torch.stack([1.0 - w1 - w2, w1, w2], dim=-1)


def _ee_params(v0, v1, v2, v3):
    """((K,2) closest-point line parameters (t0, t1), (K,) ok) between the
    segments' lines by the reference's 3x3 solve
    (CollisionConstraints.cpp:225-255)."""
    d0 = v1 - v0
    d1 = v3 - v2
    d2 = _cross(d1, d0)
    A = torch.stack([d0, -d1, d2], dim=-1)  # columns d0, -d1, d2
    det = _dot(d0, _cross(-d1, d2))
    ok = torch.abs(det) > 1e-30
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A)
    Asafe = torch.where(ok[:, None, None], A, eye)
    params = torch.linalg.solve_ex(Asafe, (v2 - v0)[..., None], check_errors=False)[0]
    return params[..., :2, 0], ok


def _pt_grad(n, bc):
    """(K,4,3) rows [n, -bc0 n, -bc1 n, -bc2 n]."""
    return torch.cat([n[:, None], -bc[:, :, None] * n[:, None]], dim=1)


def _ee_grad(n, t0, t1):
    return torch.stack([-(1.0 - t0)[:, None] * n, -t0[:, None] * n,
                        (1.0 - t1)[:, None] * n, t1[:, None] * n], dim=1)


def _guard(bad, c, g):
    c = torch.where(bad, torch.full_like(c, _SENTINEL), c)
    g = torch.where(bad[:, None, None], torch.zeros_like(g), g)
    return c, g


# -- volume family ----------------------------------------------------------


def _volume(x4):
    """Signed tet volume with the reference's swap (v1 <-> v2 relative to
    the stencil order) and its gradient."""
    v0, v1, v2, v3 = x4[:, 0], x4[:, 1], x4[:, 3], x4[:, 2]
    e1, e2, e3 = v1 - v0, v2 - v0, v3 - v0
    c = _dot(e3, _cross(e1, e2))
    g1 = _cross(e2, e3)  # dc/dv1
    g2 = _cross(e3, e1)  # dc/dv2
    g3 = _cross(e1, e2)  # dc/dv3
    g0 = -(g1 + g2 + g3)
    return c, torch.stack([g0, g1, g3, g2], dim=1)


# -- graphics family --------------------------------------------------------


def _graphics_pt(x4):
    p, t0, t1, t2 = x4[:, 0], x4[:, 1], x4[:, 2], x4[:, 3]
    n = _normalize(_cross(t1 - t0, t2 - t0))
    c = _dot(n, p - t0)
    proj = p - c[:, None] * n
    bc = _barycentric(proj, t0, t1, t2)
    return c, _pt_grad(n, bc)


def _graphics_ee(x4):
    v0, v1, v2, v3 = x4[:, 0], x4[:, 1], x4[:, 2], x4[:, 3]
    params, ok = _ee_params(v0, v1, v2, v3)
    t0 = torch.clamp(params[:, 0], 0.0, 1.0)
    t1 = torch.clamp(params[:, 1], 0.0, 1.0)
    p0 = v0 + t0[:, None] * (v1 - v0)
    p1 = v2 + t1[:, None] * (v3 - v2)
    n = _normalize(_cross(v3 - v2, v1 - v0))
    c = _dot(n, p1 - p0)
    return _guard(~ok, c, _ee_grad(n, t0, t1))


# -- verschoor family -------------------------------------------------------


def _toi_bad(toi):
    return (toi < 0.0) | (toi > 1.0) | ~torch.isfinite(toi)


def _verschoor_pt(x4_prev, x4, toi):
    xt = x4_prev + toi[:, None, None] * (x4 - x4_prev)
    bc = _barycentric(xt[:, 0], xt[:, 1], xt[:, 2], xt[:, 3])
    vc = bc[:, 0:1] * x4[:, 1] + bc[:, 1:2] * x4[:, 2] + bc[:, 2:3] * x4[:, 3]
    n = _normalize(_cross(x4[:, 2] - x4[:, 1], x4[:, 3] - x4[:, 1]))
    c = _dot(n, x4[:, 0] - vc)
    return _guard(_toi_bad(toi), c, _pt_grad(n, bc))


def _verschoor_ee(x4_prev, x4, toi):
    xt = x4_prev + toi[:, None, None] * (x4 - x4_prev)
    params, ok = _ee_params(xt[:, 0], xt[:, 1], xt[:, 2], xt[:, 3])
    t0 = torch.clamp(params[:, 0], 0.0, 1.0)
    t1 = torch.clamp(params[:, 1], 0.0, 1.0)
    p0 = x4[:, 0] + t0[:, None] * (x4[:, 1] - x4[:, 0])
    p1 = x4[:, 2] + t1[:, None] * (x4[:, 3] - x4[:, 2])
    n = _normalize(_cross(x4[:, 3] - x4[:, 2], x4[:, 1] - x4[:, 0]))
    c = _dot(n, p1 - p0)
    return _guard(_toi_bad(toi) | ~ok, c, _ee_grad(n, t0, t1))


def constraint_c_grad(ctype, x4_prev, x4, is_ee, toi):
    """(c (K,), grad (K,4,3)) of K active stencils x4 (K,4,3) (x4_prev:
    the same at the step start) for constraint type `ctype` (a reference
    enum name, FAMILY_OF_TYPE); is_ee (K,) bool selects the EE formula
    where the families split; toi (K,) the CCD time of impact."""
    fam = FAMILY_OF_TYPE[ctype.lower()]
    if fam == "volume":
        return _volume(x4)
    if fam == "graphics":
        c_pt, g_pt = _graphics_pt(x4)
        c_ee, g_ee = _graphics_ee(x4)
    else:
        c_pt, g_pt = _verschoor_pt(x4_prev, x4, toi)
        c_ee, g_ee = _verschoor_ee(x4_prev, x4, toi)
    return (torch.where(is_ee, c_ee, c_pt),
            torch.where(is_ee[:, None, None], g_ee, g_pt))
