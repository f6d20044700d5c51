"""Inversion-free step-size bound per tetrahedron.

Port of ipc_tpu/ops/step_bound.py (reference computeInjectiveStepSize_3d):
the smallest positive root t* of det(A + t B) = slackness * det(A), as the
cubic c3 t^3 + c2 t^2 + c1 t + c0, solved in closed form with masks.
Elementwise over batches.
"""

import math

import torch

__all__ = ["smallest_positive_root_cubic", "injective_step_bound"]

_INF = 1e30


def _adjugate3(M):
    """Adjugate of (N,3,3): row k is the cross product of columns k+1, k+2."""
    c = lambda i, j: torch.linalg.cross(M[:, :, i], M[:, :, j])
    return torch.stack([c(1, 2), c(2, 0), c(0, 1)], dim=1)


def smallest_positive_root_cubic(c3, c2, c1, c0, eps=1e-12):
    """Smallest strictly-positive real root of c3 x^3+c2 x^2+c1 x+c0, else
    1e30. Mask-based handling of the cubic/quadratic/linear degenerations."""
    big = torch.full_like(c0, _INF)
    one = torch.ones_like(c0)

    def pos_or_inf(x, valid):
        return torch.where(valid & (x > 0) & torch.isfinite(x), x, big)

    # ---- linear: c1 x + c0 = 0
    lin_valid = torch.abs(c1) > eps
    x_lin = -c0 / torch.where(lin_valid, c1, one)
    root_lin = pos_or_inf(x_lin, lin_valid)

    # ---- quadratic: c2 x^2 + c1 x + c0 = 0 (stable form)
    quad_valid = torch.abs(c2) > eps
    disc_q = c1 * c1 - 4.0 * c2 * c0
    has_q = quad_valid & (disc_q >= 0.0)
    sq = torch.sqrt(torch.clamp(disc_q, min=0.0))
    qq = -0.5 * (c1 + torch.sign(c1) * sq)
    qq = torch.where(torch.abs(qq) > eps, qq, one)
    xq1 = qq / torch.where(quad_valid, c2, one)
    xq2 = c0 / qq
    root_quad = torch.minimum(pos_or_inf(xq1, has_q), pos_or_inf(xq2, has_q))
    root_quad = torch.where(quad_valid, root_quad, root_lin)

    # ---- cubic: normalize to x^3 + p2 x^2 + p1 x + p0
    cub_valid = torch.abs(c3) > eps
    d = torch.where(cub_valid, c3, one)
    p2, p1, p0 = c2 / d, c1 / d, c0 / d
    # depressed: x = y - p2/3 ;  y^3 + py + q = 0
    s = p2 / 3.0
    p = p1 - p2 * s
    q = p0 - s * p1 + 2.0 * s * s * s
    disc = 0.25 * q * q + p * p * p / 27.0

    # one real root (disc > 0): Cardano
    sd = torch.sqrt(torch.clamp(disc, min=0.0))
    u3 = -0.5 * q + sd
    v3 = -0.5 * q - sd
    cbrt = lambda t: torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)
    y_single = cbrt(u3) + cbrt(v3)
    root_single = pos_or_inf(y_single - s, cub_valid)

    # three real roots (disc <= 0): trigonometric
    pm = torch.clamp(p, max=-eps)  # p < 0 in this regime
    m = 2.0 * torch.sqrt(-pm / 3.0)
    acos_arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    theta = torch.arccos(acos_arg) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    y0 = m * torch.cos(theta)
    y1 = m * torch.cos(theta - two_pi_3)
    y2 = m * torch.cos(theta - 2.0 * two_pi_3)
    r_tri = torch.minimum(
        torch.minimum(pos_or_inf(y0 - s, cub_valid), pos_or_inf(y1 - s, cub_valid)),
        pos_or_inf(y2 - s, cub_valid),
    )

    root_cubic = torch.where(disc > 0.0, root_single, r_tri)
    return torch.where(cub_valid, root_cubic, root_quad)


def injective_step_bound(A, B, slackness=0.2, eps=1e-12):
    """Per-tet largest safe step: A (N,3,3) current edge matrices (columns
    x_i - x_0), B the search-direction edge matrices. Returns (N,) t* with
    det(A + t B) > slackness det(A) on [0, t*); 1e30 if the ray is safe."""
    adjA = _adjugate3(A)
    adjB = _adjugate3(B)
    detA = torch.linalg.det(A)
    c3 = torch.linalg.det(B)
    c2 = torch.diagonal(torch.matmul(adjB, A), dim1=-2, dim2=-1).sum(-1)
    c1 = torch.diagonal(torch.matmul(adjA, B), dim1=-2, dim2=-1).sum(-1)
    c0 = (1.0 - slackness) * detA
    return smallest_positive_root_cubic(c3, c2, c1, c0, eps)
