"""Continuous collision detection: additive CCD (ACCD), batched over pairs.

Port of ipc_tpu/contact/ccd.py:27-80 (Li, Kaufman, Jiang 2021, Codimensional
IPC, supplement). Each stencil advances its time by steps that provably
cannot close more than the remaining gap and stops leaving
`slackness * d0` of it. The JAX package runs a `fori_loop` of `max_iter`
iterations with a `done` mask; the port runs the same fixed count over all
pairs at once, with no host read.

Not ported yet: the Tight-Inclusion interval variant (`ti_pt`, `ti_ee`,
`ccd_method="ti"`), which waits for the variants slice; `SelfContact`
refuses it.
"""

import torch

from ipc_tpu_torch.ops.distance import edge_edge_dist2, point_triangle_dist2

__all__ = ["accd_pt", "accd_ee"]


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _accd(x4, p4, dist2_fn, slackness, max_iter, t_max=1.0):
    """Safe steps (N,) in [0, t_max] for stencils x4 (N,4,3) moving by p4."""
    p4 = p4 - p4.mean(dim=1, keepdim=True)  # common translation changes nothing
    nrm = _norm(p4)  # (N,4)
    l_p = torch.clamp(nrm[:, 0], min=0.0) + torch.maximum(
        torch.maximum(nrm[:, 1], nrm[:, 2]), nrm[:, 3])
    l_p_ee = torch.maximum(nrm[:, 0], nrm[:, 1]) + torch.maximum(nrm[:, 2], nrm[:, 3])
    l_p = torch.maximum(l_p, l_p_ee)  # conservative for both layouts
    d0 = torch.sqrt(torch.clamp(dist2_fn(x4), min=0.0))
    g = slackness * d0
    no_motion = l_p <= 0.0
    l_safe = torch.clamp(l_p, min=1e-30)
    d0_floor = 1e-6 * torch.clamp(d0, min=1e-30)
    t = torch.zeros_like(d0)
    done = no_motion
    for _ in range(max_iter):
        d = torch.sqrt(torch.clamp(dist2_fn(x4 + t[:, None, None] * p4), min=0.0))
        step = 0.9 * (d - g) / l_safe
        t_new = torch.clamp(t + step, max=t_max)
        done_new = done | (step <= d0_floor) | (t >= t_max)
        t = torch.where(done, t, t_new)
        done = done_new
    t = torch.where(no_motion, torch.full_like(t, t_max), t)
    return torch.clamp(t, min=0.0)


def _pt(y):
    return point_triangle_dist2(y[:, 0], y[:, 1], y[:, 2], y[:, 3])


def _ee(y):
    return edge_edge_dist2(y[:, 0], y[:, 1], y[:, 2], y[:, 3])


def accd_pt(x4, p4, slackness=0.2, max_iter=64):
    """Safe steps (N,) of point-triangle stencils (p, t0, t1, t2)."""
    return _accd(x4, p4, _pt, slackness, max_iter)


def accd_ee(x4, p4, slackness=0.2, max_iter=64):
    """Safe steps (N,) of edge-edge stencils (a0, a1, b0, b1)."""
    return _accd(x4, p4, _ee, slackness, max_iter)
