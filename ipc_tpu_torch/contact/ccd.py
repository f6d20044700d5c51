"""Continuous collision detection, batched over pairs: additive CCD (ACCD)
and the Tight-Inclusion-style interval CCD.

Port of ipc_tpu/contact/ccd.py:27-80, 115-214.

ACCD (Li, Kaufman, Jiang 2021, Codimensional IPC, supplement): each stencil
advances its time by steps that provably cannot close more than the
remaining gap and stops leaving `slackness * d0` of it. The JAX package
runs a `fori_loop` of `max_iter` iterations with a `done` mask. For CUDA
tensors `accd_pt` / `accd_ee` launch one kernel per call (csrc/accd.cu):
one thread per stencil runs the loop in registers and leaves it when its
pair is done, which changes no result (a done pair keeps its t and done
never clears), with no host read. For CPU tensors, and only there, they
run `_accd`, the plain version: the same `max_iter` passes over all pairs
at once in PyTorch, with the same arithmetic. A CUDA tensor never reaches
it: the kernel launches or the call raises.

One order of rounding on every device: the plain version sums each dot
product as ((0 + 1) + 2) (`dot_ordered`, ops/distance.py) and the mean of
the four displacements as ((0 + 1) + 2) + 3, times 1/4, takes every square
root rounded to nearest (`sqrt_rn`), and the kernel rounds each operation in
that order, so the CPU, the plain version on the card and the kernel give
the same bits, and a CCD-clamped step (the scripted prologue's
`script_scale`) is the same on the CPU and the card.

Counters (utils/observability.py): on the host, always, `ccd.calls` (calls
with at least one stencil), `ccd.kernel_calls` (kernel launches),
`ccd.passes` (max_iter per call) and `ccd.pair_passes` (stencils x
max_iter); while tracing is on, on the device, `ccd.live_passes` (passes
that begin with a stencil not done: the most over the call's stencils)
and `ccd.live_pair_passes` (stencils not done at a pass's start, summed
over the passes). The kernel writes each stencil's live passes when
asked; the plain version adds `done` in place once per pass. Neither
changes a result.

Interval CCD (`ti_pt`, `ti_ee`): with linear vertex motion the separation
function is affine in t for fixed barycentric coordinates and affine in
those for fixed t, so over a time cell [ta, tb] its per-coordinate range
is spanned by the corner evaluations (6 for PT, 8 for EE). A cell can hold
a root only if every coordinate's range, inflated by the minimum
separation and a rounding bound, straddles zero. The earliest root is
bracketed by a fixed-count bisection on t, over all pairs at once. The
box is taken in a frame whose first axis is the initial separation
direction (the gradient of the squared distance, by autograd as JAX takes
it by `jax.grad`), which keeps sliding contacts certified in one test.
"""

import torch

from ipc_tpu_torch.ops.distance import (cross, dot_ordered, edge_edge_dist2,
                                         point_triangle_dist2, sqrt_rn)
from ipc_tpu_torch.utils.observability import count, count_device, tracing

__all__ = ["accd_pt", "accd_ee", "ti_pt", "ti_ee"]


def _norm(v):
    return sqrt_rn(dot_ordered(v, v))


def _accd(x4, p4, dist2_fn, slackness, max_iter, t_max=1.0):
    """Safe steps (N,) in [0, t_max] for stencils x4 (N,4,3) moving by p4."""
    n = int(x4.shape[0])
    count("ccd.passes", max_iter)
    count("ccd.pair_passes", n * max_iter)
    t, done_passes = _accd_loop(x4, p4, dist2_fn, slackness, max_iter, t_max,
                                tracing() and n > 0)
    if done_passes is not None:
        count_device("ccd.live_pair_passes", n * max_iter - done_passes.sum())
        count_device("ccd.live_passes", max_iter - done_passes.min())
    return t


def _accd_loop(x4, p4, dist2_fn, slackness, max_iter, t_max, want_done):
    """(t, done_passes): `_accd`'s safe steps and, when `want_done`, each
    stencil's passes begun done (N,) int32 (else None). Done never clears,
    so a stencil's live passes come first, and number max_iter less these."""
    # common translation changes nothing
    mean = (((p4[:, 0] + p4[:, 1]) + p4[:, 2]) + p4[:, 3]) * 0.25
    p4 = p4 - mean[:, None]
    nrm = _norm(p4)  # (N,4)
    l_p = torch.clamp(nrm[:, 0], min=0.0) + torch.maximum(
        torch.maximum(nrm[:, 1], nrm[:, 2]), nrm[:, 3])
    l_p_ee = torch.maximum(nrm[:, 0], nrm[:, 1]) + torch.maximum(nrm[:, 2], nrm[:, 3])
    l_p = torch.maximum(l_p, l_p_ee)  # conservative for both layouts
    d0 = sqrt_rn(torch.clamp(dist2_fn(x4), min=0.0))
    g = slackness * d0
    no_motion = l_p <= 0.0
    l_safe = torch.clamp(l_p, min=1e-30)
    d0_floor = 1e-6 * torch.clamp(d0, min=1e-30)
    t = torch.zeros_like(d0)
    done = no_motion
    done_passes = torch.zeros_like(d0, dtype=torch.int32) if want_done else None
    for _ in range(max_iter):
        if done_passes is not None:
            done_passes += done
        d = sqrt_rn(torch.clamp(dist2_fn(x4 + t[:, None, None] * p4), min=0.0))
        step = 0.9 * (d - g) / l_safe
        t_new = torch.clamp(t + step, max=t_max)
        done_new = done | (step <= d0_floor) | (t >= t_max)
        t = torch.where(done, t, t_new)
        done = done_new
    t = torch.where(no_motion, torch.full_like(t, t_max), t)
    return torch.clamp(t, min=0.0), done_passes


def _pt(y):
    return point_triangle_dist2(y[:, 0], y[:, 1], y[:, 2], y[:, 3], dot=dot_ordered)


def _ee(y):
    return edge_edge_dist2(y[:, 0], y[:, 1], y[:, 2], y[:, 3], dot=dot_ordered)


def _check(x4, p4):
    if x4.dim() != 3 or tuple(x4.shape[1:]) != (4, 3) or p4.shape != x4.shape:
        raise ValueError(f"accd: x4 {tuple(x4.shape)} and p4 {tuple(p4.shape)} must both "
                         f"be (N,4,3)")
    if x4.dtype != p4.dtype or x4.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"accd: x4 {x4.dtype} and p4 {p4.dtype} must share float32 or float64")
    if x4.device != p4.device:
        raise ValueError(f"accd: x4 on {x4.device}, p4 on {p4.device}")


def _accd_kernel(kind, x4, p4, slackness, max_iter, want_live, t_max=1.0):
    """The kernel's safe steps (N,) of `kind` ("pt" or "ee") stencils and,
    when `want_live`, each stencil's live passes (N,) int32 (else None).
    Raises for non-contiguous x4 or p4 before touching the card. A launch
    counts in `ccd.kernel_calls`."""
    if not (x4.is_contiguous() and p4.is_contiguous()):
        raise ValueError("accd: x4 and p4 must be contiguous")
    n = int(x4.shape[0])
    t = torch.empty((n,), dtype=x4.dtype, device=x4.device)
    live = torch.empty((n,), dtype=torch.int32, device=x4.device) if want_live else None
    if n:
        from ipc_tpu_torch.build import load_kernels

        fn = getattr(load_kernels(),
                     f"ipc_accd_{kind}_{'f32' if x4.dtype == torch.float32 else 'f64'}")
        err = fn(x4.data_ptr(), p4.data_ptr(), n, float(slackness), int(max_iter),
                 float(t_max), t.data_ptr(), None if live is None else live.data_ptr(),
                 torch.cuda.current_stream(x4.device).cuda_stream)
        count("ccd.kernel_calls")
        if err != 0:
            raise RuntimeError(f"accd_{kind}: CUDA launch failed with error {err}")
    return t, live


def _route(wrapper, kind, dist2_fn, x4, p4, slackness, max_iter):
    _check(x4, p4)
    n = int(x4.shape[0])
    if n:
        count("ccd.calls")
    if x4.device.type == "cpu":
        return _accd(x4, p4, dist2_fn, slackness, max_iter)
    if x4.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__}: unsupported device {x4.device}")
    count("ccd.passes", max_iter)
    count("ccd.pair_passes", n * max_iter)
    t, live = _accd_kernel(kind, x4, p4, slackness, max_iter, tracing() and n > 0)
    if live is not None:
        count_device("ccd.live_pair_passes", live.sum())
        count_device("ccd.live_passes", live.max())
    return t


def accd_pt(x4, p4, slackness=0.2, max_iter=64):
    """Safe steps (N,) of point-triangle stencils (p, t0, t1, t2)."""
    return _route(accd_pt, "pt", _pt, x4, p4, slackness, max_iter)


def accd_ee(x4, p4, slackness=0.2, max_iter=64):
    """Safe steps (N,) of edge-edge stencils (a0, a1, b0, b1)."""
    return _route(accd_ee, "ee", _ee, x4, p4, slackness, max_iter)


# ---------------------------------------------------------------------------
# Tight-Inclusion-style interval CCD
# ---------------------------------------------------------------------------


def _sep_frame(x4, kind):
    """(N,3,3) rotations whose first row is each stencil's initial
    separation direction: the gradient of d^2 w.r.t. the point (PT) or
    summed over the first edge's endpoints (EE); the identity axis where
    the gradient vanishes (touching or degenerate stencils)."""
    with torch.enable_grad():
        if kind == "pt":
            p = x4[:, 0].detach().requires_grad_(True)
            d2 = point_triangle_dist2(p, x4[:, 1], x4[:, 2], x4[:, 3])
            g = torch.autograd.grad(d2.sum(), p)[0]
        else:
            a = x4[:, :2].detach().requires_grad_(True)
            d2 = edge_edge_dist2(a[:, 0], a[:, 1], x4[:, 2], x4[:, 3])
            g = torch.autograd.grad(d2.sum(), a)[0].sum(dim=1)
    g = g.detach()
    n = torch.sqrt((g * g).sum(-1, keepdim=True))
    ok = n > 1e-30
    ex = torch.zeros_like(g)
    ex[:, 0] = 1.0
    ey = torch.zeros_like(g)
    ey[:, 1] = 1.0
    e0 = torch.where(ok, g / torch.where(ok, n, torch.ones_like(n)), ex)
    # any orthonormal completion: Gram-Schmidt on the less aligned axis
    a = torch.where(torch.abs(e0[:, :1]) < 0.9, ex, ey)
    e1 = a - (a * e0).sum(-1, keepdim=True) * e0
    e1 = e1 / torch.clamp(torch.sqrt((e1 * e1).sum(-1, keepdim=True)), min=1e-30)
    return torch.stack([e0, e1, cross(e0, e1)], dim=1)


def _ti_corner_evals(x4, p4, t, kind):
    """Separation-function corner evaluations (N,K,3) at times t (N,)."""
    y = x4 + t[:, None, None] * p4
    if kind == "pt":
        # (u,v) simplex corners: (0,0) -> t0, (1,0) -> t1, (0,1) -> t2
        return torch.stack([y[:, 0] - y[:, 1], y[:, 0] - y[:, 2], y[:, 0] - y[:, 3]], dim=1)
    return torch.stack([y[:, 0] - y[:, 2], y[:, 0] - y[:, 3], y[:, 1] - y[:, 2],
                        y[:, 1] - y[:, 3]], dim=1)


def _ti_root_free(x4, p4, ta, tb, pad, kind, R):
    """(N,) bool: [ta, tb] provably holds no root (a coordinate of R q over
    the cell's corners, inflated by `pad` (N,), excludes 0)."""
    q = torch.cat([_ti_corner_evals(x4, p4, ta, kind), _ti_corner_evals(x4, p4, tb, kind)],
                  dim=1)  # (N,2K,3)
    # q @ R^T, summed over j in order 0, 1, 2
    q = (q[:, :, 0:1] * R[:, None, :, 0] + q[:, :, 1:2] * R[:, None, :, 1]
         + q[:, :, 2:3] * R[:, None, :, 2])
    lo = q.amin(dim=1) - pad[:, None]
    hi = q.amax(dim=1) + pad[:, None]
    return ((lo > 0.0) | (hi < 0.0)).any(dim=1)


def _ti(x4, p4, kind, t_max=1.0, ms=0.0, max_iter=32):
    """Conservative safe steps (N,) in [0, t_max]: no root in [0, t] up to
    the minimum separation `ms` ((N,) or scalar) and the rounding bound."""
    eps = 2.220446049250313e-16 if x4.dtype == torch.float64 else 1.1920929e-7
    m = torch.maximum(torch.abs(x4).amax(dim=(1, 2)), torch.abs(x4 + p4).amax(dim=(1, 2)))
    m = torch.clamp(m, min=1.0)
    # the reference's cubic error form, doubled for the frame rotation
    err = 24.0 * eps * m * m
    pad = ms + err
    R = _sep_frame(x4, kind)
    zero = torch.zeros_like(m)
    tmax = torch.full_like(m, t_max)
    free_all = _ti_root_free(x4, p4, zero, tmax, pad, kind, R)
    lo, hi = zero, tmax
    for _ in range(max_iter):
        mid = 0.5 * (lo + hi)
        first_free = _ti_root_free(x4, p4, lo, mid, pad, kind, R)
        lo, hi = torch.where(first_free, mid, lo), torch.where(first_free, hi, mid)
    return torch.where(free_all, tmax, lo)


def ti_pt(x4, p4, t_max=1.0, ms=0.0, max_iter=32):
    """Conservative safe steps (N,) of point-triangle stencils (p, t0, t1,
    t2) with minimum separation ms."""
    return _ti(x4, p4, "pt", t_max, ms, max_iter)


def ti_ee(x4, p4, t_max=1.0, ms=0.0, max_iter=32):
    """Conservative safe steps (N,) of edge-edge stencils (a0, a1, b0, b1)."""
    return _ti(x4, p4, "ee", t_max, ms, max_iter)
