"""Clamped log-barrier functions b(d, dHat) on SQUARED distances.

Port of ipc_tpu/ops/barrier.py (reference BarrierFunctions.hpp, C2 barrier
by default). Outside 0 < d < dHat every value is exactly 0; callers rely on
that instead of masking. Elementwise on tensors of any shape.
"""

import torch

__all__ = ["barrier", "barrier_grad", "barrier_hess"]


def _safe_d(d):
    # keep masked lanes finite; never changes values where 0 < d < dHat
    tiny = 1e-300 if d.dtype == torch.float64 else 1e-30
    return torch.where(d > 0, d, torch.full_like(d, tiny))


def _parts(d, dHat):
    active = (d < dHat) & (d > 0)
    ds = _safe_d(d)
    return active, ds, ds - dHat, torch.log(ds / dHat)


def barrier(d, dHat, order: int = 2):
    """b(d, dHat); zero for d >= dHat or d <= 0."""
    active, ds, t, logr = _parts(d, dHat)
    if order == 0:
        b = -logr
    elif order == 1:
        b = t * logr
    elif order == 2:
        b = -t * t * logr
    else:
        raise ValueError(f"unsupported barrier order {order}")
    return torch.where(active, b, torch.zeros_like(b))


def barrier_grad(d, dHat, order: int = 2):
    """db/dd; zero outside the active range."""
    active, ds, t, logr = _parts(d, dHat)
    if order == 0:
        g = -1.0 / ds
    elif order == 1:
        g = logr + t / ds
    elif order == 2:
        g = -2.0 * t * logr - t * t / ds
    else:
        raise ValueError(f"unsupported barrier order {order}")
    return torch.where(active, g, torch.zeros_like(g))


def barrier_hess(d, dHat, order: int = 2):
    """d2b/dd2; zero outside the active range."""
    active, ds, t, logr = _parts(d, dHat)
    if order == 0:
        h = 1.0 / (ds * ds)
    elif order == 1:
        h = 2.0 / ds - t / (ds * ds)
    elif order == 2:
        h = -2.0 * logr - 4.0 * t / ds + t * t / (ds * ds)
    else:
        raise ValueError(f"unsupported barrier order {order}")
    return torch.where(active, h, torch.zeros_like(h))
