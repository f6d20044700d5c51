"""Lagged smoothed-Coulomb friction: the static-friction clamping functions.

Port of ipc_tpu/ops/friction.py:40-75 (reference FrictionUtils.hpp). x2 is
the squared tangential relative displacement norm, eps the smoothing band;
valid for x2 <= eps^2 (callers switch to the linear |x| regime above).

Not ported yet: the tangent bases, closest-point coordinates and relative
displacement operators (ipc_tpu/ops/friction.py:77-218) — self-contact
friction, slice 2.
"""

import torch

__all__ = ["f0_sf", "f1_sf_over_x", "f2_sf"]


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
