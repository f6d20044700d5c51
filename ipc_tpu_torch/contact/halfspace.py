"""Analytic half-space (ground/wall) collision object.

Port of ipc_tpu/contact/halfspace.py (reference
HalfSpace.cpp): the squared signed distance d = (n.x + D)^2 fed to the IPC
barrier, its gradient and SPD Hessian blocks per surface vertex, the closed-
form largest feasible step, and lagged friction on the plane's fixed
tangent basis. Every method takes surface-vertex positions (Sv,3).

Moving planes (scripted ACO scenes): the barrier methods take an optional
`D`, a 0-d tensor that overrides the static offset, and the friction terms
an optional `veldt`, the plane's displacement this step, subtracted from
the relative displacement (reference `VDiff -= velocitydt`). A plane's
per-step move is clamped against the surface vertices: `move_bound` on the
host (numpy; the host path's plane move), `move_bound_t` on the device (the
device step's).
"""

from dataclasses import dataclass

import numpy as np
import torch

from ipc_tpu_torch.ops.barrier import barrier, barrier_grad, barrier_hess
from ipc_tpu_torch.ops.friction import f0_sf, f1_sf_over_x

__all__ = ["HalfSpaceParams", "HalfSpace"]


@dataclass(frozen=True)
class HalfSpaceParams:
    """Static plane parameters (host floats / tuples)."""

    origin: tuple = (0.0, 0.0, 0.0)
    normal: tuple = (0.0, 1.0, 0.0)
    friction: float = 0.0

    @property
    def D(self):
        n = np.asarray(self.normal, dtype=float)
        n = n / np.linalg.norm(n)
        return -float(n @ np.asarray(self.origin, dtype=float))

    @property
    def unit_normal(self):
        n = np.asarray(self.normal, dtype=float)
        return tuple(n / np.linalg.norm(n))

    def tangent_basis(self):
        """A fixed orthonormal basis of the plane (host, (3,2))."""
        n = np.asarray(self.unit_normal)
        a = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        t0 = np.cross(n, a)
        t0 /= np.linalg.norm(t0)
        t1 = np.cross(n, t0)
        return np.stack([t0, t1], axis=1)


class HalfSpace:
    """Device functions bound to one static plane."""

    def __init__(self, params: HalfSpaceParams):
        self.params = params
        self._n = np.asarray(params.unit_normal)
        self._D = params.D
        self._basis = params.tangent_basis()

    def _t(self, a, like):
        return torch.as_tensor(a, dtype=like.dtype, device=like.device)

    # -- geometry ----------------------------------------------------------

    def D_of_origin(self, origin):
        """Plane offset D = -n.origin for an origin tensor (3,)."""
        return -(origin @ self._t(self._n, origin))

    def signed_dist(self, x_sv, D=None):
        """(Sv,) signed distances of surface-vertex positions (Sv,3); `D`
        (0-d tensor) overrides the static offset for a moving plane."""
        return x_sv @ self._t(self._n, x_sv) + (self._D if D is None else D)

    def dist2(self, x_sv, D=None):
        d = self.signed_dist(x_sv, D)
        return d * d

    def active_mask(self, x_sv, dHat, D=None):
        """Active set: surface vertices with d^2 < dHat."""
        return self.dist2(x_sv, D) < dHat

    # -- barrier energy / derivatives -------------------------------------

    def energy(self, x_sv, kappa, dHat, D=None):
        return kappa * barrier(self.dist2(x_sv, D), dHat).sum()

    def grad_sv(self, x_sv, kappa, dHat, D=None):
        """(Sv,3) gradient (barrier_grad is exactly zero beyond dHat)."""
        n = self._t(self._n, x_sv)
        dist = self.signed_dist(x_sv, D)
        coef = kappa * barrier_grad(dist * dist, dHat) * 2.0 * dist
        return coef[:, None] * n[None, :]

    def hess_blocks_sv(self, x_sv, kappa, dHat, D=None):
        """(Sv,3,3) SPD per-vertex Hessian blocks (zero where inactive)."""
        n = self._t(self._n, x_sv)
        dist = self.signed_dist(x_sv, D)
        d2 = dist * dist
        param = 4.0 * barrier_hess(d2, dHat) * d2 + 2.0 * barrier_grad(d2, dHat)
        param = torch.where(param > 0.0, kappa * param, torch.zeros_like(param))
        nnT = torch.outer(n, n)
        return param[:, None, None] * nnT[None, :, :]

    # -- feasible step -----------------------------------------------------

    def largest_feasible_step(self, x_sv, p_sv, dbc_sv, slackness=0.9, D=None):
        """min over surface verts of slackness * (-dist / (n.p)) for verts
        moving toward the plane; DBC verts skipped. inf if none moves in."""
        coef = p_sv @ self._t(self._n, x_sv)
        dist = self.signed_dist(x_sv, D)
        moving_in = (coef < 0.0) & (~dbc_sv)
        denom = torch.where(moving_in, coef, -torch.ones_like(coef))
        alpha = torch.where(moving_in, -dist / denom * slackness,
                            torch.full_like(coef, float("inf")))
        return alpha.min()

    # -- scripted plane motion ---------------------------------------------

    def move_bound(self, x_sv_np, deltaX, D=None, slackness=0.5):
        """Fraction of the plane displacement `deltaX` (3,) that keeps the
        plane, at offset `D` (default: the static one), from passing a
        surface vertex of x_sv_np (numpy (Sv,3)): min(1, slackness * min
        dist / (n.deltaX)) when the plane approaches its half-space, else 1
        (reference HalfSpace::move). A host float."""
        n = self._n
        coef = float(n @ np.asarray(deltaX, float))
        if coef <= 0.0:  # the plane moves away from (or along) its half-space
            return 1.0
        dist = np.asarray(x_sv_np, float) @ n + (self._D if D is None else float(D))
        return float(min(1.0, slackness * dist.min() / coef))

    def move_bound_t(self, x_sv, deltaX, D, slackness=0.5):
        """Fraction (0-d) of the plane displacement `deltaX` (3,) that keeps
        the plane, at offset `D`, from passing a surface vertex: min(1,
        slackness * min dist / (n.deltaX)) when the plane approaches its
        half-space, else 1 (reference HalfSpace::move)."""
        n = self._t(self._n, x_sv)
        coef = n @ deltaX
        dist = x_sv @ n + D
        denom = torch.where(coef > 0.0, coef, torch.ones_like(coef))
        s = torch.clamp(slackness * dist.min() / denom, max=1.0)
        return torch.where(coef <= 0.0, torch.ones_like(s), s)

    # -- lagged friction ---------------------------------------------------

    def friction_lambda(self, x_sv, mask, kappa, dHat, D=None):
        """Lagged multipliers lambda = -kappa 2 sqrt(d2) g_b(d2) >= 0."""
        d2 = self.dist2(x_sv, D)
        lam = -kappa * 2.0 * torch.sqrt(torch.clamp(d2, min=0.0)) * barrier_grad(d2, dHat)
        return torch.where(mask, lam, torch.zeros_like(lam))

    def _tangential(self, x_sv, xt_sv, veldt):
        B = self._t(self._basis, x_sv)
        dxr = x_sv - xt_sv
        if veldt is not None:
            dxr = dxr - veldt[None, :]  # the plane drags its contacts
        u = dxr @ B  # (Sv,2) tangential displacement
        return B, u, (u * u).sum(dim=1)

    def friction_energy(self, x_sv, xt_sv, lam, eps2, veldt=None):
        """mu * sum lam_k f0(|tangential rel dx|), smoothing band eps2;
        `veldt` (3,) is the plane's own displacement this step."""
        mu = self.params.friction
        if mu == 0.0:
            return torch.zeros((), dtype=x_sv.dtype, device=x_sv.device)
        _, _, u2 = self._tangential(x_sv, xt_sv, veldt)
        eps = torch.sqrt(eps2)
        f0 = torch.where(u2 > eps2, torch.sqrt(torch.maximum(u2, eps2)), f0_sf(u2, eps))
        return mu * (lam * f0).sum()

    def friction_grad_sv(self, x_sv, xt_sv, lam, eps2, veldt=None):
        mu = self.params.friction
        if mu == 0.0:
            return torch.zeros_like(x_sv)
        B, u, u2 = self._tangential(x_sv, xt_sv, veldt)
        eps = torch.sqrt(eps2)
        scale = torch.where(
            u2 > eps2,
            1.0 / torch.sqrt(torch.maximum(u2, eps2)),
            f1_sf_over_x(u2, eps),
        )
        force_t = (mu * lam * scale)[:, None] * u  # (Sv,2)
        return force_t @ B.T

    def friction_hess_blocks_sv(self, x_sv, xt_sv, lam, eps2, veldt=None):
        """(Sv,3,3) PSD friction Hessian blocks B H_t B^T with
        H_t = a I + c u u^T (stick and slip branches as in the JAX package).
        `tiny` follows the dtype."""
        mu = self.params.friction
        if mu == 0.0:
            return torch.zeros((x_sv.shape[0], 3, 3), dtype=x_sv.dtype, device=x_sv.device)
        B, u, u2 = self._tangential(x_sv, xt_sv, veldt)
        eps = torch.sqrt(eps2)
        un = torch.sqrt(torch.clamp(u2, min=0.0))
        slip = u2 > eps2
        tiny = 1e-300 if x_sv.dtype == torch.float64 else 1e-30
        inv_un = 1.0 / torch.clamp(un, min=tiny)
        a = torch.where(slip, inv_un, (2.0 * eps - un) / eps2)
        f2 = torch.where(slip, torch.zeros_like(un), 2.0 * (eps - un) / eps2)
        c = torch.where(u2 > tiny, (f2 - a) / torch.clamp(u2, min=tiny), torch.zeros_like(u2))
        coef = mu * lam
        I2 = torch.eye(2, dtype=x_sv.dtype, device=x_sv.device)
        Ht = (coef * a)[:, None, None] * I2[None] + (coef * c)[:, None, None] * (
            u[:, :, None] * u[:, None, :]
        )
        return torch.einsum("ij,vjk,lk->vil", B, Ht, B)
