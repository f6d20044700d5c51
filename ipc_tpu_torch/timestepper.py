"""Time-stepper parameters, state and scene scalars.

Port of the parts of ipc_tpu/timestepper.py that the production step
(jit_step.make_step) reads: `SimParams` and `SimState` (:55-141), the
scalar setup of `IPCStepper.__init__` (:171-245, the moving-plane state
included), `suggest_kappa` (:332-340, a host float), the half-space and
self-contact friction terms (:776-848, with the planes' per-step
displacement) and `initial_state` (:910-913).

Not ported yet: the host-orchestrated `IPCStepper.step` / `_solve_sub_ip`
path (dHat homotopy, outer friction loop, moving-DBC sub-solve, the host
plane move `_step_aco`) and the kappa helpers it uses.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from ipc_tpu_torch.contact import selfcollision as SC

__all__ = ["SimParams", "SimState", "IPCStepper"]


@dataclass(frozen=True)
class SimParams:
    """Static solve parameters (host floats; the JAX package's defaults)."""

    dt: float = 0.025
    gravity: tuple = (0.0, -9.80665, 0.0)
    model: str = "NH"
    dhat_rel: float = 1e-3  # dHat = dhat_rel^2 * bboxDiag2 (squared units)
    epsv_rel: float = 1e-3  # per second
    rel_gl2_tol: float = 1e-4
    dtol_rel: float = 1e-9
    kappa: float = 0.0  # 0 -> suggest + adaptive
    kappa_min_mult: float = 1e11
    adaptive_kappa: bool = True
    fric_iter_amt: int = 1
    warm_start: int = 0
    max_newton: int = 10000
    pcg_tol: float = 1e-2
    pcg_maxiter: int = 1000
    coarse_precond: bool = True
    linsys: str = "pcg"
    mdbc_al: bool = True
    ccd_slackness_a: float = 0.9  # analytic CO step slack
    ccd_slackness_m: float = 0.8  # mesh CCD: keep 1-slackness of the gap
    ccd_max_iter: int = 64
    dhat_target_rel: float = 1e-3
    time_integration: str = "BE"
    nm_beta: float = 0.25
    nm_gamma: float = 0.5
    damping_stiff: float = 0.0
    fric_dhat0_rel: float = 1e-3
    fric_dhat_target_rel: float = 1e-3


@dataclass(frozen=True)
class SimState:
    """Dynamic simulation state: (V,3) tensors on one device, one dtype;
    `t` and `step` are host numbers. `aux` is the device-script state, a
    dict of tensors (turning-rule signs and flags, moving-plane origins and
    velocities; jit_step.initial_device_aux) or None. (The JAX SimState's
    `dx_el`, for the host path's warm start, arrives with that slice.)"""

    x: torch.Tensor
    x_prev: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    t: float = 0.0
    step: int = 0
    aux: dict = None

    @property
    def device(self):
        return self.x.device

    @property
    def dtype(self):
        return self.x.dtype


class IPCStepper:
    """Scene scalars and the objective's half-space friction terms."""

    def __init__(self, mesh, meta, params: SimParams, halfspaces=(),
                 self_contact=None, script=None):
        self.mesh = mesh
        self.meta = meta
        self.p = params
        self.halfspaces = list(halfspaces)
        self.sc = self_contact
        self.script = script

        self.dtype = mesh.x_rest.dtype
        self.device = mesh.x_rest.device
        self.dt = params.dt
        self.dtSq = params.dt * params.dt
        self.is_nm = params.time_integration == "NM"
        self.w_el = self.dtSq * (params.nm_beta if self.is_nm else 1.0)
        self.bbox_diag2 = meta.bbox_diag2
        self.dHat = (params.dhat_rel**2) * self.bbox_diag2
        self.dTol = (params.dtol_rel**2) * self.bbox_diag2
        self.target_gres = float(np.sqrt(params.rel_gl2_tol * self.bbox_diag2 * self.dtSq))
        # moving-DBC pull threshold (reference CN_MBC)
        self.cn_mbc = float(np.sqrt(1e-4 * self.bbox_diag2 * self.dtSq))
        # the jit path runs no fricDHat homotopy: friction uses the target
        self.fric_dhat_target = (
            (params.fric_dhat_target_rel**2) * self.dtSq * self.bbox_diag2
        )
        self.avg_node_mass = meta.avg_node_mass
        self.gravity = np.asarray(params.gravity)

        # moving analytic planes (ACO scripts): the planes' initial origins;
        # the step carries the current ones in SimState.aux
        self.hs_origin = (
            np.array([np.asarray(h.params.origin, float) for h in self.halfspaces])
            if self.halfspaces else np.zeros((0, 3)))
        self.hs_moving = bool(script is not None and getattr(script, "aco_kind", None)
                              and self.halfspaces)

        self._sv = mesh.surf_verts
        self._dbc_sv = mesh.dbc_mask[mesh.surf_verts]
        # broad-phase voxel size for the swept-span clamp (avgEdgeLen/3)
        xr = mesh.x_rest.detach().cpu().numpy().astype(np.float64)
        se = mesh.surf_edges.cpu().numpy()
        if len(se):
            self.voxel = float(
                np.linalg.norm(xr[se[:, 0]] - xr[se[:, 1]], axis=1).mean() / 3.0
            )
        else:
            self.voxel = float(np.sqrt(meta.bbox_diag2)) / 3.0
        self._solve_fric = any(hs.params.friction > 0.0 for hs in self.halfspaces) or (
            self.sc is not None and self.sc.friction > 0.0)

    def suggest_kappa(self, dHat):
        """Host-float C2 barrier Hessian at d = 1e-16 bboxDiag^2 (exact f64
        regardless of the device dtype; reference suggestKappa)."""
        d = 1e-16 * self.bbox_diag2
        t = d - dHat
        H_b = -2.0 * math.log(d / dHat) - 4.0 * t / d + (t * t) / (d * d)
        return self.p.kappa_min_mult * self.avg_node_mass / (4e-16 * self.bbox_diag2 * H_b)

    # ------------------------------------------------------------------
    # lagged half-space and self-contact friction (fric is a dict or None;
    # fric["sc"] is SelfContact.capture_friction's state or None;
    # fric["hs_veldt"] the moving planes' per-step displacements or None)
    # ------------------------------------------------------------------

    def _hs_friction(self, fric):
        veldts = fric.get("hs_veldt") or [None] * len(self.halfspaces)
        return [
            (hs, st, vdt) for hs, st, vdt in zip(self.halfspaces, fric["hs"], veldts)
            if hs.params.friction > 0.0
        ]

    def _friction_energy(self, x, fric):
        E = torch.zeros((), dtype=x.dtype, device=x.device)
        if fric is None:
            return E
        x_sv = x[self._sv]
        for hs, st, vdt in self._hs_friction(fric):
            E = E + hs.friction_energy(x_sv, fric["anchor"][self._sv], st, fric["eps2"],
                                       veldt=vdt)
        if fric.get("sc") is not None:
            E = E + SC.friction_energy(fric["sc"], x, fric["anchor"], fric["eps2"], 1.0)
        return E

    def _friction_gradient(self, x, fric):
        g = torch.zeros_like(x)
        if fric is None:
            return g
        x_sv = x[self._sv]
        for hs, st, vdt in self._hs_friction(fric):
            g = g.index_add(0, self._sv, hs.friction_grad_sv(
                x_sv, fric["anchor"][self._sv], st, fric["eps2"], veldt=vdt))
        if fric.get("sc") is not None:
            fr = fric["sc"]
            g = g + SC.friction_gradient(fr, x, fric["anchor"], fric["eps2"], 1.0,
                                         fr["vert_sum"])
        return g

    def _friction_hessians(self, x, fric):
        """List of (vids (N,k), H (N,3k,3k)) friction block families: one
        (Sv,1) family of 3x3 blocks per frictional half-space, then the
        self-contact pairs' (C,4) family of 12x12 blocks.

        The JAX package wraps each half-space's (Sv,3,3) blocks as (Sv,12,12)
        blocks on stencils (v,0,0,0) that are zero outside the (0,0) block;
        the port keeps the 3x3 blocks on (v,): the same operator without the
        exact zeros."""
        out = []
        if fric is None:
            return out
        x_sv = x[self._sv]
        for hs, st, vdt in self._hs_friction(fric):
            H3 = hs.friction_hess_blocks_sv(x_sv, fric["anchor"][self._sv], st, fric["eps2"],
                                            veldt=vdt)
            out.append((self._sv[:, None], H3))
        if fric.get("sc") is not None:
            fr = fric["sc"]
            out.append((fr["vids"], SC.friction_hessian_blocks(
                fr, x, fric["anchor"], fric["eps2"], 1.0)))
        return out

    def initial_state(self, x0=None, v0=None):
        def conv(a):
            return torch.as_tensor(a, device=self.device).to(self.dtype)

        x = conv(x0) if x0 is not None else self.mesh.x_rest.clone()
        v = conv(v0) if v0 is not None else torch.zeros_like(x)
        return SimState(x=x, x_prev=x, v=v, a=torch.zeros_like(x))
