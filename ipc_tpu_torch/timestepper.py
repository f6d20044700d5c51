"""Projected-Newton interior-point time stepper: parameters, state and the
host path.

Port of ipc_tpu/timestepper.py: `SimParams`, `SimState` (with `dx_el`, the
elastic correction x - x_tilde that warm starts 3-4 read), `StepStats`,
and `IPCStepper`: the scene scalars, the kappa schedule (`suggest_kappa`,
`upper_bound_kappa`, `init_kappa`, host floats), the lagged half-space and
self-contact friction terms, `compute_x_tilde` (backward Euler and
Newmark) and the host path, `IPCStepper.step`, the JAX package's default
stepper. The device step (jit_step.make_step) reads the same stepper.

The host path is a different algorithm from the device step. Per step:

  * the host ACO plane move (`_step_aco`: velocity flips, then each plane
    moved by a clamped fraction of vel*dt, `HalfSpace.move_bound`);
  * the scripted DBC move, clamped by the inversion filter, the
    swept-span clamp and CCD, then halved until the mesh is free of
    edge-triangle intersections; mesh-sequence scripts read their frames
    here (scripting._load_seq_frame). An incomplete move starts the
    moving-DBC augmented Lagrangian: a sub-solve with every Dirichlet
    vertex free (`_solve_mdbc_al`) before the projected ones;
  * warm starts 1-5 (`SimParams.warm_start`), feasibility-filtered;
  * kappa from `init_kappa`, friction captured at the current fricDHat,
    lagged Rayleigh damping;
  * the outer loop: `_solve_sub_ip`, then the dHat homotopy (dHat halves
    toward its target, kappa re-initialized), the fricDHat homotopy, and
    the friction fixed point bounded by `fric_iter_amt` or, for
    fric_iter_amt <= 0, ended by the refreshed-tangent probe; a failsafe
    at 1000 outer iterations;
  * the blow-up detectors, then the integrator update.

`_solve_sub_ip` is one Newton loop: a fresh unswept broad phase every
iteration, the search direction (step_terms.py: PCG over the tet_hv
operator, or a direct solve with linsys "dense" / "sparse"), the
inversion and half-space bounds, the swept-span clamp (numpy, as the JAX
package's), a swept broad phase and ACCD, a backtracking line search on
host floats over the swept candidate set (compensated (hi, lo) energies
collapsed in Python float64 for float32), the global intersection
safeguard (a fresh edge-triangle broad phase), the moving-DBC AL control,
and the kappa doubling of postLineSearch.

The JAX package jit-compiles these kernels; here each is eager PyTorch on
the stepper's device, the card unless the mesh lives on the CPU. Every
value read back to the host counts in `host_syncs`, and every Newton
operator application (one tet_hv call each) in `operator_applications`
(running counts over the stepper's host steps).

The JAX candidate sets have fixed capacities that grow on overflow; the
port's are exact-size, so the `ensure_*` regrow loops fall away. The kappa
doubling compares the previous iteration's constraint distances with the
current ones position by position, as the JAX package does on its
capacity-padded arrays: the half-space distances, then the common prefix
of the PT and of the EE candidate lists.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from ipc_tpu_torch.contact import selfcollision as SC

__all__ = ["SimParams", "SimState", "IPCStepper", "StepStats"]


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
    `t` and `step` are host numbers. `dx_el` is the host path's elastic
    correction x - x_tilde of the last step (a (V,3) tensor, kept when
    warm_start >= 3, else None). `aux` is the device-script state, a dict
    of tensors (turning-rule signs and flags, moving-plane origins and
    velocities; jit_step.initial_device_aux) or None."""

    x: torch.Tensor
    x_prev: torch.Tensor
    v: torch.Tensor
    a: torch.Tensor
    t: float = 0.0
    step: int = 0
    dx_el: torch.Tensor = None
    aux: dict = None

    @property
    def device(self):
        return self.x.device

    @property
    def dtype(self):
        return self.x.dtype


@dataclass
class StepStats:
    """Per-step statistics of the host path (the JAX package's StepStats;
    iterStats.txt reads iters, alphas, n_constraints and grad_inf).
    `iters` is the last sub-solve's Newton count; the lists run over every
    sub-solve of the step."""

    iters: int = 0
    alphas: list = field(default_factory=list)
    energies: list = field(default_factory=list)
    grad_inf: list = field(default_factory=list)
    n_constraints: list = field(default_factory=list)
    kappa: float = 0.0
    pcg_iters: list = field(default_factory=list)
    intersection_backtracks: int = 0
    # postLineSearch kappa doublings
    kappa_doublings: int = 0
    # iterations whose line-search start the swept-span clamp reduced
    sweep_clamps: int = 0
    # Newton iterations in moving-DBC augmented-Lagrangian mode
    al_iters: int = 0


class IPCStepper:
    """Scene scalars, the objective's friction terms and the host-path
    stepper (module docstring) for one scene."""

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
        self.dHat_target = (params.dhat_target_rel**2) * self.bbox_diag2
        self.dTol = (params.dtol_rel**2) * self.bbox_diag2
        self.target_gres = float(np.sqrt(params.rel_gl2_tol * self.bbox_diag2 * self.dtSq))
        # moving-DBC pull threshold (reference CN_MBC)
        self.cn_mbc = float(np.sqrt(1e-4 * self.bbox_diag2 * self.dtSq))
        # fricDHat homotopy: the host path starts each step at fric_dhat0
        # and halves toward the target; the device step uses the target
        self.fric_dhat0 = (params.fric_dhat0_rel**2) * self.dtSq * self.bbox_diag2
        self.fric_dhat_target = (
            (params.fric_dhat_target_rel**2) * self.dtSq * self.bbox_diag2
        )
        self.fric_dhat = self.fric_dhat0
        self.avg_node_mass = meta.avg_node_mass
        self.gravity = np.asarray(params.gravity)

        # moving analytic planes (ACO scripts): host origins and per-step
        # displacements, moved by the host path's _step_aco; the device
        # step starts from these origins and carries its own in SimState.aux
        self.hs_origin = (
            np.array([np.asarray(h.params.origin, float) for h in self.halfspaces])
            if self.halfspaces else np.zeros((0, 3)))
        self.hs_veldt = np.zeros_like(self.hs_origin)
        self.hs_moving = bool(script is not None and getattr(script, "aco_kind", None)
                              and self.halfspaces)
        self._hs_D = None  # (n_hs,) plane offsets of the host path's moving planes
        if self.hs_moving:
            self._refresh_hs_D()

        self._sv = mesh.surf_verts
        self._dbc_sv = mesh.dbc_mask[mesh.surf_verts]
        self._dbc_np = mesh.dbc_mask.cpu().numpy()
        # broad-phase voxel size for the swept-span clamp (avgEdgeLen/3)
        xr = mesh.x_rest.detach().cpu().numpy().astype(np.float64)
        se = mesh.surf_edges.cpu().numpy()
        if len(se):
            self.voxel = float(
                np.linalg.norm(xr[se[:, 0]] - xr[se[:, 1]], axis=1).mean() / 3.0
            )
        else:
            self.voxel = float(np.sqrt(meta.bbox_diag2)) / 3.0
        self._sv_np = mesh.surf_verts.cpu().numpy()
        self._solve_fric = any(hs.params.friction > 0.0 for hs in self.halfspaces) or (
            self.sc is not None and (self.sc.friction > 0.0 or self.sc.vert_mu is not None))
        # the host path's terms (step_terms.build_terms), built at its first
        # step: one set on the mesh's mask, one with every vertex free for
        # the moving-DBC episode
        self._terms = {}
        self._counters = dict(operator=0, syncs=0)

    @property
    def operator_applications(self):
        """Newton-operator applications of the host path so far (one tet_hv
        call each)."""
        return self._counters["operator"]

    @property
    def host_syncs(self):
        """Values the host path has read back to the host so far."""
        return self._counters["syncs"]

    # ------------------------------------------------------------------
    # host reads and writes (each read counts in host_syncs)
    # ------------------------------------------------------------------

    def _floats(self, *ts):
        """Host float64s of 0-d tensors, in one read."""
        self._counters["syncs"] += 1
        return torch.stack([t.to(torch.float64) for t in ts]).tolist()

    def _np(self, t):
        self._counters["syncs"] += 1
        return t.detach().cpu().numpy()

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device).to(self.dtype)

    def _other_syncs(self):
        """Reads made inside the self-contact pipeline and the coarse
        assemblers, which keep their own counts."""
        n = self.sc.host_syncs if self.sc is not None else 0
        for T in self._terms.values():
            if T.coarse_assemble is not None:
                n += T.coarse_assemble.host_syncs
        return n

    def _terms_for(self, free=False):
        """The host path's terms on the mesh's mask, or (free=True) with
        every vertex free: the JAX package's `_swap_dbc_mask`."""
        if free not in self._terms:
            from ipc_tpu_torch.step_terms import build_terms

            like = self._terms.get(not free)
            self._terms[free] = build_terms(
                self, dbc=torch.zeros_like(self.mesh.dbc_mask) if free else None,
                host=True, like=like, counters=self._counters)
        return self._terms[free]

    # ------------------------------------------------------------------
    # moving analytic half-spaces (reference ACO scripts)
    # ------------------------------------------------------------------

    def _refresh_hs_D(self):
        """The plane offsets -n.origin from the host origins."""
        self._hs_D = self._tensor([-(h._n @ o) for h, o in zip(self.halfspaces,
                                                                self.hs_origin)])

    def _step_aco(self, x_sv_np):
        """Advance the scripted plane motion one step (reference
        stepAnimScript ACOSQUASH / ACOSQUASH6 / ACOSQUASHSHEAR): flip the
        velocities on the squash-separation conditions, then move each
        plane by a clamped fraction of vel*dt (HalfSpace.move_bound,
        slackness 0.5). Only squashshear sets hs_veldt, so its plane motion
        enters the friction terms."""
        script = self.script
        vel = script.aco_vel
        orig = self.hs_origin
        kind = script.aco_kind
        if kind == "squash" and len(orig) >= 2:
            if orig[1][0] - orig[0][0] < 0.1:
                vel[0][0] *= -1.0
                vel[1][0] *= -1.0
        elif kind == "squash6" and len(orig) >= 6:
            for a, b, ax, thr in ((0, 1, 0, 0.2), (2, 3, 1, 0.2), (4, 5, 2, 0.2)):
                if orig[b][ax] - orig[a][ax] < thr:
                    vel[a][ax] *= -1.0
                    vel[b][ax] *= -1.0
        elif kind == "squashshear" and len(orig) >= 2:
            if orig[1][0] - orig[0][0] < 0.8:
                vel[0][:] = 0.0
                vel[1][:] = (0.0, 1.0, 0.0)
        self.hs_veldt[:] = 0.0
        for i, hs in enumerate(self.halfspaces):
            if i >= len(vel):
                break
            dX = np.asarray(vel[i], float) * self.dt
            if not np.any(dX):
                continue
            if kind == "squashshear":
                self.hs_veldt[i] = dX
            D_i = -(hs._n @ self.hs_origin[i])
            s = hs.move_bound(x_sv_np, dX, D=D_i, slackness=0.5)
            self.hs_origin[i] = self.hs_origin[i] + s * dX
        self._refresh_hs_D()

    # ------------------------------------------------------------------
    # swept-span clamp (reference SpatialHash.hpp:589-619)
    # ------------------------------------------------------------------

    def _sweep_clamp(self, alpha, dx):
        """Clamp a line-search start `alpha` along dx so the swept broad
        phase stays sane: the mean co-moving travel over the surface stays
        inside one voxel, the largest inside 16 (numpy on the host, as the
        JAX package). Returns (alpha, clamped?)."""
        p_sv = self._np(dx)[self._sv_np]
        p_sv = np.abs(p_sv - p_sv.mean(axis=0))
        pSize = float(p_sv.mean())  # sum |components| / (nSV * 3)
        clamped = False
        span = alpha * pSize / self.voxel
        if span > 1.0:
            alpha /= span
            clamped = True
        mt = float(p_sv.max())
        if alpha * mt > 16.0 * self.voxel:
            alpha = 16.0 * self.voxel / mt
            clamped = True
        return alpha, clamped

    # ------------------------------------------------------------------
    # kappa schedule (reference suggestKappa / upperBoundKappa / initKappa)
    # ------------------------------------------------------------------

    def suggest_kappa(self, dHat):
        """Host-float C2 barrier Hessian at d = 1e-16 bboxDiag^2 (exact f64
        regardless of the device dtype; reference suggestKappa)."""
        d = 1e-16 * self.bbox_diag2
        t = d - dHat
        H_b = -2.0 * math.log(d / dHat) - 4.0 * t / d + (t * t) / (d * d)
        return self.p.kappa_min_mult * self.avg_node_mass / (4e-16 * self.bbox_diag2 * H_b)

    def upper_bound_kappa(self, kappa, dHat):
        return min(kappa, 100.0 * self.suggest_kappa(dHat))

    def init_kappa(self, x, x_tilde, kappa, dHat, cand, fric):
        """Balance the unit-kappa contact gradient against the rest of the
        objective's gradient on free DOFs (reference initKappa; host
        floats from numpy sums)."""
        T = self._terms_for()
        g_E = T.grad_no_contact(x, x_tilde) + self._friction_gradient(x, fric)
        g_c = T.grad_contact_unit(x, dHat, cand, self._hs_D)
        g_E, g_c = self._np(torch.stack([g_E, g_c]))
        free = ~self._dbc_np
        g_E, g_c = g_E[free], g_c[free]
        denom = float((g_c * g_c).sum())
        if denom <= 0.0:
            return kappa
        min_kappa = -float((g_c * g_E).sum()) / denom
        if min_kappa > 0.0:
            kappa = max(kappa, min_kappa)
        kappa = max(kappa, self.suggest_kappa(dHat))
        return self.upper_bound_kappa(kappa, dHat)

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

    def _capture_friction(self, x, x_anchor, kappa, dHat, cand):
        """All lagged friction state at iterate x, at the current fricDHat."""
        hs_veldt = None
        if self.hs_moving:
            hs_veldt = [self._tensor(v) if np.any(v) else None for v in self.hs_veldt]
        return self._terms_for().capture_friction(x, x_anchor, kappa, dHat, cand, self._hs_D,
                                                  hs_veldt, self.fric_dhat)

    # ------------------------------------------------------------------
    # time stepping
    # ------------------------------------------------------------------

    def compute_x_tilde(self, state: SimState):
        """The inertia target: x_prev + h v + h^2 g (backward Euler) or the
        Newmark predictor; DBC rows hold at the current (possibly scripted)
        position."""
        g = torch.as_tensor(self.gravity, device=self.device).to(self.dtype)
        if self.is_nm:
            beta = self.p.nm_beta
            xt = (state.x_prev + self.dt * state.v + beta * self.dtSq * g[None, :]
                  + (0.5 - beta) * self.dtSq * state.a)
        else:
            xt = state.x_prev + self.dt * state.v + self.dtSq * g[None, :]
        return torch.where(self.mesh.dbc_mask[:, None], state.x, xt)

    def initial_state(self, x0=None, v0=None):
        def conv(a):
            return torch.as_tensor(a, device=self.device).to(self.dtype)

        x = conv(x0) if x0 is not None else self.mesh.x_rest.clone()
        v = conv(v0) if v0 is not None else torch.zeros_like(x)
        return SimState(x=x, x_prev=x, v=v, a=torch.zeros_like(x))

    def _candidates(self, x, disp=None, free=False):
        """Constraint-set candidates at x (gap sqrt(dHat)), swept by disp;
        free: every vertex unprojected (the moving-DBC episode)."""
        if self.sc is None:
            return None
        return self.sc.build_candidates(x, disp, float(np.sqrt(self.dHat)), with_et=False,
                                        dbc_free=free)

    def _ccd_alpha(self, x, dx, cand):
        """Host float: the least safe fraction of dx over cand (ACCD)."""
        p = self.p
        return self._floats(self.sc.ccd_alpha(x, dx, cand, 1.0 - p.ccd_slackness_m,
                                              p.ccd_max_iter))[0]

    def _has_intersection(self, x, free=False):
        return self._floats(self.sc.has_intersection(x, dbc_free=free)[0])[0] != 0.0

    def step(self, state: SimState, verbose=False):
        """Advance one time step (reference Optimizer::solve +
        fullyImplicit_IP); returns (SimState, StepStats)."""
        p = self.p
        T = self._terms_for()
        syncs0 = self._other_syncs()
        stats = StepStats()
        x = state.x
        dHat = self.dHat
        mdbc_targets = None
        # the ACO plane move runs first, as stepAnimScript's ACO branches
        if self.hs_moving:
            self._step_aco(self._np(x[self._sv]))
        if self.script is not None and self.script.has_motion():
            x, mdbc_targets = self._scripted_motion(state)
            state = SimState(x=x, x_prev=state.x_prev, v=state.v, a=state.a, t=state.t,
                             step=state.step)

        x_tilde = self.compute_x_tilde(state)
        x = state.x
        if p.warm_start > 0:
            x = self._warm_start(state, x, x_tilde, dHat)

        cand = self._candidates(x)

        # NBC force field of this step (constant over the solve)
        fext = None
        if self.script is not None and self.script.nbc_groups:
            f = self.script.nbc_force(float(state.t), x.shape[0])
            if np.any(f):
                fext = self._tensor(f)

        # kappa init (reference fullyImplicit_IP)
        kappa = p.kappa
        if kappa > 0.0:
            kappa = self.upper_bound_kappa(kappa, dHat)
        else:
            kappa = self.suggest_kappa(dHat)
        if p.adaptive_kappa:
            kappa = self.init_kappa(x, x_tilde, kappa, dHat, cand, None)

        fric = self._capture_friction(x, state.x_prev, kappa, dHat, cand)

        damp = None
        if p.damping_stiff > 0.0:
            # A = (dampingStiff / dt) H_psi at the last committed state
            damp = dict(blocks=T.damping_blocks(state.x_prev), x_ref=state.x_prev)

        if mdbc_targets is not None and p.mdbc_al:
            x = self._solve_mdbc_al(x, state, mdbc_targets, kappa, dHat, fric, stats,
                                    verbose, fext, damp)
        # the outer homotopy / friction loop (reference fullyImplicit_IP)
        fric_iter = 0
        self.fric_dhat = self.fric_dhat0  # reset per step
        while True:
            x = self._solve_sub_ip(x, x_tilde, kappa, dHat, fric, stats, verbose, fext, damp)
            fric_iter += 1
            update_dhat = dHat > self.dHat_target * (1.0 + 1e-12)
            # fricIterAmt bounds the loop only once fricDHat has reached its
            # target; until then the smoothing homotopy keeps it alive
            at_fric_target = self.fric_dhat <= self.fric_dhat_target * (1.0 + 1e-12)
            update_fric = self._solve_fric
            fric_refreshed = False
            if update_fric and at_fric_target:
                if p.fric_iter_amt > 0 and fric_iter >= p.fric_iter_amt:
                    update_fric = False
                else:
                    # refreshed-tangent convergence test: recapture at the
                    # converged iterate and probe the Newton direction; below
                    # tolerance, the friction fixed point has converged (the
                    # termination rule of fric_iter_amt <= 0)
                    cand = self._candidates(x)
                    fric_probe = self._capture_friction(x, state.x_prev, kappa, dHat, cand)
                    dx_p = T.search_dir(x, x_tilde, kappa, dHat, cand, fric_probe, None, None,
                                        damp, fext, self._hs_D, None, T.dbc)[0]
                    if self._floats(torch.abs(dx_p).max())[0] < self.target_gres:
                        update_fric = False
                    else:
                        # at unchanged fric_dhat the loop-bottom recapture
                        # would be identical, so skip it there
                        fric = fric_probe
                        fric_refreshed = True
            if not update_dhat and not update_fric:
                break
            if fric_iter >= 1000:
                raise RuntimeError(
                    f"friction/homotopy outer loop did not converge in {fric_iter} "
                    f"iterations (fricIterAmt={p.fric_iter_amt})")
            if update_dhat:
                dHat = max(dHat * 0.5, self.dHat_target)
                fric_refreshed = False  # the capture depends on dHat
                if p.adaptive_kappa:
                    cand = self._candidates(x)
                    kappa = self.init_kappa(x, x_tilde, kappa, dHat, cand, fric)
            if update_fric and not at_fric_target:
                self.fric_dhat = max(self.fric_dhat * 0.5, self.fric_dhat_target)
                fric_refreshed = False
            if (update_fric or update_dhat) and not fric_refreshed:
                cand = self._candidates(x)
                fric = self._capture_friction(x, state.x_prev, kappa, dHat, cand)

        stats.kappa = kappa

        # blow-up detectors: a non-finite state or an absurd displacement
        finite, max_disp = self._floats(torch.isfinite(x).all(),
                                        torch.abs(x - state.x_prev).max())
        if not finite:
            raise RuntimeError(f"state blow-up: non-finite positions at step {int(state.step)}")
        if max_disp * max_disp > 100.0 * self.bbox_diag2:
            raise RuntimeError(
                f"state blow-up: displacement {max_disp:.3g} exceeds 10x scene "
                f"diagonal at step {int(state.step)}")

        # integrator update
        if self.is_nm:
            g = torch.as_tensor(self.gravity, device=self.device).to(self.dtype)
            beta, gamma = p.nm_beta, p.nm_gamma
            v_new = state.v + self.dt * (1.0 - gamma) * state.a
            a_new = (x - x_tilde) / (self.dtSq * beta) + g[None, :]
            v_new = v_new + self.dt * gamma * a_new
        else:
            v_new = (x - state.x_prev) / self.dt
            a_new = (v_new - state.v) / self.dt
        dx_el = (x - x_tilde) if p.warm_start >= 3 else None
        self._counters["syncs"] += self._other_syncs() - syncs0
        return (SimState(x=x, x_prev=x, v=v_new, a=a_new, t=state.t + self.dt,
                         step=state.step + 1, dx_el=dx_el), stats)

    def _scripted_motion(self, state):
        """The scripted DBC move (reference stepAnimScript): Dirichlet
        vertices move along their scripted motion, clamped by the inversion
        filter, the swept-span clamp and CCD, then halved until the mesh is
        intersection-free. Returns (x, AL targets), the targets None unless
        the move did not complete (< 1 - 1e-3)."""
        p = self.p
        T = self._terms_for()
        x = state.x
        x_np = self._np(x)
        disp_np = self.script.step_displacement(x_np, float(state.t), self.dt)
        if not np.any(disp_np):
            return x, None
        disp = self._tensor(disp_np)
        scale = min(1.0, self._floats(T.feasible_alpha_local(x, disp, self._hs_D))[0])
        # the swept-span clamp on the scripted sweep too; the AL completes
        # any clamped remainder
        scale, _ = self._sweep_clamp(scale, disp)
        if self.sc is not None:
            cand_s = self._candidates(x, disp=scale * disp)
            scale = self._ccd_alpha(x, scale * disp, cand_s) * scale
        while True:
            x_try = x + scale * disp
            if self.sc is None:
                x = x_try
                break
            if not self._has_intersection(x_try):
                x = x_try
                break
            scale *= 0.5
            if scale < 1e-6:
                if not p.mdbc_al:
                    raise RuntimeError("scripted motion cannot avoid intersection")
                scale = 0.0
                break
        if scale >= 1.0 - 1e-3:
            return x, None
        # targets: every DBC vertex's full scripted destination
        verts = np.where(self._dbc_np)[0]
        target = x_np[verts] + disp_np[verts]
        return x, (verts, self._tensor(target), float(np.linalg.norm(disp_np)))

    def _warm_start(self, state, x, x_tilde, dHat):
        """The initX modes: 1 explicit Euler dt v; 2 dt v + g dt^2 (BE) or
        + g dt^2 / 2 (Newmark); 3 and 4 add the last step's elastic
        correction dx_el (x1 and x0.5 BE, x2 and x1 Newmark); 5 one block-
        Jacobi descent step at the suggested kappa. Each is filtered for
        feasibility (inversion, half-spaces, swept-span clamp, CCD)."""
        p = self.p
        T = self._terms_for()
        if p.warm_start == 5:
            cand_j = self._candidates(x)
            dx0 = T.jacobi_dir(x, x_tilde, self.suggest_kappa(dHat), dHat, cand_j, self._hs_D)
        else:
            g_dtSq = torch.as_tensor(self.gravity, device=self.device).to(self.dtype)[None, :] \
                * self.dtSq
            if self.is_nm:
                g_dtSq = 0.5 * g_dtSq
            if p.warm_start == 1:
                dx0 = self.dt * state.v
            else:
                dx0 = self.dt * state.v + g_dtSq
            if p.warm_start >= 3 and state.dx_el is not None:
                c = {3: (1.0, 2.0), 4: (0.5, 1.0)}.get(p.warm_start, (0.0, 0.0))
                dx0 = dx0 + (c[1] if self.is_nm else c[0]) * state.dx_el
        dx0 = torch.where(self.mesh.dbc_mask[:, None], torch.zeros_like(dx0), dx0)
        alpha = self._floats(T.feasible_alpha_local(x, dx0, self._hs_D))[0]
        alpha, _ = self._sweep_clamp(alpha, dx0)
        if self.sc is not None:
            cand_ws = self._candidates(x, disp=alpha * dx0)
            alpha = min(alpha, self._ccd_alpha(x, alpha * dx0, cand_ws) * alpha)
        return x + alpha * dx0

    def _solve_sub_ip(self, x, x_tilde, kappa, dHat, fric, stats, verbose, fext=None,
                      damp=None, alw=None, al_denom=None):
        """One Newton loop (reference solveSub_IP). With `alw` (the
        moving-DBC pull: verts, target, lam, m, sqrtm, w = rho) it runs in
        augmented-Lagrangian mode with every vertex free: the pull enters
        every term, and the reference's rho doubling / lambda update /
        completion check runs after each step."""
        p = self.p
        free = alw is not None
        T = self._terms_for(free)
        sc = self.sc
        close_d2 = None
        last_move = 0.0
        ainv_c = None
        for k in range(p.max_newton):
            cand = self._candidates(x, free=free)
            if k == 0 and T.lag_coarse:
                # the lagged coarse matrix: once per sub-solve at its entry
                ainv_c = T.assemble_coarse(x, kappa, dHat, cand, fric, damp, self._hs_D, alw)
            dx, g, pcg_iters, active_count = T.search_dir(
                x, x_tilde, kappa, dHat, cand, fric, None, ainv_c, damp, fext, self._hs_D,
                alw, T.dbc)
            dist_to_opt, grad_inf = self._floats(torch.abs(dx).max(), torch.abs(g).max())
            stats.grad_inf.append(grad_inf)
            stats.pcg_iters.append(int(pcg_iters))
            if sc is not None:
                stats.n_constraints.append(active_count[0] + active_count[1])
            if k > 0 and dist_to_opt < self.target_gres and alw is None:
                break

            # feasible step: inversion + half-space closed form + mesh ACCD
            alpha = self._floats(T.feasible_alpha_local(x, dx, self._hs_D))[0]
            alpha, clamped = self._sweep_clamp(alpha, dx)
            if clamped:
                stats.sweep_clamps += 1
            if sc is not None:
                cand_ccd = self._candidates(x, disp=alpha * dx, free=free)
                alpha = min(alpha, self._ccd_alpha(x, alpha * dx, cand_ccd) * alpha)
                # covers every pair reachable within alpha
                act_ls = sc.candidate_set(cand_ccd)
            else:
                act_ls = None
            if alpha <= 0.0:
                raise RuntimeError("feasible step size is 0 (CCD)")

            # backtracking line search (Armijo c1 = 0) on host floats
            def energy(xe):
                self._counters["syncs"] += 1
                return T.e_float(T.energy(xe, x_tilde, kappa, dHat, fric, damp=damp, fext=fext,
                                          act=act_ls, hsD=self._hs_D, alw=alw))

            E0 = energy(x)
            stalled = False
            while True:
                x_new = x + alpha * dx
                E_new = energy(x_new)
                if E_new <= E0:
                    break
                if alpha < 1e-12:
                    # the energy's noise floor: no step decreases E
                    stalled = True
                    x_new = x
                    E_new = E0
                    break
                alpha *= 0.5
            # intersection safeguard: a fresh edge-triangle broad phase
            if sc is not None:
                while self._has_intersection(x_new, free):
                    alpha *= 0.5
                    stats.intersection_backtracks += 1
                    x_new = x + alpha * dx
                    if alpha < 1e-14:
                        raise RuntimeError("intersection safeguard failed")
            x = x_new
            stats.alphas.append(alpha)
            stats.energies.append(E_new)
            stats.iters = k + 1

            if alw is not None:
                # the reference's MDBC control
                stats.al_iters += 1
                dxt = x[alw["verts"]] - alw["target"]
                moved = 1.0 - float(np.linalg.norm(self._np(dxt))) / al_denom
                if moved > 1.0 - 1e-3 or k >= 100:
                    # finished, or obstructed: the remaining gap carries
                    # into the next step's scripted displacement
                    break
                rho = alw["w"]
                if moved < last_move and rho < 1e8:
                    alw["w"] = rho * 2.0
                elif dist_to_opt < self.cn_mbc:
                    if moved < 0.99 and rho < 1e8:
                        alw["w"] = rho * 2.0
                    else:
                        alw["lam"] = alw["lam"] - rho * alw["sqrtm"][:, None] * dxt
                last_move = moved

            if stalled:
                break

            if p.adaptive_kappa:
                kappa_prev = kappa
                kappa, close_d2 = self._post_line_search(x, kappa, dHat, close_d2,
                                                         cand_ccd if sc is not None else None,
                                                         T)
                if kappa > kappa_prev:
                    stats.kappa_doublings += 1

            if verbose:
                print(f"  newton {k}: |dx|={dist_to_opt:.3e} alpha={alpha:.3g} "
                      f"E={E_new:.6e} pcg={pcg_iters}")
        return x

    def _solve_mdbc_al(self, x, state, mdbc_targets, kappa, dHat, fric, stats, verbose,
                       fext, damp):
        """The moving-DBC augmented-Lagrangian episode: every Dirichlet
        vertex is free and pulled to its scripted target by
        -sqrt(m) lam.(x-t) + rho/2 m |x-t|^2 through one sub-solve with the
        reference's rho/lambda schedule; the caller's projected sub-solves
        follow. The JAX package swaps the mesh's mask and re-traces; here
        the sub-solve takes the all-free terms and broad phase instead."""
        verts, target, denom = mdbc_targets
        verts_t = torch.as_tensor(verts, device=self.device)
        m = self.mesh.mass[verts_t]
        alw = dict(verts=verts_t, target=target, lam=torch.zeros((len(verts), 3),
                                                                 dtype=self.dtype,
                                                                 device=self.device),
                   m=m, sqrtm=torch.sqrt(m), w=1.0e6)
        # x_tilde with the DBC rows at x_prev (computeXTilta keeps V_prev for
        # DBC vertices whatever the projection)
        x_tilde = torch.where(self.mesh.dbc_mask[:, None], state.x_prev,
                              self.compute_x_tilde(state))
        return self._solve_sub_ip(x, x_tilde, kappa, dHat, fric, stats, verbose, fext, damp,
                                  alw=alw, al_denom=denom)

    def _post_line_search(self, x, kappa, dHat, close_d2, cand, T):
        """Double kappa when a previously-close (d^2 < dTol) constraint got
        no farther (reference postLineSearch)."""
        d2_now = self._all_dist2(x, cand, T)
        if close_d2 is not None:
            closer = False
            for d0, d1 in zip(close_d2, d2_now):
                n = min(len(d0), len(d1))
                closer |= bool(np.any((d0[:n] < self.dTol) & (d1[:n] <= d0[:n])))
            if closer:
                kappa = self.upper_bound_kappa(kappa * 2.0, dHat)
        return kappa, d2_now

    def _all_dist2(self, x, cand, T):
        """(half-space, PT, EE) squared distances of the tracked constraints
        (numpy, one read). Dirichlet surface vertices count as infinitely
        far from the planes: a pinned vertex resting within dTol of a plane
        must not ratchet kappa."""
        parts = []
        x_sv = x[self._sv]
        for i, hs in enumerate(self.halfspaces):
            D_i = None if self._hs_D is None else self._hs_D[i]
            parts.append(torch.where(T.dbc_sv, torch.full_like(x_sv[:, 0], float("inf")),
                                     hs.dist2(x_sv, D=D_i)))
        n_pt = n_ee = 0
        if self.sc is not None and cand is not None:
            dpt, dee = SC.active_dist2(x, cand.pt_vids, cand.ee_vids, self.sc.tab)
            parts += [dpt, dee]
            n_pt, n_ee = dpt.shape[0], dee.shape[0]
        if not parts:
            return (np.zeros(0), np.zeros(0), np.zeros(0))
        flat = self._np(torch.cat(parts))
        n_hs = flat.shape[0] - n_pt - n_ee
        return flat[:n_hs], flat[n_hs:n_hs + n_pt], flat[n_hs + n_pt:]
