"""QP/SQP constraint-solver time stepper, the comparison path.

Port of ipc_tpu/qp/stepper.py (reference constraintSolver QP | SQP:
fullyImplicit, Optimizer.cpp:1340-1515; solveQP :725-864;
updateActiveSet_QP :1294-1321; computeQPResidual with Fischer-Burmeister
:866-922). Per outer iteration of a step:

  1. constraints: the type's c / grad-c (qp/constraints.py) linearized at
     the iterate, rows grad_c . dx >= -c + offset, over the active set;
  2. QP: min 1/2 dx^T (M + h^2 H_el) dx + g^T dx subject to the rows, by
     the matrix-free ADMM solver (qp/admm.py); the objective operator's
     per-tet product is the tet_hv kernel (ops/tet_hv.py) on the mesh's
     incidence table, one launch per application;
  3. residuals: the KKT gradient (its A^T lambda a fixed-order gather-sum)
     and the Fischer-Burmeister complementarity residual, computed in
     numpy in the run's dtype as the JAX package does;
  4. active set: ACCD from the step-start positions through the iterate
     (slackness 0.1, 64 iterations) adds colliding candidate pairs with
     their toi; half-space rows activate for surface vertices within the
     offset band of a plane.

The step stops when no constraint was added, the KKT gradient is below
tolerance and (SQP) the FB residual is too. QP mode freezes the objective
Hessian at the step start; SQP refreshes it every iteration. No barrier,
no friction and no intersection guarantee: the documented properties of
the methods the IPC paper measures itself against. Like the JAX
stepper, it runs no scripted motion and no plane move.

The active set is a dict in insertion order (half-space rows by plane,
then surface vertex; PT then EE pairs in candidate order); the QP's rows
are its pairs in that order, then its half-space rows. The JAX package
pads them to a capacity that grows on overflow (`cap_active`); the port's
rows are exact-size. Host reads (utils/observability's `host_read`) count
in `host_syncs`, operator applications in `operator_applications`, and
the PCG iterations inside ADMM (`admm.pcg_iters`) in `pcg_iterations`:
running counts over the stepper's steps. `StepStats.pcg_iters` holds the
ADMM iteration count of each outer iteration, as in the JAX package.
"""

import numpy as np
import torch

from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt
from ipc_tpu_torch.energy import elasticity as EL
from ipc_tpu_torch.ops.scatter import make_dynamic_gather_sum
from ipc_tpu_torch.ops.tet_hv import make_tet_hv_table, tet_hv
from ipc_tpu_torch.parallel import spmd
from ipc_tpu_torch.qp.admm import admm_qp
from ipc_tpu_torch.qp.constraints import FAMILY_OF_TYPE, constraint_c_grad
from ipc_tpu_torch.solver.pcg import apply_block_precond, block_jacobi_inverse
from ipc_tpu_torch.timestepper import IPCStepper, SimState, StepStats
from ipc_tpu_torch.utils.observability import count, counter, host_reads

__all__ = ["QPStepper"]

# corner-diagonal 3x3 blocks of (T,12,12): element (c,i,c,j) at flat c*39 + i*12 + j
_DIAG_IX = [c * 39 + i * 12 + j for c in range(4) for i in range(3) for j in range(3)]


class QPStepper(IPCStepper):
    """Host orchestrator of the QP/SQP comparison modes (module docstring).

    mode: "QP" (objective Hessian frozen at the step start, reference
    solveWithQP) or "SQP" (re-linearized every iteration)."""

    def __init__(self, mesh, meta, params, halfspaces=(), self_contact=None, script=None,
                 mode="SQP", constraint_type="volume", constraint_offset=0.0, max_outer=50):
        super().__init__(mesh, meta, params, halfspaces=halfspaces,
                         self_contact=self_contact, script=script)
        self.mode = mode.upper()
        if self.mode not in ("QP", "SQP"):
            raise ValueError(f"mode={mode!r}: 'QP' or 'SQP'")
        self.constraint_type = constraint_type.lower()
        if self.constraint_type not in FAMILY_OF_TYPE:
            raise ValueError(f"constraint_type={constraint_type!r}: one of "
                             f"{', '.join(FAMILY_OF_TYPE)}")
        self.constraint_offset = constraint_offset
        self.max_outer = max_outer
        self.fb_tol = 1e-4 * np.sqrt(self.bbox_diag2)
        self.pcg_iterations = 0
        self._hv_table = make_tet_hv_table(mesh.tets.cpu().numpy(), int(mesh.x_rest.shape[0]),
                                           self.device)
        self._dix = torch.as_tensor(_DIAG_IX, device=self.device)
        self._zero = torch.zeros((), dtype=self.dtype, device=self.device)

    # -- the QP's objective (elasticity + inertia, no contact) --------------

    def _dbc_rows(self, a):
        """a with the Dirichlet rows zeroed."""
        return torch.where(self.mesh.dbc_mask.reshape((-1,) + (1,) * (a.dim() - 1)),
                           self._zero, a)

    def _qp_energy(self, x, x_tilde):
        mesh = self.mesh
        E = self.w_el * EL.elasticity_energy_per_elem(x, mesh, self.p.model).sum()
        dx = x - x_tilde
        return E + 0.5 * (mesh.mass[:, None] * dx * dx).sum()

    def _qp_grad(self, x, x_tilde):
        mesh = self.mesh
        g = self.w_el * EL.elasticity_gradient(x, mesh, self.p.model, self._hv_table.gsum)
        return self._dbc_rows(g + mesh.mass[:, None] * (x - x_tilde))

    def _qp_hess_blocks(self, x):
        return self.w_el * EL.elasticity_hessian_blocks(x, self.mesh, self.p.model, True)

    def _qp_make_apply(self, Hel):
        """P v = M v + sum_t H_t v4_t on free rows (tet_hv), zero on DBC rows
        (v is projected first)."""
        mesh = self.mesh

        def P_apply(v):
            count("operator.applications")
            v = self._dbc_rows(v)
            # JAX then takes v on the DBC rows, where both are zero
            return self._dbc_rows(mesh.mass[:, None] * v + tet_hv(Hel, v, self._hv_table))

        return P_apply

    def _qp_precond(self, Hel):
        """Block-Jacobi preconditioner of P: mass plus the tets' corner
        blocks, identity on DBC rows."""
        mesh = self.mesh
        eye = torch.eye(3, dtype=self.dtype, device=self.device)[None]
        d4 = Hel.reshape(Hel.shape[0], 144)[:, self._dix].reshape(-1, 3, 3)
        diag = mesh.mass[:, None, None] * eye + self._hv_table.gsum(d4)
        diag = torch.where(mesh.dbc_mask[:, None, None], eye, diag)
        inv_diag = block_jacobi_inverse(diag)

        def precond(r):
            return apply_block_precond(inv_diag, r)

        return precond

    def _qp_constraints(self, x_prev, x, vids, is_ee, toi):
        """(c (P,), grad rows (P,4,3)) of the pair rows, DBC columns zeroed."""
        c, g = constraint_c_grad(self.constraint_type, x_prev[vids], x[vids], is_ee, toi)
        g = torch.where(self.mesh.dbc_mask[vids][:, :, None], torch.zeros_like(g), g)
        return c, g

    # -- active set (host-persistent per step) ------------------------------

    def _update_active_set(self, aset, x_start, x_target):
        """CCD from x_start through x_target (reference updateActiveSet_QP):
        colliding candidate pairs join `aset` (key -> (vids, is_ee, toi)),
        or refresh their toi; half-space rows activate for surface vertices
        whose target is within the offset band of the plane or below it
        (key -> ("hs", vertex, normal, D)). Returns True when a constraint
        was added."""
        added = False
        sv = self._sv_np
        if self.halfspaces:
            x_sv = x_target[self._sv]
            gaps = self._np(torch.stack([hs.signed_dist(x_sv) for hs in self.halfspaces]))
            band = self.constraint_offset + 1e-3 * float(np.sqrt(self.bbox_diag2))
            for hsi, (hs, gap) in enumerate(zip(self.halfspaces, gaps)):
                for si in np.nonzero(gap < band)[0]:
                    key = ("hs", hsi, int(sv[si]))
                    if key not in aset:
                        aset[key] = ("hs", int(sv[si]), np.asarray(hs._n, float), float(hs._D))
                        added = True
        if self.sc is None:
            return added
        disp = x_target - x_start
        cand = self.sc.build_candidates(x_start, disp, float(np.sqrt(self.dHat)),
                                        with_et=False)
        n_pt = cand.pt_vids.shape[0]
        t = torch.cat([accd_pt(x_start[cand.pt_vids], disp[cand.pt_vids], 0.1, 64),
                       accd_ee(x_start[cand.ee_vids], disp[cand.ee_vids], 0.1, 64)])
        vids_all = torch.cat([cand.pt_vids, cand.ee_vids])
        t, vids_all = self._np(t), self._np(vids_all)
        for lo, hi, is_ee in ((0, n_pt, False), (n_pt, len(t), True)):
            for i in lo + np.nonzero(t[lo:hi] < 1.0 - 1e-9)[0]:
                key = (is_ee,) + tuple(int(v) for v in vids_all[i])
                if key not in aset:
                    aset[key] = (vids_all[i].copy(), is_ee, float(t[i]))
                    added = True
                else:  # refresh the toi (the Verschoor family's contact point)
                    v, e, _ = aset[key]
                    aset[key] = (v, e, float(t[i]))
        return added

    def _aset_arrays(self, aset):
        """The active set as exact-size tensors: pairs (vids (P,4), is_ee
        (P,), toi (P,)) and half-space rows (vids (H,4), the vertex in every
        column; rows (H,4,3), the plane normal in row 0; D (H,))."""
        pairs = [v for v in aset.values() if not isinstance(v[0], str)]
        hs = [v for v in aset.values() if isinstance(v[0], str)]
        dev, dt = self.device, self.dtype
        vids = np.zeros((len(pairs), 4), np.int64)
        is_ee = np.zeros((len(pairs),), bool)
        toi = np.ones((len(pairs),), np.float64)
        for i, (v, e, t) in enumerate(pairs):
            vids[i], is_ee[i], toi[i] = v, e, t
        hvids = np.zeros((len(hs), 4), np.int64)
        hrows = np.zeros((len(hs), 4, 3))
        hD = np.zeros((len(hs),))
        for i, (_, v, n, D) in enumerate(hs):
            # the zero rows 1-3 sit on the vertex itself (JAX's on vertex 0):
            # the same sums, without one vertex in every half-space row,
            # which would widen A^T's gather-sum table to 3x their count
            hvids[i], hrows[i, 0], hD[i] = v, n, D
        return ((torch.as_tensor(vids, device=dev), torch.as_tensor(is_ee, device=dev),
                 torch.as_tensor(toi, device=dev).to(dt)),
                (torch.as_tensor(hvids, device=dev), torch.as_tensor(hrows, device=dev).to(dt),
                 torch.as_tensor(hD, device=dev).to(dt)))

    # -- one time step ------------------------------------------------------

    def step(self, state: SimState, verbose=False):
        """Advance one time step by the QP/SQP iteration (module docstring);
        returns (SimState, StepStats). Not under an active process group."""
        if spmd.active_group() is not None:
            raise NotImplementedError("QPStepper.step does not run sharded")
        mesh = self.mesh
        reads0, ops0, pcg0 = (host_reads(), counter("operator.applications"),
                              counter("admm.pcg_iters"))
        stats = StepStats()
        x_start = state.x
        x_tilde = self.compute_x_tilde(state)
        x = state.x
        aset = {}
        Hel = self._qp_hess_blocks(x)  # QP mode freezes this; SQP refreshes it
        P_apply, precond = self._qp_make_apply(Hel), self._qp_precond(Hel)
        rho = float(self.avg_node_mass)
        eps_abs = 1e-7 * float(np.sqrt(self.bbox_diag2))
        for it in range(self.max_outer):
            g = self._qp_grad(x, x_tilde)
            if self.mode == "SQP" and it > 0:
                Hel = self._qp_hess_blocks(x)
                P_apply, precond = self._qp_make_apply(Hel), self._qp_precond(Hel)

            (vids, is_ee, toi), (hvids, hrows, hD) = self._aset_arrays(aset)
            c, rows = self._qp_constraints(x_start, x, vids, is_ee, toi)
            # half-space rows: c = n . x_v + D (linear, constant gradient)
            hc = (hrows[:, 0] * x[hvids[:, 0]]).sum(-1) + hD
            hrows_m = torch.where(mesh.dbc_mask[hvids][:, :, None], torch.zeros_like(hrows),
                                  hrows)
            all_rows = torch.cat([rows, hrows_m])
            all_vids = torch.cat([vids, hvids])
            all_c = torch.cat([c, hc])
            K = int(all_c.shape[0])
            # A^T's fixed-order gather-sum, for ADMM and the KKT gradient
            vert_sum = make_dynamic_gather_sum(all_vids.reshape(-1), x.shape[0])
            dx, lam, admm_iters = admm_qp(
                P_apply, g, all_rows, all_vids,
                torch.ones((K,), dtype=torch.bool, device=self.device),
                -all_c + self.constraint_offset, precond=precond, rho=rho, iters=200,
                eps_abs=eps_abs, vert_sum=vert_sum)
            x = x + self._dbc_rows(dx)

            # residuals at the new iterate (reference computeQPResidual)
            g_new = self._qp_grad(x, x_tilde)
            ATlam = vert_sum((all_rows * lam[:, None, None]).reshape(-1, 3))
            grad_kkt = self._dbc_rows(g_new - ATlam)
            c_new, _ = self._qp_constraints(x_start, x, vids, is_ee, toi)
            hc_new = (hrows[:, 0] * x[hvids[:, 0]]).sum(-1) + hD
            sqn_g, grad_inf = self._floats((grad_kkt * grad_kkt).sum(), torch.abs(grad_kkt).max())
            # Fischer-Burmeister in numpy, in the run's dtype (as JAX does)
            lam_c = self._np(torch.stack([lam, torch.cat([c_new, hc_new])]))
            lam_np, c_np = lam_c[0], lam_c[1]
            with np.errstate(over="ignore"):
                fb = lam_np + c_np - np.sqrt(lam_np**2 + c_np**2)
            fb_norm = float(np.linalg.norm(fb))

            added = self._update_active_set(aset, x_start, x)

            stats.iters = it + 1
            stats.grad_inf.append(grad_inf)
            stats.n_constraints.append(len(aset))
            stats.pcg_iters.append(admm_iters)
            if verbose:
                print(f"  qp {it}: |KKT|^2={sqn_g:.3e} fb={fb_norm:.3e} "
                      f"K={len(aset)} admm={admm_iters}")
            if (not added) and sqn_g <= self.target_gres**2 and (
                    self.mode == "QP" or fb_norm <= self.fb_tol):
                break

        self.host_syncs += host_reads() - reads0
        self.operator_applications += counter("operator.applications") - ops0
        self.pcg_iterations += counter("admm.pcg_iters") - pcg0
        v_new = (x - state.x_prev) / self.dt
        a_new = (v_new - state.v) / self.dt
        return (SimState(x=x, x_prev=x, v=v_new, a=a_new, t=state.t + self.dt,
                         step=state.step + 1), stats)

