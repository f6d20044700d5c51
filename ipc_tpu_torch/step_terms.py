"""The Newton solve's per-iteration terms, shared by both steppers.

`build_terms(stepper, ...)` returns the objective's pieces for one mesh and
one Dirichlet mask, as closures over the scene's static tables (the Hv
kernel's incidence table, the coarse aggregates):

  * `energy` (compensated (hi, lo) pairs in float32, ops/compensated.py;
    `e_leq`, `e_out` and `e_float` read them), `gradient`,
    `grad_no_contact`, `grad_contact_unit` (the unit-kappa barrier
    gradient that initializes kappa);
  * `search_dir`: the SPD-projected blocks (elasticity, half-space and pair
    barriers, friction, the moving-DBC pull), block-Jacobi plus the
    two-level coarse preconditioner, and PCG over the Newton operator,
    whose per-tet product is the tet_hv kernel (ops/tet_hv.py); with
    `linsys` "dense" or "sparse" a direct solve of the assembled system
    (solver/direct.py, solver/sparse_direct.py) instead;
  * `jacobi_dir`, the block-Jacobi descent direction of warm start 5;
  * `feasible_alpha_local` (inversion cubic and half-space bounds),
    `span_clamp` (the swept-span clamp on the device), `capture_friction`,
    `damping_blocks`, `assemble_coarse` (the lagged coarse matrix).

Two steppers build them. The device step (jit_step.make_step) builds one
set on the mesh's mask. The host path (timestepper.IPCStepper.step)
builds them with `host=True`, which follows the JAX host path where it
differs from the device step: the Newton matrix of `search_dir` leaves out
the lagged damping blocks (the lagged coarse matrix keeps them), the
moving-DBC pull enters the coarse matrix, and `linsys` picks the solver.
Its moving-DBC episode frees every Dirichlet vertex: it builds a second set
with an all-False mask (`dbc=`), the counterpart of the JAX package's
`_swap_dbc_mask`, which rebinds every kernel to such a mask.

Under an active process group (parallel/spmd.py; the stepper's mesh holds
the rank's tets, parallel/sharding.shard_stepper) each function returns
the value summed over ranks: the rank evaluates its tets and pairs, the
owner rank (0) adds the replicated terms once (mass, the moving-DBC pull,
external forces, half-space barrier and friction), in the order of the
unsharded sum, and one collective adds the ranks' partials: a (V,3) sum
per gradient and per operator application, a (V,3,3) sum for the block-
Jacobi diagonal, a (C,C,3,3) sum for the coarse matrix (in
solver/coarse.py), the energy's (hi, lo) pairs or float64 totals in rank
order, and the least inversion-safe step. The DBC masks apply after the
sum. PCG's vectors and dots are replicated. With no active group the
collectives are identities and every function computes what it did
before, in the same order.

Functions take the barrier's `dHat` as an argument (the host path's dHat
homotopy changes it between sub-solves). Each operator application (one
tet_hv call) counts in the counter `operator.applications`, and values
read back to the host (PCG's residual tests, `e_float`, the direct solves'
copies) go through `host_read`, which counts them (utils/observability);
the layers are spans there: `search_dir` with `elasticity`, `pcg` and
`coarse_assemble` inside (the self-contact pipeline adds `active_set` and
`pairs`).
"""

import types

import torch

from ipc_tpu_torch.energy import elasticity as EL
from ipc_tpu_torch.ops.tet_hv import make_tet_hv_table, tet_hv
from ipc_tpu_torch.parallel import spmd
from ipc_tpu_torch.solver.coarse import build_aggregates, make_coarse_assembler
from ipc_tpu_torch.solver.pcg import apply_block_precond, block_jacobi_inverse, pcg
from ipc_tpu_torch.utils.observability import count, host_read, reading, span

__all__ = ["build_terms"]


def build_terms(stepper, dbc=None, host=False, like=None):
    """The terms of `stepper`'s objective (module docstring).

    dbc: the Dirichlet mask (V,) bool (default: the mesh's); host: the JAX
    host path's variants; like: a terms namespace of the same stepper whose
    static tables (Hv table, aggregates) are reused."""
    mesh = stepper.mesh
    p = stepper.p
    sc = stepper.sc
    dtype = stepper.dtype
    device = stepper.device
    n_verts = int(mesh.x_rest.shape[0])
    tets_np = mesh.tets.cpu().numpy()
    # static tet topology: the Hv kernel's incidence table and the
    # deterministic gather-sum assembly over the same table (ops/scatter)
    hv_table = like.hv_table if like is not None else make_tet_hv_table(tets_np, n_verts,
                                                                        device)
    gsum_tet = hv_table.gsum
    dt = stepper.dt
    w_el = stepper.w_el  # h^2 (BE) or beta h^2 (Newmark)
    dbc = mesh.dbc_mask if dbc is None else dbc
    sv = mesh.surf_verts
    dbc_sv = dbc[sv]
    halfspaces = stepper.halfspaces
    voxel = float(stepper.voxel)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    aggregates = None
    coarse_assemble = coarse_term = None
    if p.coarse_precond:
        aggregates = like.aggregates if like is not None else build_aggregates(
            mesh.x_rest.cpu().numpy())
        coarse_assemble, coarse_term = make_coarse_assembler(
            *aggregates, dbc, dtype, tets=tets_np
        )
    # the coarse assembly runs once per step (device step) or sub-solve
    # (host path) at scale, once per Newton iteration below it (as in the
    # JAX package); a rank decides on the whole padded mesh's tets
    shard = getattr(stepper, "shard", None)
    lag_coarse = (int(mesh.tets.shape[0]) if shard is None else shard.n_tets) >= 32768
    # the rank that adds the replicated terms (every rank without a group)
    owner = spmd.owner()
    linsys = p.linsys if host else "pcg"

    def masked(mask, a):
        return torch.where(mask, torch.zeros_like(a), a)

    def hsd(hsD, i):
        return None if hsD is None else hsD[i]

    # compensated (double-float) energy accumulation for float32 runs: the
    # barrier term is ~1e-7 of inertia+elasticity in a contact step, so a
    # plain-f32 `E_try <= E0` cannot see it (ops/compensated.py)
    use_df = dtype == torch.float32
    if use_df:
        from ipc_tpu_torch.ops.compensated import df_add, df_leq, df_sum, df_to_float

        def e_zero():
            return (zero, zero)

        def e_add_s(E, s):
            return df_add(E, (s, torch.zeros_like(s)))

        def e_add_v(E, v):
            return df_add(E, df_sum(v.reshape(-1)))

        e_add_t = df_add
        e_leq = df_leq
        e_out = df_to_float
        e_reduce = spmd.df_all_sum

        def e_float(E):
            """Host float64 of a (hi, lo) pair (one host read)."""
            hi, lo = host_read("energy", torch.stack(E).to(torch.float64))
            return hi + lo
    else:

        def e_zero():
            return zero

        def e_add_s(E, s):
            return E + s

        def e_add_v(E, v):
            return E + v.sum()

        def e_add_t(E, t):
            return E + t

        e_reduce = spmd.all_sum

        def e_leq(a, b):
            return a <= b

        def e_out(E):
            return E

        def e_float(E):
            return host_read("energy", E)

    def damping_Av(x, damp):
        """(v4 (T,12), A v4) of the lagged damping term at x."""
        v4 = masked(dbc[:, None], x - damp["x_ref"])[mesh.tets].reshape(-1, 12)
        return v4, torch.einsum("tij,tj->ti", damp["blocks"], v4)

    def damping_blocks(x_prev):
        """Lagged Rayleigh damping: the SPD elasticity blocks at x_prev
        scaled by dampingStiff/dt (without the Newton matrix's h^2)."""
        with span("elasticity"):
            return (p.damping_stiff / dt) * EL.elasticity_hessian_blocks(x_prev, mesh,
                                                                         p.model, True)

    def energy(x, x_tilde, kappa, dHat, fric, damp=None, fext=None, act=None, hsD=None,
               alw=None):
        with span("elasticity"):
            E = e_add_v(e_zero(), w_el * EL.elasticity_energy_per_elem(x, mesh, p.model))
        if owner:
            dxv = x - x_tilde
            E = e_add_v(E, 0.5 * mesh.mass[:, None] * dxv * dxv)
            if alw is not None:
                # moving-DBC AL: -sqrt(m) lam.(x-t) + rho/2 m|x-t|^2
                dxt = x[alw["verts"]] - alw["target"]
                E = e_add_s(E, -(alw["sqrtm"][:, None] * alw["lam"] * dxt).sum())
                E = e_add_s(E, 0.5 * alw["w"] * (alw["m"][:, None] * dxt * dxt).sum())
            if fext is not None:
                # NBC work on free vertices
                E = e_add_s(E, -w_el * masked(dbc[:, None],
                                              mesh.mass[:, None] * fext * x).sum())
            x_sv = x[sv]
            for i, hs in enumerate(halfspaces):
                E = e_add_s(E, hs.energy(x_sv, kappa, dHat, D=hsd(hsD, i)))
        if act is not None:
            E = e_add_t(E, sc.energy_active(x, act, kappa, dHat, df=use_df))
        # half-space friction on the owner only (the stepper's _hs_friction)
        E = e_add_s(E, stepper._friction_energy(x, fric))
        if damp is not None:
            v4, Av = damping_Av(x, damp)
            E = e_add_v(E, 0.5 * v4 * Av)
        return e_reduce(E)

    def contact_grad(x, kappa, dHat, hsD=None):
        """(V,3) half-space barrier gradient (surface rows only)."""
        x_sv = x[sv]
        g_sv = torch.zeros_like(x_sv)
        for i, hs in enumerate(halfspaces):
            g_sv = g_sv + hs.grad_sv(x_sv, kappa, dHat, D=hsd(hsD, i))
        # sv is unique: one addend per row, deterministic on CUDA too
        return torch.zeros_like(x).index_add(0, sv, g_sv)

    def grad_no_contact_part(x, x_tilde):
        """This rank's part of grad_no_contact (the whole without a group)."""
        with span("elasticity"):
            g = w_el * EL.elasticity_gradient(x, mesh, p.model, vert_sum=gsum_tet)
        return g + mesh.mass[:, None] * (x - x_tilde) if owner else g

    def grad_no_contact(x, x_tilde):
        return spmd.all_sum(grad_no_contact_part(x, x_tilde))

    def grad_contact_unit(x, dHat, cand, hsD=None):
        """(V,3) barrier gradient at kappa 1: half-spaces, and the pairs of
        `cand` inside dHat."""
        g = contact_grad(x, 1.0, dHat, hsD) if owner else torch.zeros_like(x)
        if sc is not None:
            g = g + sc.gradient_active(x, sc.active_set(x, cand, dHat), 1.0, dHat)
        return spmd.all_sum(g)

    def gradient(x, x_tilde, kappa, dHat, fric, damp, fext, act, hsD, alw, dbc_t):
        g = grad_no_contact_part(x, x_tilde)
        if owner:
            if alw is not None:
                dxt = x[alw["verts"]] - alw["target"]
                # the AL's vertices are unique
                g = g.index_add(0, alw["verts"], -alw["sqrtm"][:, None] * alw["lam"]
                                + alw["w"] * alw["m"][:, None] * dxt)
            if fext is not None:
                g = g - w_el * mesh.mass[:, None] * fext
            g = g + contact_grad(x, kappa, dHat, hsD)
        if act is not None:
            g = g + sc.gradient_active(x, act, kappa, dHat)
        g = g + stepper._friction_gradient(x, fric)
        if damp is not None:
            g = g + gsum_tet(damping_Av(x, damp)[1].reshape(-1, 3))
        return masked(dbc_t[:, None], spmd.all_sum(g))

    def hs_blocks(x, kappa, dHat, hsD=None):
        x_sv = x[sv]
        Hsv = torch.zeros((sv.shape[0], 3, 3), dtype=dtype, device=device)
        for i, hs in enumerate(halfspaces):
            Hsv = Hsv + hs.hess_blocks_sv(x_sv, kappa, dHat, D=hsd(hsD, i))
        return Hsv

    def tet_blocks(x, damp):
        with span("elasticity"):
            Hel = w_el * EL.elasticity_hessian_blocks(x, mesh, p.model, True)
        return Hel if damp is None else Hel + damp["blocks"]

    def al_family(alw):
        """The moving-DBC pull rho m I as a per-vertex block family."""
        return (alw["verts"][:, None], (alw["w"] * alw["m"])[:, None, None] * eye3[None])

    def assemble_coarse(x, kappa, dHat, cand, fric, damp, hsD, alw=None):
        """Galerkin coarse matrix of every block family, lagged at scale
        (the device step leaves the AL pull out, as the JAX package's)."""
        if coarse_assemble is None:
            return None
        with span("coarse_assemble"):
            contribs = [(sv[:, None], hs_blocks(x, kappa, dHat, hsD))]
            if sc is not None:
                vids_act, H_act, _ = sc.hessian_blocks_active(x, cand, kappa, dHat, True)
                contribs.append((vids_act, H_act))
            contribs += stepper._friction_hessians(x, fric)
            if host and alw is not None:
                contribs.append(al_family(alw))
            return coarse_assemble(mesh.mass, contribs, tet_H=tet_blocks(x, damp))

    # corner-diagonal 3x3 blocks of (N,12,12) via one static column gather:
    # element (c,i,c,j) sits at flat column c*39 + i*12 + j
    dix = torch.as_tensor(
        [c * 39 + i * 12 + j for c in range(4) for i in range(3) for j in range(3)],
        device=device,
    )

    def diag_blocks12(H):
        return H.reshape(H.shape[0], 144)[:, dix].reshape(-1, 4, 3, 3)

    def friction_families(fric_blocks, fric):
        """Split the friction block families: per-vertex [(ids (N,),
        H (N,3,3))] (half-spaces) and pair [(vids (N,4), H (N,12,12),
        vertex gather-sum)] (self-contact)."""
        vert_fams, pair_fams = [], []
        for ids, Hf in fric_blocks:
            if ids.shape[1] == 1:
                vert_fams.append((ids[:, 0], Hf))
            elif ids.shape[0]:
                pair_fams.append((ids, Hf, fric["sc"]["vert_sum"]))
        return vert_fams, pair_fams

    def pair_hv(fam, v):
        vids, H, vsum = fam
        return vsum(torch.einsum("cij,cj->ci", H, v[vids].reshape(-1, 12)).reshape(-1, 3))

    def pair_diag(fam):
        _, H, vsum = fam
        return vsum(diag_blocks12(H).reshape(-1, 3, 3))

    def barrier_families(x, act, kappa, dHat):
        """([(vids, H, vertex gather-sum)] of the active pairs' SPD blocks,
        (cnt_pt, cnt_ee))."""
        if sc is None:
            return [], (0, 0)
        vids_act, H_act, active_count = sc.hessian_blocks_from_active(x, act, kappa, dHat,
                                                                      True)
        fams = [(vids_act, H_act, sc.vert_sum(act))] if H_act.shape[0] else []
        return fams, active_count

    def direct_solve(rhs, Hel, Hsv, barrier_fams, fric_blocks, alw, dbc_t):
        """Exact solve of the assembled Newton system (linsys dense/sparse)."""
        contribs = [(mesh.tets, Hel), (sv[:, None], Hsv)] + [fam[:2] for fam in barrier_fams]
        contribs += fric_blocks
        if alw is not None:
            contribs.append(al_family(alw))
        # one host read, counted around the solve: the system's copy
        # (sparse) or the cell table (dense)
        with reading("direct_solve"):
            if linsys == "sparse":
                from ipc_tpu_torch.solver.sparse_direct import sparse_solve

                return sparse_solve(mesh.mass, dbc_t, rhs, contribs)
            from ipc_tpu_torch.solver.direct import assemble_dense, dense_solve

            return dense_solve(assemble_dense(n_verts, mesh.mass, contribs, dbc_t), rhs)

    def newton_system(x, kappa, dHat, act, fric, damp, hsD, alw, dbc_t):
        """The projected Newton matrix at x over the active set `act`:
        (operator v -> A v, block-Jacobi inverse (V,3,3), the elasticity
        blocks, the half-space blocks, the barrier pair families, the
        friction block families, (active PT, active EE))."""
        # the JAX host path's Newton matrix has no damping blocks
        Hel = tet_blocks(x, None if host else damp)
        Hsv = hs_blocks(x, kappa, dHat, hsD)
        fric_blocks = stepper._friction_hessians(x, fric)
        # the JAX operator's order: mass, AL pull, tets, half-space barrier,
        # barrier pairs, friction (half-spaces, then self-contact pairs)
        barrier_fams, active_count = barrier_families(x, act, kappa, dHat)
        fric_vert, fric_pair = friction_families(fric_blocks, fric)
        al_w = (alw["w"] * alw["m"])[:, None] if alw is not None else None

        def operator(v):
            count("operator.applications")
            v = masked(dbc_t[:, None], v)
            if owner:
                out = mesh.mass[:, None] * v
                if al_w is not None:
                    out = out.index_add(0, alw["verts"], al_w * v[alw["verts"]])
                out = out + tet_hv(Hel, v, hv_table)
                out = out.index_add(0, sv, torch.einsum("vij,vj->vi", Hsv, v[sv]))
            else:
                out = tet_hv(Hel, v, hv_table)
            for fam in barrier_fams:
                out = out + pair_hv(fam, v)
            # ids are unique within a vertex family: deterministic index_add
            for ids, Hf in fric_vert:
                out = out.index_add(0, ids, torch.einsum("vij,vj->vi", Hf, v[ids]))
            for fam in fric_pair:
                out = out + pair_hv(fam, v)
            # projected rows: v is 0 there too
            return masked(dbc_t[:, None], spmd.all_sum(out))

        if owner:
            diag = mesh.mass[:, None, None] * eye3[None]
            if al_w is not None:
                diag = diag.index_add(0, alw["verts"], al_w[:, :, None] * eye3[None])
            diag = diag + gsum_tet(diag_blocks12(Hel).reshape(-1, 3, 3))
            diag = diag.index_add(0, sv, Hsv)
        else:
            diag = gsum_tet(diag_blocks12(Hel).reshape(-1, 3, 3))
        for fam in barrier_fams:
            diag = diag + pair_diag(fam)
        for ids, Hf in fric_vert:
            diag = diag.index_add(0, ids, Hf)
        for fam in fric_pair:
            diag = diag + pair_diag(fam)
        diag = torch.where(dbc_t[:, None, None], eye3[None], spmd.all_sum(diag))
        inv_diag = block_jacobi_inverse(diag)
        return operator, inv_diag, Hel, Hsv, barrier_fams, fric_blocks, active_count

    def search_dir(x, x_tilde, kappa, dHat, cand, fric, dx0, Ainv_c, damp, fext, hsD, alw,
                   dbc_t):
        """(dx, g, PCG iterations, (active PT, active EE)) at x from the
        candidates `cand`; PCG starts from dx0 (None: zeros)."""
        with span("search_dir"):
            return _search_dir(x, x_tilde, kappa, dHat, cand, fric, dx0, Ainv_c, damp, fext,
                               hsD, alw, dbc_t)

    def _search_dir(x, x_tilde, kappa, dHat, cand, fric, dx0, Ainv_c, damp, fext, hsD, alw,
                    dbc_t):
        # ONE candidate->active compaction per Newton iteration feeds the
        # barrier gradient AND the 12x12 block construction
        act = sc.active_set(x, cand, dHat) if sc is not None else None
        g = gradient(x, x_tilde, kappa, dHat, fric, damp, fext, act, hsD, alw, dbc_t)
        (operator, inv_diag, Hel, Hsv, barrier_fams, fric_blocks,
         active_count) = newton_system(x, kappa, dHat, act, fric, damp, hsD, alw, dbc_t)

        if linsys != "pcg":
            dx = direct_solve(-g, Hel, Hsv, barrier_fams, fric_blocks, alw, dbc_t)
            iters, rel = 1, torch.zeros((), dtype=dtype, device=device)
        else:
            if not lag_coarse and coarse_assemble is not None:
                contribs = [(sv[:, None], Hsv)] + [fam[:2] for fam in barrier_fams]
                contribs += fric_blocks
                if host and alw is not None:
                    contribs.append(al_family(alw))
                with span("coarse_assemble"):
                    Ainv_c = coarse_assemble(mesh.mass, contribs, tet_H=Hel)
            if Ainv_c is not None:
                def precond(r):
                    return apply_block_precond(inv_diag, r) + coarse_term(Ainv_c, r)
            else:
                def precond(r):
                    return apply_block_precond(inv_diag, r)

            with span("pcg"):
                dx, iters, rel = pcg(operator, -g, precond, x0=dx0, tol=p.pcg_tol,
                                     maxiter=p.pcg_maxiter)
        # GD fail-safe on PCG breakdown (decided on the device)
        bad = (~torch.isfinite(dx).all()) | (~torch.isfinite(rel)) | (rel > 1.0)
        dx = torch.where(bad, apply_block_precond(inv_diag, -g), dx)
        return dx, g, iters, active_count

    def jacobi_dir(x, x_tilde, kappa, dHat, cand, hsD=None):
        """Block-Jacobi-preconditioned descent direction of the objective
        without friction and forces (the host path's warm start 5)."""
        act = sc.active_set(x, cand, dHat) if sc is not None else None
        g = gradient(x, x_tilde, kappa, dHat, None, None, None, act, hsD, None, dbc)
        Hel = tet_blocks(x, None)
        diag = mesh.mass[:, None, None] * eye3[None]
        diag = diag + gsum_tet(diag_blocks12(Hel).reshape(-1, 3, 3))
        diag = diag.index_add(0, sv, hs_blocks(x, kappa, dHat, hsD))
        for fam in barrier_families(x, act, kappa, dHat)[0]:
            diag = diag + pair_diag(fam)
        diag = torch.where(dbc[:, None, None], eye3[None], diag)
        return -apply_block_precond(block_jacobi_inverse(diag), g)

    def feasible_alpha_local(x, dx, hsD=None, dbc_sv_t=dbc_sv):
        """Inversion cubic + analytic half-space bound (0-d tensor)."""
        alpha = torch.ones((), dtype=dtype, device=device)
        alpha = torch.minimum(alpha, spmd.all_min(EL.filter_step_size(x, dx, mesh, p.model)))
        x_sv = x[sv]
        p_sv = dx[sv]
        for i, hs in enumerate(halfspaces):
            alpha = torch.minimum(alpha, hs.largest_feasible_step(
                x_sv, p_sv, dbc_sv_t, p.ccd_slackness_a, D=hsd(hsD, i)))
        return alpha

    def span_clamp(alpha, d):
        """Swept-span clamp (reference SpatialHash.hpp:613-618) of a step
        `alpha` along `d`, measured in the co-moving frame, on the device."""
        d_sv = d[sv]
        d_abs = torch.abs(d_sv - d_sv.mean(dim=0))
        span = alpha * d_abs.mean() / voxel
        alpha1 = torch.where(span > 1.0, alpha / span, alpha)
        return torch.minimum(alpha1, 16.0 * voxel / torch.clamp(d_abs.max(), min=1e-30))

    def capture_friction(x, x_prev, kappa, dHat, cand, hsD, hs_veldt, eps2):
        """Lagged friction state at x (None without friction): half-space
        multipliers, the self-contact pairs with lam > 0, the anchor x_prev
        and the smoothing eps2."""
        if not stepper._solve_fric:
            return None
        x_sv = x[sv]
        hs_lams = []
        for i, hs in enumerate(halfspaces):
            if hs.params.friction > 0.0:
                m = hs.active_mask(x_sv, dHat, D=hsd(hsD, i))
                hs_lams.append(hs.friction_lambda(x_sv, m, kappa, dHat, D=hsd(hsD, i)))
            else:
                hs_lams.append(None)
        sc_state = None
        if sc is not None and (sc.friction > 0.0 or sc.vert_mu is not None):
            sc_state = sc.capture_friction(x, cand, kappa, dHat)
        return dict(
            hs=hs_lams, sc=sc_state, anchor=x_prev,
            eps2=torch.tensor(eps2, dtype=dtype, device=device),
            # moving planes drag their contacts (squashshear only)
            hs_veldt=hs_veldt,
        )

    return types.SimpleNamespace(
        hv_table=hv_table, aggregates=aggregates, coarse_assemble=coarse_assemble,
        lag_coarse=lag_coarse, dbc=dbc, dbc_sv=dbc_sv,
        e_leq=e_leq, e_out=e_out, e_float=e_float, energy=energy, gradient=gradient,
        grad_no_contact=grad_no_contact, grad_contact_unit=grad_contact_unit,
        search_dir=search_dir, newton_system=newton_system, jacobi_dir=jacobi_dir,
        assemble_coarse=assemble_coarse, feasible_alpha_local=feasible_alpha_local,
        span_clamp=span_clamp, capture_friction=capture_friction,
        damping_blocks=damping_blocks,
    )
