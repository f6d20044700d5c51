"""Self-contact narrow phase: per-pair barrier energies and derivatives, and
the lagged self-friction terms.

Port of ipc_tpu/contact/selfcollision.py (reference SelfCollisionHandler).
Every candidate keeps its ORIGINAL 4-vertex stencil — PT (p, t0, t1, t2),
EE (a0, a1, b0, b1) — and each evaluation classifies its closest-point type
(dType) and reduces the stencil through a static slot table, as the JAX
package does.

Derivatives. The JAX code takes `jax.grad` / `jax.hessian` of a function
that classifies and then gathers the slots. Here the dType code is
computed OUTSIDE the differentiated function (it is piecewise constant, so
this changes no derivative), and the slots enter as a constant one-hot
(4,4) selection matrix per pair, so the function has no data-dependent
indexing; `torch.func.vmap(torch.func.grad / hessian)` then differentiates
it per pair. The centroid that `_center` subtracts under `stop_gradient`
is computed outside as well and passed in as a constant (`.detach()` in
effect). The f32 reason for centering is the JAX package's: O(1) world
coordinates against O(dHat) gaps.

Tables are device tensors (`SlotTables`), built once per handler.

Not ported (no caller on the production step): the full-candidate
`barrier_energy / barrier_gradient / barrier_hessian_blocks` and
`unified_pair_energy`; the step uses the compacted active set.
"""

import numpy as np
import torch
from torch.func import grad, hessian, vmap

from ipc_tpu_torch.ops import distance as D
from ipc_tpu_torch.ops import friction as FR
from ipc_tpu_torch.ops.barrier import barrier, barrier_grad

__all__ = [
    "PT_SLOTS",
    "EE_SLOTS",
    "PT_CTYPE",
    "EE_CTYPE",
    "SlotTables",
    "pt_reduce",
    "ee_reduce",
    "pt_pair_energy",
    "ee_pair_energy",
    "pt_pair_grad",
    "ee_pair_grad",
    "pt_pair_hess",
    "ee_pair_hess",
    "active_dist2",
    "capture_friction",
    "friction_energy",
    "friction_gradient",
    "friction_hessian_blocks",
]

# slot tables: local indices into the original stencil per dType code;
# unused entries repeat slot 0 (the reduced ctype ignores them)
PT_SLOTS = np.array(
    [[0, 1, 0, 0], [0, 2, 0, 0], [0, 3, 0, 0],  # PP (p, t0|t1|t2)
     [0, 1, 2, 0], [0, 2, 3, 0], [0, 3, 1, 0],  # PE (p, t0t1|t1t2|t2t0)
     [0, 1, 2, 3]],  # PT
    np.int64,
)
PT_CTYPE = np.array([0, 0, 0, 1, 1, 1, 2], np.int64)
EE_SLOTS = np.array(
    [[0, 2, 0, 0], [0, 3, 0, 0], [0, 2, 3, 0],  # PP a0b0, PP a0b1, PE a0-b
     [1, 2, 0, 0], [1, 3, 0, 0], [1, 2, 3, 0],  # PP a1b0, PP a1b1, PE a1-b
     [2, 0, 1, 0], [3, 0, 1, 0],  # PE b0-a, PE b1-a
     [0, 1, 2, 3]],  # EE
    np.int64,
)
EE_CTYPE = np.array([0, 0, 1, 0, 0, 1, 1, 1, 3], np.int64)


class SlotTables:
    """The slot tables on one device, with their one-hot selection
    matrices: sel[code] @ x4 == x4[slots[code]]."""

    def __init__(self, device, dtype):
        def onehot(slots):
            return torch.as_tensor(np.eye(4)[slots], device=device).to(dtype)  # (K,4,4)

        self.pt_slots = torch.as_tensor(PT_SLOTS, device=device)
        self.ee_slots = torch.as_tensor(EE_SLOTS, device=device)
        self.pt_ctype = torch.as_tensor(PT_CTYPE, device=device)
        self.ee_ctype = torch.as_tensor(EE_CTYPE, device=device)
        self.pt_sel = onehot(PT_SLOTS)
        self.ee_sel = onehot(EE_SLOTS)


def _rows(x4):
    return x4[..., 0, :], x4[..., 1, :], x4[..., 2, :], x4[..., 3, :]


def _centroid(x4):
    return x4.mean(dim=-2, keepdim=True).detach()


def pt_reduce(x4, tab):
    """Classify PT stencils (N,4,3): (centroid (N,1,3), ctype (N,),
    selection (N,4,4))."""
    c = _centroid(x4)
    dt = D.dtype_PT(*_rows(x4 - c))
    return c, tab.pt_ctype[dt], tab.pt_sel[dt]


def ee_reduce(x4, tab):
    c = _centroid(x4)
    dt = D.dtype_EE(*_rows(x4 - c))
    return c, tab.ee_ctype[dt], tab.ee_sel[dt]


# ---------------------------------------------------------------------------
# per-pair barrier energies: batched over leading axes, or one pair
# ---------------------------------------------------------------------------


def _pt_energy(x4, c, S, ct, dHat):
    return barrier(D.stencil_dist2(ct, S @ (x4 - c)), dHat)


def _ee_energy(x4, c, S, ct, eps_x, dHat):
    """Mollified EE barrier e(x) b(d); the mollifier reads the uncentered
    stencil, as the JAX package's does."""
    b = barrier(D.stencil_dist2(ct, S @ (x4 - c)), dHat)
    return D.mollifier_ee(x4, eps_x) * b


def pt_pair_energy(x4, dHat, tab):
    c, ct, S = pt_reduce(x4, tab)
    return _pt_energy(x4, c, S, ct, dHat)


def ee_pair_energy(x4, eps_x, dHat, tab):
    c, ct, S = ee_reduce(x4, tab)
    return _ee_energy(x4, c, S, ct, eps_x, dHat)


def _flat_pt(dHat):
    def f(xf, c, S, ct):
        return _pt_energy(xf.reshape(4, 3), c, S, ct, dHat)

    return f


def _flat_ee(dHat):
    def f(xf, c, S, ct, eps_x):
        return _ee_energy(xf.reshape(4, 3), c, S, ct, eps_x, dHat)

    return f


def pt_pair_grad(x4, dHat, tab):
    """(N,4,3) gradients of the PT pair energies."""
    if x4.shape[0] == 0:
        return torch.zeros_like(x4)
    c, ct, S = pt_reduce(x4, tab)
    g = vmap(grad(_flat_pt(dHat)))(x4.reshape(-1, 12), c, S, ct)
    return g.reshape(-1, 4, 3)


def ee_pair_grad(x4, eps_x, dHat, tab):
    if x4.shape[0] == 0:
        return torch.zeros_like(x4)
    c, ct, S = ee_reduce(x4, tab)
    g = vmap(grad(_flat_ee(dHat)))(x4.reshape(-1, 12), c, S, ct, eps_x)
    return g.reshape(-1, 4, 3)


def pt_pair_hess(x4, dHat, tab):
    """(N,12,12) Hessians of the PT pair energies (flattened stencil)."""
    if x4.shape[0] == 0:
        return x4.new_zeros((0, 12, 12))
    c, ct, S = pt_reduce(x4, tab)
    return vmap(hessian(_flat_pt(dHat)))(x4.reshape(-1, 12), c, S, ct)


def ee_pair_hess(x4, eps_x, dHat, tab):
    if x4.shape[0] == 0:
        return x4.new_zeros((0, 12, 12))
    c, ct, S = ee_reduce(x4, tab)
    return vmap(hessian(_flat_ee(dHat)))(x4.reshape(-1, 12), c, S, ct, eps_x)


def active_dist2(x, pt_vids, ee_vids, tab):
    """Squared reduced distances of PT and EE stencils ((Cpt,), (Cee,))."""
    out = []
    for vids, reduce in ((pt_vids, pt_reduce), (ee_vids, ee_reduce)):
        x4 = x[vids]
        c, ct, S = reduce(x4, tab)
        out.append(D.stencil_dist2(ct, S @ (x4 - c)))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# lagged friction (reference SelfCollisionHandler.cpp:2480-2989)
# ---------------------------------------------------------------------------


def capture_friction(x, pt_vids, ee_vids, ee_eps_x, kappa, dHat, tab, self_mu=1.0,
                     vert_mu=None):
    """Lagged friction state over ALL candidates (PT then EE), on the
    uncentered stencils as in the JAX package: vids (C,4) reduced-stencil
    global vertex ids, ctype (C,), lam (C,) >= 0 with mu folded in (zero
    for inactive and for mollified EE pairs), coords (C,2), basis (C,3,2).

    Per-pair mu: with vert_mu (V,) (kinematic objects' coefficients, 0 on
    deformable vertices), a pair whose reduced stencil touches an object
    vertex takes the largest such coefficient, otherwise self_mu. The
    stencil's unused slots repeat slot 0, as in the JAX package."""
    outs = []
    for vids, slots_t, ctype_t, classify, eps in (
        (pt_vids, tab.pt_slots, tab.pt_ctype, D.dtype_PT, None),
        (ee_vids, tab.ee_slots, tab.ee_ctype, D.dtype_EE, ee_eps_x),
    ):
        x4 = x[vids]
        dt = classify(*_rows(x4))
        ct = ctype_t[dt]
        slots = slots_t[dt]  # (n,4)
        xs = torch.take_along_dim(x4, slots[:, :, None], dim=1)
        d2 = D.stencil_dist2(ct, xs)
        lam = -kappa * 2.0 * torch.sqrt(torch.clamp(d2, min=0.0)) * barrier_grad(d2, dHat)
        if eps is not None:
            cr = D.ee_cross_sq_norm(*_rows(x4))
            lam = torch.where(cr < eps, torch.zeros_like(lam), lam)
        outs.append((torch.take_along_dim(vids, slots, dim=1), ct, lam,
                     FR.closest_point_coords(ct, xs), FR.tangent_basis(ct, xs)))
    (pv, pc, pl, pco, pb), (ev, ec, el, eco, eb) = outs
    vids = torch.cat([pv, ev])
    mu = self_mu
    if vert_mu is not None:
        co_mu = vert_mu[vids].amax(dim=1)
        mu = torch.where(co_mu > 0.0, co_mu, torch.full_like(co_mu, self_mu))
    return dict(
        vids=vids,
        ctype=torch.cat([pc, ec]),
        lam=torch.cat([pl, el]) * mu,
        coords=torch.cat([pco, eco]),
        basis=torch.cat([pb, eb]),
    )


def _fric_u(fr, x, x_anchor):
    """(C,2) tangential relative displacements and (C,4) weights."""
    dx = x[fr["vids"]] - x_anchor[fr["vids"]]
    w = FR.rel_dx_weights(fr["ctype"], fr["coords"])
    rel = torch.einsum("ci,cij->cj", w, dx)
    u = torch.einsum("cj,cjk->ck", rel, fr["basis"])
    return u, w


def _tiny(x):
    return 1e-300 if x.dtype == torch.float64 else 1e-30


def friction_energy(fr, x, x_anchor, eps2, mu):
    """mu * sum lam_k f0(|u_k|) (0-d)."""
    u, _ = _fric_u(fr, x, x_anchor)
    u2 = (u * u).sum(dim=1)
    eps = torch.sqrt(eps2)
    f0 = torch.where(u2 > eps2, torch.sqrt(torch.maximum(u2, eps2)), FR.f0_sf(u2, eps))
    return mu * (fr["lam"] * f0).sum()


def friction_gradient(fr, x, x_anchor, eps2, mu, vert_sum):
    """(V,3) friction gradient; vert_sum is the gather-sum over
    fr["vids"].reshape(-1) (ops/scatter.make_dynamic_gather_sum)."""
    u, w = _fric_u(fr, x, x_anchor)
    u2 = (u * u).sum(dim=1)
    eps = torch.sqrt(eps2)
    scale = torch.where(u2 > eps2, 1.0 / torch.sqrt(torch.clamp(u2, min=_tiny(x))),
                        FR.f1_sf_over_x(u2, eps))
    ft = (mu * fr["lam"] * scale)[:, None] * u
    f3 = torch.einsum("cjk,ck->cj", fr["basis"], ft)
    g4 = w[:, :, None] * f3[:, None, :]
    return vert_sum(g4.reshape(-1, 3))


def friction_hessian_blocks(fr, x, x_anchor, eps2, mu):
    """(C,12,12) PSD friction blocks kron(w w^T, B H_t B^T)."""
    u, w = _fric_u(fr, x, x_anchor)
    u2 = (u * u).sum(dim=1)
    eps = torch.sqrt(eps2)
    un = torch.sqrt(torch.clamp(u2, min=0.0))
    slip = u2 > eps2
    tiny = _tiny(x)
    inv_un = 1.0 / torch.clamp(un, min=tiny)
    a = torch.where(slip, inv_un, (2.0 * eps - un) / (eps * eps))
    f2 = torch.where(slip, torch.zeros_like(un), 2.0 * (eps - un) / (eps * eps))
    c = torch.where(u2 > tiny, (f2 - a) / torch.clamp(u2, min=tiny), torch.zeros_like(u2))
    coef = mu * fr["lam"]
    I2 = torch.eye(2, dtype=x.dtype, device=x.device)
    Ht = (coef * a)[:, None, None] * I2[None] + (coef * c)[:, None, None] * (
        u[:, :, None] * u[:, None, :])
    H3 = torch.einsum("cjk,ckl,cml->cjm", fr["basis"], Ht, fr["basis"])
    ww = w[:, :, None] * w[:, None, :]
    return torch.einsum("cmn,cjk->cmjnk", ww, H3).reshape(-1, 12, 12)
