"""Stretch-invariant elasticity: Neo-Hookean and Fixed-Corotational.

Port of ipc_tpu/energy/elasticity.py:46-360, written over a batch axis of
tets instead of vmap. Same algebra:
  F = D(x) @ rest_inv,  F = U diag(sigma) V^T   (flip-corrected SVD)
  dP/dF = K M K^T with K = kron(U, V) (a batched einsum here) and M the
     9x9 matrix of the SPD-projected 3x3 sigma Hessian and 2x2 twist blocks
  grad_x = vol * W @ P^T,  hess_x = vol * einsum(W, W, dP/dF)  (12x12/tet)

The zero-volume guards (`where(vol > 0, ...)`) give the padding tets of a
sharded mesh (parallel/sharding.py: all four corners on the sentinel
vertex, rest_inv, vol, mu and lam 0) exact zeros of energy, gradient and
Hessian. A rank of a sharded step passes a mesh that holds only its own
tets (over all vertices): these functions then return its part, which the
step sums over ranks (step_terms.py), and `filter_step_size` its least
step, which the step takes the minimum of.
"""

import torch

from ipc_tpu_torch.ops.spd import make_psd2
from ipc_tpu_torch.ops.step_bound import injective_step_bound
from ipc_tpu_torch.ops.svd3 import eigh3_jacobi, svd3_jacobi

__all__ = [
    "deformation_gradient",
    "elem_weights",
    "elasticity_energy_per_elem",
    "elasticity_gradient",
    "elasticity_hessian_blocks",
    "filter_step_size",
    "MODELS",
]


def _edges(x4):
    """(T,3,3) edge matrices, columns x_i - x_0."""
    return torch.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], dim=2)


def deformation_gradient(x4, rest_inv):
    """F (T,3,3) from corner positions x4 (T,4,3)."""
    return torch.matmul(_edges(x4), rest_inv)


def elem_weights(rest_inv):
    """Chain-rule weights W (T,4,3): grad_x = vol * W @ P^T."""
    return torch.cat([-rest_inv.sum(dim=1, keepdim=True), rest_inv], dim=1)


# ---------------------------------------------------------------------------
# sigma-space model functions on (T,3) spectra: E, dE/dsigma, d2E/dsigma2,
# BLeftCoef (mu, lam are (T,))
# ---------------------------------------------------------------------------


def _sym3(d0, d1, d2, o01, o12, o20):
    return torch.stack(
        [
            torch.stack([d0, o01, o20], dim=-1),
            torch.stack([o01, d1, o12], dim=-1),
            torch.stack([o20, o12, d2], dim=-1),
        ],
        dim=-2,
    )


def _nh_E(s, mu, lam):
    J = s[:, 0] * s[:, 1] * s[:, 2]
    logJ = torch.log(J)
    return 0.5 * mu * ((s * s).sum(-1) - 3.0) - (mu - 0.5 * lam * logJ) * logJ


def _nh_dE(s, mu, lam):
    logJ = torch.log(s[:, 0] * s[:, 1] * s[:, 2])
    return mu[:, None] * (s - 1.0 / s) + lam[:, None] * logJ[:, None] / s


def _nh_d2E(s, mu, lam):
    logJ = torch.log(s[:, 0] * s[:, 1] * s[:, 2])
    inv2 = 1.0 / (s * s)
    diag = mu[:, None] * (1.0 + inv2) - lam[:, None] * inv2 * (logJ[:, None] - 1.0)
    return _sym3(
        diag[:, 0], diag[:, 1], diag[:, 2],
        lam / (s[:, 0] * s[:, 1]), lam / (s[:, 1] * s[:, 2]), lam / (s[:, 2] * s[:, 0]),
    )


def _nh_bleft(s, mu, lam):
    mid = mu - lam * torch.log(s[:, 0] * s[:, 1] * s[:, 2])
    return 0.5 * torch.stack(
        [
            mu + mid / (s[:, 0] * s[:, 1]),
            mu + mid / (s[:, 1] * s[:, 2]),
            mu + mid / (s[:, 2] * s[:, 0]),
        ],
        dim=-1,
    )


def _fcr_E(s, mu, lam):
    Jm1 = s[:, 0] * s[:, 1] * s[:, 2] - 1.0
    sm1 = s - 1.0
    return mu * (sm1 * sm1).sum(-1) + 0.5 * lam * Jm1 * Jm1


def _prod_no(s):
    return torch.stack([s[:, 1] * s[:, 2], s[:, 2] * s[:, 0], s[:, 0] * s[:, 1]], dim=-1)


def _fcr_dE(s, mu, lam):
    Jm1lam = lam * (s[:, 0] * s[:, 1] * s[:, 2] - 1.0)
    return 2.0 * mu[:, None] * (s - 1.0) + _prod_no(s) * Jm1lam[:, None]


def _fcr_d2E(s, mu, lam):
    J = s[:, 0] * s[:, 1] * s[:, 2]
    pn = _prod_no(s)
    diag = 2.0 * mu[:, None] + lam[:, None] * pn * pn
    off = lambda i, j, k: lam * (s[:, k] * (J - 1.0) + pn[:, i] * pn[:, j])
    return _sym3(diag[:, 0], diag[:, 1], diag[:, 2],
                 off(0, 1, 2), off(1, 2, 0), off(0, 2, 1))


def _fcr_bleft(s, mu, lam):
    Jm1 = s[:, 0] * s[:, 1] * s[:, 2] - 1.0
    return torch.stack(
        [
            mu - 0.5 * lam * s[:, 2] * Jm1,
            mu - 0.5 * lam * s[:, 0] * Jm1,
            mu - 0.5 * lam * s[:, 1] * Jm1,
        ],
        dim=-1,
    )


def _cof(F):
    """Cofactor matrices (J * F^-T) via cross products of columns."""
    c0 = torch.linalg.cross(F[:, :, 1], F[:, :, 2])
    c1 = torch.linalg.cross(F[:, :, 2], F[:, :, 0])
    c2 = torch.linalg.cross(F[:, :, 0], F[:, :, 1])
    return torch.stack([c0, c1, c2], dim=2)


def _nh_E_F(F, mu, lam):
    """NH energy from the invariants |F|^2 and J = det F — no SVD."""
    J = torch.linalg.det(F)
    logJ = torch.log(torch.clamp(J, min=1e-30))
    return 0.5 * mu * ((F * F).sum(dim=(1, 2)) - 3.0) - (mu - 0.5 * lam * logJ) * logJ


def _nh_P_F(F, mu, lam):
    """NH PK1 stress P = mu F + (lam logJ - mu) F^-T, F^-T = cof(F)/J."""
    cof = _cof(F)
    J = (F[:, :, 0] * cof[:, :, 0]).sum(-1)
    logJ = torch.log(torch.clamp(J, min=1e-30))
    FinvT = cof / torch.where(J != 0.0, J, torch.ones_like(J))[:, None, None]
    return mu[:, None, None] * F + (lam * logJ - mu)[:, None, None] * FinvT


MODELS = {
    "NH": dict(E=_nh_E, dE=_nh_dE, d2E=_nh_d2E, bleft=_nh_bleft, inv_guard=True,
               E_F=_nh_E_F, P_F=_nh_P_F),
    "FCR": dict(E=_fcr_E, dE=_fcr_dE, d2E=_fcr_d2E, bleft=_fcr_bleft, inv_guard=False),
}


# ---------------------------------------------------------------------------
# per-element energy / gradient / Hessian over all tets
# ---------------------------------------------------------------------------


def _eye_like(F):
    return torch.eye(3, dtype=F.dtype, device=F.device).expand_as(F)


def _elem_svd(x4, rest_inv, vol):
    """Flip-SVD of the deformation gradients; zero-volume tets get sigma=1
    so NH's logs stay finite (their vol weight zeroes them anyway)."""
    F = deformation_gradient(x4, rest_inv)
    U, s, V = svd3_jacobi(F)
    s = torch.where(vol[:, None] > 0, s, torch.ones_like(s))
    return U, s, V


def _spd3(A):
    """3x3 SPD projection via the unsorted Jacobi eigensolver (as the JAX
    package: a sorted or library eigensolver changes the blocks at rounding
    level)."""
    w, Q = eigh3_jacobi(0.5 * (A + A.transpose(1, 2)), sort=False)
    w = torch.clamp(w, min=0.0)
    return torch.matmul(Q * w[:, None, :], Q.transpose(1, 2))


def _dPdF(U, s, V, mu, lam, model, project):
    """(T,9,9) dP/dF in the (i*3+j) row-major vec convention."""
    m = MODELS[model]
    dE = m["dE"](s, mu, lam)
    A = m["d2E"](s, mu, lam)
    if project:
        A = _spd3(A)
    bl = m["bleft"](s, mu, lam)

    Bs = []
    for cI, (i, j) in enumerate([(0, 1), (1, 2), (2, 0)]):
        denom = torch.clamp(s[:, i] + s[:, j], min=1e-6)
        r = (dE[:, i] + dE[:, j]) / (2.0 * denom)
        l = bl[:, cI]
        B = torch.stack(
            [torch.stack([l + r, l - r], dim=-1), torch.stack([l - r, l + r], dim=-1)],
            dim=-2,
        )
        if project:
            B = make_psd2(B)
        Bs.append(B)

    # A at diagonal slots (0,4,8); B01 at vec indices (1,3), B12 at (5,7),
    # B20 at (2,6) with the reference's reversed layout for the (2,0) pair
    B0, B1, B2 = Bs
    M = torch.zeros(s.shape[0], 9, 9, dtype=s.dtype, device=s.device)
    d = (0, 4, 8)
    for a in range(3):
        for b in range(3):
            M[:, d[a], d[b]] = A[:, a, b]
    for (p, q), B in (((1, 3), B0), ((5, 7), B1), ((6, 2), B2)):
        M[:, p, p] = B[:, 0, 0]
        M[:, p, q] = B[:, 0, 1]
        M[:, q, p] = B[:, 1, 0]
        M[:, q, q] = B[:, 1, 1]

    K = torch.einsum("tik,tjl->tijkl", U, V).reshape(-1, 9, 9)  # kron(U, V)
    return torch.matmul(torch.matmul(K, M), K.transpose(1, 2))


def _gather(x, tets):
    return x[tets]  # (T,4,3)


def elasticity_energy_per_elem(x, mesh, model="NH"):
    """(T,) per-tet elasticity energy (no h^2 scaling)."""
    m = MODELS[model]
    x4 = _gather(x, mesh.tets)
    if "E_F" in m:  # invariant closed form: no SVD (NH)
        F = deformation_gradient(x4, mesh.rest_inv)
        F = torch.where(mesh.vol[:, None, None] > 0, F, _eye_like(F))
        return mesh.vol * m["E_F"](F, mesh.mu, mesh.lam)
    _, s, _ = _elem_svd(x4, mesh.rest_inv, mesh.vol)
    return mesh.vol * m["E"](s, mesh.mu, mesh.lam)


def elasticity_gradient(x, mesh, model, vert_sum):
    """(V,3) gradient of the total elasticity energy. `vert_sum` is the
    precomputed gather-sum over tets.reshape(-1) (ops/scatter.py): the
    deterministic accumulation (the JAX package's scatter-add fallback is
    not ported — index_add_ with colliding indices is not deterministic on
    CUDA)."""
    m = MODELS[model]
    x4 = _gather(x, mesh.tets)
    W = elem_weights(mesh.rest_inv)
    if "P_F" in m:  # invariant closed form: no SVD (NH)
        F = deformation_gradient(x4, mesh.rest_inv)
        F = torch.where(mesh.vol[:, None, None] > 0, F, _eye_like(F))
        P = m["P_F"](F, mesh.mu, mesh.lam)
    else:
        U, s, V = _elem_svd(x4, mesh.rest_inv, mesh.vol)
        dE = m["dE"](s, mesh.mu, mesh.lam)
        P = torch.matmul(U * dE[:, None, :], V.transpose(1, 2))
    g = mesh.vol[:, None, None] * torch.matmul(W, P.transpose(1, 2))  # (T,4,3)
    return vert_sum(g.reshape(-1, 3))


def elasticity_hessian_blocks(x, mesh, model="NH", project=True):
    """(T,12,12) SPD-projected per-tet Hessian blocks (no h^2 scaling);
    row/column index 3*corner + component."""
    x4 = _gather(x, mesh.tets)
    U, s, V = _elem_svd(x4, mesh.rest_inv, mesh.vol)
    dPdF = _dPdF(U, s, V, mesh.mu, mesh.lam, model, project)
    W = elem_weights(mesh.rest_inv)
    T4 = dPdF.reshape(-1, 3, 3, 3, 3)  # [t, i, j, r, s]
    H = torch.einsum("tmj,tns,tijrs->tminr", W, W, T4)
    return mesh.vol[:, None, None] * H.reshape(-1, 12, 12)


def filter_step_size(x, p, mesh, model="NH", slackness=0.2):
    """Largest inversion-safe step along p (0-d tensor; inf for models
    without an inversion guard)."""
    if not MODELS[model]["inv_guard"]:
        return torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    A = _edges(_gather(x, mesh.tets))
    Bm = _edges(_gather(p, mesh.tets))
    return injective_step_bound(A, Bm, slackness).min()
