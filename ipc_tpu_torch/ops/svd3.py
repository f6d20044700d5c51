"""Rotation-consistent (flip-corrected) 3x3 SVD, batched.

Port of ipc_tpu/ops/svd3.py (reference AutoFlipSVD): F = U diag(sigma) V^T
with U, V proper rotations and the sign of a reflection pushed into the
last singular value.

  * `svd3_flip`   — torch.linalg.svd + sign fix; the test oracle.
  * `svd3_jacobi` — the production path: the same fixed-sweep cyclic Jacobi
                    on F^T F as the JAX package, written over a batch axis.
                    Not torch.linalg.svd: its sign and order conventions
                    differ, and the per-tet Hessian blocks would then differ
                    from the reference's.

Every function takes (..., 3, 3) and works on the flattened batch.
"""

import torch

__all__ = ["svd3_flip", "svd3_jacobi", "eigh3_jacobi"]


def _tiny(dtype):
    return 1e-300 if dtype == torch.float64 else 1e-37


def svd3_flip(F):
    """Flip-corrected SVD of (..., 3, 3) matrices via torch.linalg.svd."""
    U, s, Vt = torch.linalg.svd(F)
    V = Vt.transpose(-1, -2)
    detU = torch.linalg.det(U)
    detV = torch.linalg.det(V)
    U = torch.cat([U[..., :2], U[..., 2:] * detU[..., None, None]], dim=-1)
    V = torch.cat([V[..., :2], V[..., 2:] * detV[..., None, None]], dim=-1)
    s = torch.cat([s[..., :2], s[..., 2:] * (detU * detV)[..., None]], dim=-1)
    return U, s, V


def _jacobi_rotation(app, aqq, apq):
    """Branch-free symmetric Jacobi rotation (c, s) for pivot (p, q)."""
    pivot_ok = torch.abs(apq) > _tiny(app.dtype)
    one = torch.ones_like(apq)
    tau = (aqq - app) / (2.0 * torch.where(pivot_ok, apq, one))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0.0, one, t)  # tau == 0 -> 45 degrees
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c = torch.where(pivot_ok, c, one)
    s = torch.where(pivot_ok, s, torch.zeros_like(s))
    return c, s


def _apply_jacobi(A, V, p, q):
    """One Jacobi rotation on symmetric A (N,3,3), pivot p<q, into V."""
    c, s = _jacobi_rotation(A[:, p, p], A[:, q, q], A[:, p, q])
    c = c[:, None]
    s = s[:, None]
    A = A.clone()
    Ap, Aq = A[:, p, :], A[:, q, :]
    rp = c * Ap - s * Aq
    rq = s * Ap + c * Aq
    A[:, p, :] = rp
    A[:, q, :] = rq
    Ap, Aq = A[:, :, p], A[:, :, q]
    cp = c * Ap - s * Aq
    cq = s * Ap + c * Aq
    A[:, :, p] = cp
    A[:, :, q] = cq
    V = V.clone()
    Vp, Vq = V[:, :, p], V[:, :, q]
    vp = c * Vp - s * Vq
    vq = s * Vp + c * Vq
    V[:, :, p] = vp
    V[:, :, q] = vq
    return A, V


def eigh3_jacobi(A, sweeps: int = 6, sort: bool = True):
    """Eigendecomposition of symmetric (..., 3, 3) via fixed-count cyclic
    Jacobi. Returns (w (..., 3), V (..., 3, 3)); w sorted descending and V a
    proper rotation unless sort=False (the elasticity SPD projection skips
    the sort: clamping is order-invariant)."""
    lead = A.shape[:-2]
    A = A.reshape(-1, 3, 3)
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape[0], 3, 3)
    for _ in range(sweeps):
        A, V = _apply_jacobi(A, V, 0, 1)
        A, V = _apply_jacobi(A, V, 0, 2)
        A, V = _apply_jacobi(A, V, 1, 2)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    if sort:
        w = w.clone()
        V = V.clone()
        # descending 3-sort as a compare-swap network on columns
        for i, j in ((0, 1), (0, 2), (1, 2)):
            do = w[:, i] < w[:, j]
            wi = torch.where(do, w[:, j], w[:, i])
            wj = torch.where(do, w[:, i], w[:, j])
            Vi = torch.where(do[:, None], V[:, :, j], V[:, :, i])
            Vj = torch.where(do[:, None], V[:, :, i], V[:, :, j])
            w[:, i], w[:, j] = wi, wj
            V[:, :, i], V[:, :, j] = Vi, Vj
        # keep V a proper rotation after the column permutation
        V[:, :, 2] = V[:, :, 2] * torch.linalg.det(V)[:, None]
    return w.reshape(lead + (3,)), V.reshape(lead + (3, 3))


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _normalize_or(v, fallback):
    n2 = _dot(v, v)
    good = n2 > _tiny(v.dtype)
    safe = torch.where(good, n2, torch.ones_like(n2))
    return torch.where(good[:, None], v / torch.sqrt(safe)[:, None], fallback)


def svd3_jacobi(F, sweeps: int = 6):
    """Flip-corrected SVD of (..., 3, 3) via Jacobi on F^T F.

    Degenerate-rank safe: U columns are re-orthonormalized with cross
    products, so U is always a proper rotation; the (possibly negative)
    sigma[2] is recovered as u2 . (F v2)."""
    lead = F.shape[:-2]
    F = F.reshape(-1, 3, 3)
    _, V = eigh3_jacobi(torch.matmul(F.transpose(1, 2), F), sweeps)
    B = torch.matmul(F, V)  # = U diag(sigma)
    axes = torch.eye(3, dtype=F.dtype, device=F.device)
    u0 = _normalize_or(B[:, :, 0], axes[0].expand(F.shape[0], 3))
    b1 = B[:, :, 1] - _dot(u0, B[:, :, 1])[:, None] * u0
    # fallback direction orthogonal to u0 (the most orthogonal axis)
    k = torch.argmin(torch.abs(u0), dim=1)
    alt = torch.linalg.cross(u0, axes[k])
    alt = alt / torch.linalg.norm(alt, dim=1, keepdim=True)
    u1 = _normalize_or(b1, alt)
    u2 = torch.linalg.cross(u0, u1)  # guarantees det(U) = +1
    U = torch.stack([u0, u1, u2], dim=2)
    s = torch.stack(
        [_dot(u0, B[:, :, 0]), _dot(u1, B[:, :, 1]), _dot(u2, B[:, :, 2])],
        dim=1,
    )
    return U.reshape(lead + (3, 3)), s.reshape(lead + (3,)), V.reshape(lead + (3, 3))
