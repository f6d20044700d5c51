"""Matrix-free preconditioned conjugate gradient.

Port of ipc_tpu/solver/pcg.py:30-94. The `lax.while_loop` becomes a Python
loop: each iteration reads the squared residual back to the host once to
test termination (the one host sync per PCG iteration; a later PR can move
termination onto the device or capture the loop in a CUDA graph).
"""

import torch

__all__ = ["pcg", "block_jacobi_inverse", "apply_block_precond"]


def _dot(a, b):
    return (a * b).sum()


def pcg(operator, b, precond, x0=None, tol=1e-5, maxiter=1000):
    """Solve A x = b with preconditioned CG.

    operator: v -> A v; precond: r -> M^-1 r.
    Returns (x, iters (int), rel_residual (0-d tensor))."""
    if x0 is None:
        x0 = torch.zeros_like(b)
    b_norm2 = _dot(b, b)
    atol2 = tol * tol * torch.clamp(b_norm2, min=1e-300)

    x = x0
    r = b - operator(x0)
    p = precond(r)
    rz = _dot(r, p)
    k = 0
    while k < maxiter and bool(_dot(r, r) > atol2):
        Ap = operator(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp != 0.0, pAp, torch.ones_like(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz != 0.0, rz, torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
        k += 1
    rel = torch.sqrt(_dot(r, r) / torch.clamp(b_norm2, min=1e-300))
    return x, k, rel


def block_jacobi_inverse(diag_blocks, reg=0.0):
    """Invert (V,3,3) per-vertex diagonal blocks (closed-form adjugate
    inverse; identity on singular blocks)."""
    A = diag_blocks
    if reg:
        A = A + reg * torch.eye(3, dtype=A.dtype, device=A.device)[None]
    c0 = torch.linalg.cross(A[:, :, 1], A[:, :, 2], dim=1)
    c1 = torch.linalg.cross(A[:, :, 2], A[:, :, 0], dim=1)
    c2 = torch.linalg.cross(A[:, :, 0], A[:, :, 1], dim=1)
    det = (A[:, :, 0] * c0).sum(dim=1)
    adjT = torch.stack([c0, c1, c2], dim=1)  # rows of the adjugate
    ok = torch.abs(det) > 1e-300
    inv = adjT / torch.where(ok, det, torch.ones_like(det))[:, None, None]
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand_as(A)
    return torch.where(ok[:, None, None], inv, eye)


def apply_block_precond(inv_blocks, r):
    """Apply (V,3,3) inverse blocks to a (V,3) residual."""
    return torch.einsum("vij,vj->vi", inv_blocks, r)
