"""SPD projection by eigenvalue clamping ("makePD").

Port of ipc_tpu/ops/spd.py (reference IglUtils::makePD / makePD2d), batched
over leading axes: (..., N, N) and (..., 2, 2).
"""

import torch

__all__ = ["make_psd", "make_psd2"]


def make_psd(A):
    """Clamp negative eigenvalues of symmetric (..., N, N) matrices."""
    A = 0.5 * (A + A.transpose(-1, -2))
    w, Q = torch.linalg.eigh(A)
    w = torch.clamp(w, min=0.0)
    return torch.matmul(Q * w[..., None, :], Q.transpose(-1, -2))


def make_psd2(A):
    """Closed-form SPD projection of symmetric (..., 2, 2) matrices."""
    a, b, d = A[..., 0, 0], A[..., 0, 1], A[..., 1, 1]
    tr = a + d
    diff = a - d
    rad = torch.sqrt(diff * diff + 4.0 * b * b)
    l0 = 0.5 * (tr - rad)  # smaller eigenvalue
    l1 = 0.5 * (tr + rad)
    l0c = torch.clamp(l0, min=0.0)
    l1c = torch.clamp(l1, min=0.0)
    # eigenvector for l1: (b, l1 - a) unless b == 0
    eps = 1e-300 if A.dtype == torch.float64 else 1e-37
    off = torch.abs(b) > eps
    one = torch.ones_like(a)
    zero = torch.zeros_like(a)
    big_a = a >= d
    v1x = torch.where(off, b, torch.where(big_a, one, zero))
    v1y = torch.where(off, l1 - a, torch.where(big_a, zero, one))
    n2 = v1x * v1x + v1y * v1y
    nrm = torch.sqrt(torch.where(n2 > 0, n2, one))
    v1x = v1x / nrm
    v1y = v1y / nrm
    # columns v0 = (-v1y, v1x), v1
    V = torch.stack(
        [torch.stack([-v1y, v1x], dim=-1), torch.stack([v1x, v1y], dim=-1)],
        dim=-2,
    )
    lam = torch.stack([l0c, l1c], dim=-1)
    return torch.matmul(V * lam[..., None, :], V.transpose(-1, -2))
