"""Dense direct Newton solve: the small-scene exact-solve path.

Port of ipc_tpu/solver/direct.py (the role of the reference's CHOLMOD /
Eigen LLT solvers behind LinSysSolver): the full dense (3V,3V) Newton
matrix from the same per-family blocks the PCG operator multiplies with,
factorized by Cholesky on the tensors' device. The host path selects it
with SimParams.linsys="dense". Memory is O(9 V^2): small scenes only.

The blocks are summed into their cells with a gather-sum over the cells
that occur (ops/scatter.make_dynamic_gather_sum): no float atomics, so the
assembly is the same on every run, on the card too.
"""

import torch

from ipc_tpu_torch.ops.scatter import make_dynamic_gather_sum

__all__ = ["assemble_dense", "dense_solve"]


def assemble_dense(n_verts, mass, contribs, dbc_mask):
    """(3V,3V) Newton matrix from block families.

    contribs: list of (vids (N,k), H (N,3k,3k)); mass adds the lumped
    diagonal; DBC rows and columns become identity (the reference's
    unit-row/column projection)."""
    V = n_verts
    dtype, device = mass.dtype, mass.device
    eye3 = torch.eye(3, dtype=dtype, device=device)
    cells = [torch.arange(V, device=device) * (V + 1)]
    vals = [mass[:, None, None] * eye3[None]]
    for vids, H in contribs:
        N, k = vids.shape
        Hk = H.reshape(N, k, 3, k, 3).permute(0, 1, 3, 2, 4)  # (N,k,k,3,3)
        cells.append((vids[:, :, None] * V + vids[:, None, :]).reshape(-1))
        vals.append(Hk.reshape(-1, 3, 3))
    A = make_dynamic_gather_sum(torch.cat(cells), V * V)(torch.cat(vals))
    free = (~dbc_mask).to(dtype)
    A = A.reshape(V, V, 3, 3) * free[:, None, None, None] * free[None, :, None, None]
    Ad = A.permute(0, 2, 1, 3).reshape(3 * V, 3 * V)
    # identity on DBC rows/cols
    return Ad + torch.diag(dbc_mask.repeat_interleave(3).to(dtype))


def dense_solve(Ad, rhs):
    """Cholesky solve of the SPD system (every block family is SPD-
    projected). rhs (V,3) -> dx (V,3); NaN where the factorization fails
    (as jnp.linalg.cholesky gives), which the caller's fail-safe catches."""
    L, info = torch.linalg.cholesky_ex(Ad)
    y = torch.linalg.solve_triangular(L, rhs.reshape(-1, 1), upper=False)
    x = torch.linalg.solve_triangular(L.T, y, upper=True)
    x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    return x.reshape(rhs.shape)
