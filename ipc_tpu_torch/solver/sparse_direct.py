"""Sparse direct Newton solve on the host (SciPy SuperLU).

Port of ipc_tpu/solver/sparse_direct.py, the exact-solve escape hatch at
scales where the dense path's O(9 V^2) memory is absurd (the role of the
reference's CHOLMOD): a CSC matrix assembled from the same per-family
block lists the PCG operator multiplies with, factorized with
scipy.sparse.linalg.splu in float64. `sparse_solve` copies the mass, mask,
right-hand side and block families to the host and the solution back to
the right-hand side's device and dtype, as the JAX package's
`pure_callback` does. The host path selects it with
SimParams.linsys="sparse".
"""

import numpy as np
import torch

__all__ = ["sparse_solve_host", "sparse_solve"]


def _coo_from_families(n_verts, mass, families, dbc_mask):
    """COO triplets of the (3V,3V) Newton matrix.

    families: list of (vids (N,k) int, H (N,3k,3k)) numpy arrays; DBC rows
    and columns are projected to identity: any triplet touching a DBC
    vertex is dropped and 1.0 is added on the DBC diagonal entries."""
    rows, cols, vals = [], [], []
    free = ~dbc_mask

    # lumped mass diagonal on free vertices
    vidx = np.arange(n_verts)
    for c in range(3):
        d = 3 * vidx + c
        rows.append(d[free])
        cols.append(d[free])
        vals.append(mass[free])

    for vids, H in families:
        N, k = vids.shape
        if N == 0:
            continue
        Hb = H.reshape(N, k, 3, k, 3)
        # (N,k,k) pair grid of 3x3 blocks
        ri = 3 * vids[:, :, None, None, None] + np.arange(3)[None, None, None, :, None]
        ci = 3 * vids[:, None, :, None, None] + np.arange(3)[None, None, None, None, :]
        ri = np.broadcast_to(ri, (N, k, k, 3, 3))
        ci = np.broadcast_to(ci, (N, k, k, 3, 3))
        vv = Hb.transpose(0, 1, 3, 2, 4)  # (N,k,k,3,3)
        keep = free[vids]  # (N,k)
        km = keep[:, :, None, None, None] & keep[:, None, :, None, None]
        km = np.broadcast_to(km, ri.shape)
        rows.append(ri[km])
        cols.append(ci[km])
        vals.append(vv[km])

    # identity on the DBC diagonal
    if dbc_mask.any():
        d = (3 * vidx[dbc_mask][:, None] + np.arange(3)[None, :]).reshape(-1)
        rows.append(d)
        cols.append(d)
        vals.append(np.ones(d.shape[0], mass.dtype))

    return (
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate([np.asarray(v, np.float64).reshape(-1) for v in vals]),
    )


def sparse_solve_host(n_verts, mass, families, dbc_mask, rhs):
    """Exact solve A dx = rhs on numpy arrays (float64 factorization)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    r, c, v = _coo_from_families(
        n_verts, np.asarray(mass, np.float64), families, np.asarray(dbc_mask, bool)
    )
    A = sp.coo_matrix((v, (r, c)), shape=(3 * n_verts, 3 * n_verts)).tocsc()
    dx = spla.splu(A).solve(np.asarray(rhs, np.float64).reshape(-1))
    return dx.reshape(n_verts, 3)


def sparse_solve(mass, dbc_mask, rhs, families):
    """sparse_solve_host on tensors: (V,) mass, (V,) bool mask, (V,3) rhs and
    (vids, H) block families -> (V,3) dx on rhs's device, in rhs's dtype."""
    def host(t):
        return t.detach().cpu().numpy()

    fams = [(host(vids), host(H).astype(np.float64)) for vids, H in families]
    dx = sparse_solve_host(int(rhs.shape[0]), host(mass), fams, host(dbc_mask), host(rhs))
    return torch.as_tensor(dx, device=rhs.device).to(rhs.dtype)
