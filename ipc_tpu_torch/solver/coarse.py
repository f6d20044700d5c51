"""Two-level aggregation preconditioner for the matrix-free Newton solve.

Port of ipc_tpu/solver/coarse.py:51-185:

  M^-1 = J^-1 + P A_c^-1 P^T            (additive two-level Schwarz)

with P the piecewise-constant prolongator over Morton-ordered vertex
aggregates (host numpy, `build_aggregates`) and A_c = P^T A P assembled from
the same SPD blocks the operator multiplies with, then inverted densely
(`torch.linalg.inv`, the counterpart of the `jnp.linalg.inv` the JAX package
leaves to XLA).

Determinism on CUDA: every accumulation with colliding indices goes through
a static gather-sum table (ops/scatter.py) or the tet family's sort +
cumsum segment sum, never `index_add_` (float atomics). That covers the
vertex->aggregate restriction (mass diagonal, `precond_term`) and the
per-vertex block families of slice 1 (half-space barrier and friction).

Not ported yet: pair families (k > 1: self-contact, slice 2) and the
`scalar_contribs` trace path, which no caller of slice 1 reaches.
"""

import numpy as np
import torch

from ipc_tpu_torch.ops.scatter import make_gather_sum

__all__ = ["build_aggregates", "make_coarse_assembler"]


def _morton3(q):
    """Interleave 10 bits per axis -> 30-bit z-order code. q: (V,3) uint32."""
    def spread(x):
        x = x.astype(np.uint64) & 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def build_aggregates(x_rest, size=32, max_coarse=1024):
    """(V,) int32 aggregate ids + aggregate count C (host numpy): Morton-
    sort rest positions and chunk `size` consecutive vertices each."""
    X = np.asarray(x_rest, np.float64)
    V = X.shape[0]
    size = max(size, int(np.ceil(V / max_coarse)))
    ext = np.maximum(X.max(axis=0) - X.min(axis=0), 1e-30).max()
    q = np.floor((X - X.min(axis=0)) / ext * 1023.0).astype(np.uint32)
    order = np.argsort(_morton3(q), kind="stable")
    agg = np.empty(V, np.int32)
    agg[order] = (np.arange(V) // size).astype(np.int32)
    C = int(agg.max()) + 1
    return agg, C


def _corner_pair_blocks(H, k, free_rows):
    """(N,3k,3k) -> (N*k*k, 3, 3) corner-pair blocks, DBC rows/cols zeroed
    (free_rows: (N,k))."""
    N = H.shape[0]
    Hk = H.reshape(N, k, 3, k, 3).permute(0, 1, 3, 2, 4)  # (N,k,k,3,3)
    Hk = Hk * free_rows[:, :, None, None, None] * free_rows[:, None, :, None, None]
    return Hk.reshape(N * k * k, 3, 3)


def make_coarse_assembler(agg, C, dbc_mask, dtype, tets=None):
    """Returns (assemble, precond_term).

    assemble(mass, contributions, tet_H=None) -> (3C,3C) inverse of the
    Galerkin coarse matrix. `contributions` is a list of (vids (N,1),
    H (N,3,3)) per-vertex block families; `tet_H` the (T,12,12) family of
    the `tets` given here (sort + cumsum segment sum, as in the JAX
    package). precond_term(Ainv, r) -> P A_c^-1 P^T r."""
    agg_np = np.asarray(agg).astype(np.int64)
    dbc_np = np.asarray(dbc_mask.cpu() if torch.is_tensor(dbc_mask) else dbc_mask)
    device = dbc_mask.device if torch.is_tensor(dbc_mask) else torch.device("cpu")
    agg_t = torch.as_tensor(agg_np, device=device)
    free = torch.as_tensor(~dbc_np, device=device).to(dtype)
    gsum_agg = make_gather_sum(agg_np, C, device)  # vertex -> aggregate
    diag_cells = torch.arange(C, device=device) * (C + 1)
    eye3 = torch.eye(3, dtype=dtype, device=device)

    if tets is not None:
        tets_np = np.asarray(tets)
        ca = agg_np[tets_np]  # (T,4)
        ids = (ca[:, :, None] * C + ca[:, None, :]).reshape(-1)  # (T*16,)
        perm = np.argsort(ids, kind="stable")
        counts = np.bincount(ids, minlength=C * C)
        ends = np.cumsum(counts)
        starts = ends - counts
        tet_free = torch.as_tensor((~dbc_np[tets_np]).astype(np.float64), device=device).to(dtype)
        perm_t = torch.as_tensor(perm, device=device)
        ends_t = torch.as_tensor(ends, device=device)
        starts_t = torch.as_tensor(starts, device=device)

        def tet_coarse(tet_H):
            rows = _corner_pair_blocks(tet_H, 4, tet_free).reshape(-1, 9)
            # scan along the contiguous last axis: a cumsum over dim 0 of
            # (16T, 9) runs 9 sequential scans on CUDA (0.4 s at 96K tets)
            rows = rows[perm_t].T.contiguous()  # (9, 16T)
            csum = torch.cat(
                [torch.zeros((9, 1), dtype=dtype, device=device), torch.cumsum(rows, dim=1)],
                dim=1,
            )
            return (csum[:, ends_t] - csum[:, starts_t]).T.reshape(C, C, 3, 3)
    else:
        tet_coarse = None

    def vertex_family(vids, H):
        """Per-vertex blocks (k=1) summed per aggregate: the rows land on
        the coarse diagonal cells (agg_v, agg_v)."""
        if vids.shape[1] != 1:
            raise NotImplementedError(
                "pair block families (self-contact) arrive with slice 2")
        v = vids[:, 0]
        rows = _corner_pair_blocks(H, 1, free[vids])  # (N,3,3)
        # family vids are unique vertices, so this index_add_ has one
        # addend per row (deterministic); aggregates sum through the table
        per_vert = torch.zeros((free.shape[0], 3, 3), dtype=dtype, device=device)
        per_vert.index_add_(0, v, rows)
        return gsum_agg(per_vert)  # (C,3,3)

    def assemble(mass, contributions, tet_H=None):
        A = torch.zeros((C * C, 3, 3), dtype=dtype, device=device)
        # lumped mass on the diagonal (free vertices only)
        m_c = gsum_agg(mass * free)
        A[diag_cells] = A[diag_cells] + m_c[:, None, None] * eye3[None]
        for vids, H in contributions:
            A[diag_cells] = A[diag_cells] + vertex_family(vids, H)
        A = A.reshape(C, C, 3, 3)
        if tet_coarse is not None and tet_H is not None:
            A = A + tet_coarse(tet_H)
        Ad = A.permute(0, 2, 1, 3).reshape(3 * C, 3 * C)
        # symmetrize + tiny trace-scaled regularization (keeps empty/all-DBC
        # aggregates invertible)
        Ad = 0.5 * (Ad + Ad.T)
        tr = torch.trace(Ad) / (3 * C)
        Ad = Ad + (1e-8 * tr + 1e-30) * torch.eye(3 * C, dtype=dtype, device=device)
        return torch.linalg.inv(Ad)

    def precond_term(Ainv, r):
        rc = gsum_agg(r * free[:, None])
        zc = torch.matmul(Ainv, rc.reshape(-1)).reshape(C, 3)
        return zc[agg_t] * free[:, None]

    return assemble, precond_term
