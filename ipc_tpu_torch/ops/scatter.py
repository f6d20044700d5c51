"""Static-topology scatter-add as a precomputed gather-sum.

Port of ipc_tpu/ops/scatter.py. For a fixed index list (the mesh's tet
corners, the vertex->aggregate map of the coarse preconditioner) the table
of source rows per output row is built once on the host, and every
accumulation is one gather plus a dense sum over the table's second axis.

On CUDA this is the port's deterministic vertex accumulation: no float
atomics (`index_add_` with colliding indices sums in a run-dependent order),
so a step is bitwise repeatable. The SPMD branch of the JAX version is not
ported (multi-GPU is the last slice).
"""

import numpy as np
import torch

__all__ = ["gather_table", "make_gather_sum"]


def gather_table(ids, n_out):
    """(n_out, D) int64 numpy table: row k lists, in ascending order, the
    positions i with ids[i] == k, padded with N = len(ids) (the index of an
    appended zero row). D = max multiplicity. ids >= n_out are sinks and
    appear nowhere."""
    ids = np.asarray(ids).reshape(-1).astype(np.int64)
    N = ids.shape[0]
    keep = np.nonzero(ids < n_out)[0]
    counts = np.bincount(ids[keep], minlength=n_out)
    D = max(1, int(counts.max()) if n_out else 1)
    order = keep[np.argsort(ids[keep], kind="stable")]
    k = ids[order]
    starts = np.cumsum(counts) - counts
    slot = np.arange(len(order)) - starts[k]
    table = np.full((n_out, D), N, np.int64)
    table[k, slot] = order
    return table


def make_gather_sum(ids, n_out, device="cpu"):
    """ids: (N,) int numpy array of output rows (static). Returns
    `apply(vals)` mapping (N, ...) -> (n_out, ...) with
    apply(vals)[k] = sum over {i : ids[i] == k} of vals[i].

    `apply.table` is the (n_out, D) table on `device` (padded with N)."""
    table_np = gather_table(ids, n_out)
    table = torch.as_tensor(table_np, device=device)

    def apply(vals):
        pad = torch.zeros((1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        ext = torch.cat([vals, pad], dim=0)
        return ext[table].sum(dim=1)

    apply.table = table
    return apply
