"""Scatter-add as a gather-sum over a table of source rows.

Port of ipc_tpu/ops/scatter.py. For a fixed index list (the mesh's tet
corners, the vertex->aggregate map of the coarse preconditioner) the table
of source rows per output row is built once on the host, and every
accumulation is one gather plus a dense sum over the table's second axis.

Self-contact needs the same for DYNAMIC index sets: the active pair
stencils change every Newton iteration, and the lagged friction pairs every
step. `make_dynamic_gather_sum` builds the table on the device (stable sort
of the ids, bincount, rank within each segment, one host read of the
largest multiplicity) once per index set; the barrier gradient, the pair
block Hv of every PCG iteration, the diagonal blocks and the coarse pair
cells then reuse it. Rows keep ascending position order within each
segment: the order of the updates JAX's `.at[ids].add` receives.

On CUDA this is the port's deterministic vertex accumulation: no float
atomics (`index_add_` with colliding indices sums in a run-dependent order),
so a step is bitwise repeatable. A sharded step (parallel/) keeps this:
each rank gathers over the tables of its own tets and pairs into all V
rows, and the ranks' partials are added in rank order (parallel/spmd.py).
The JAX version's SPMD branch, a scatter-add under a mesh
(`scatter.py:53-65`), is not ported: it relies on the partitioner and on
float atomics, which the port does not use.
"""

import numpy as np
import torch

from ipc_tpu_torch.utils.observability import host_read

__all__ = ["gather_table", "make_gather_sum", "make_dynamic_gather_sum"]


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


def make_dynamic_gather_sum(ids, n_out):
    """Gather-sum over a device index tensor ids (N,) int64 in [0, n_out).

    Returns `apply(vals)`: (N, ...) -> (n_out, ...), the per-id sums. The
    table covers only the ids that occur (`apply.rows`, ascending, unique):
    rows no id touches are exact zeros, written with an `index_copy` over
    unique rows. Building it reads two numbers back to the host in one sync
    (row count, largest multiplicity; `host_read` site "gather_sum.table"),
    none for an empty set."""
    device = ids.device
    N = int(ids.shape[0])
    if N == 0:
        def apply(vals):
            return torch.zeros((n_out,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                               device=device)

        apply.rows = ids
        return apply
    sorted_ids, order = torch.sort(ids, stable=True)
    pos = torch.arange(N, device=device)
    is_start = torch.ones((N,), dtype=torch.bool, device=device)
    is_start[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(is_start.to(torch.int64), dim=0) - 1  # segment per position
    first = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), dim=0).values
    rank = pos - first
    n_rows, D = host_read("gather_sum.table", seg[-1] + 1, rank.max() + 1)
    rows = sorted_ids[torch.searchsorted(seg, torch.arange(n_rows, device=device))]
    table = torch.full((n_rows, D), N, dtype=torch.int64, device=device)
    table[seg, rank] = order  # (seg, rank) pairs are unique

    def apply(vals):
        pad = torch.zeros((1,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        summed = torch.cat([vals, pad], dim=0)[table].sum(dim=1)
        out = torch.zeros((n_out,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        return out.index_copy(0, rows, summed)

    apply.rows = rows
    return apply
