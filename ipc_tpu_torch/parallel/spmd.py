"""The active process group and the collectives of a sharded step.

Port of ipc_tpu/parallel/spmd.py. JAX pins a few intermediates to a
sharding and lets XLA's partitioner insert the collectives; torch has no
partitioner, so the step calls them itself, through the helpers here:

  all_sum(t)      the sum over ranks, added in rank order: each rank writes
                  its slot of an (n, ...) zero buffer, one all_reduce fills
                  every slot (each element gets one addend and n - 1 exact
                  zeros), and the slots are added 0, 1, ..., n-1. The result
                  is the same bits on every rank and under every backend,
                  whatever order the backend reduces in;
  df_all_sum(E)   the same for a compensated (hi, lo) energy pair: the
                  ranks' pairs are combined with df_add in rank order
                  (ops/compensated.py), never as plain float totals;
  all_min(t)      the least value over ranks (exact);
  all_any(t)      a 0-d bool, True where any rank's is;
  sum_ints(vals)  host integers summed over ranks (set sizes for the stats).

Only all_reduce is used (and broadcast in sharding.replicate): NCCL takes
them on CUDA tensors, gloo on CPU tensors and, staged through host memory,
on CUDA tensors too. Every rank must call every collective in the same
order: a caller never skips one on a rank-local condition (an empty pair
set on one rank). Each all_reduce counts in `spmd.collectives`
(utils/observability).

The owner rank (rank 0) adds the replicated terms of a sum once (mass,
half-space blocks, the moving-DBC pull, external forces): its partial is
the unsharded sum's first terms in the unsharded order, the other ranks
contribute only their tets and pairs. With no active group every helper
is the identity and `owner()` is True, so the single-device step runs the
same operations in the same order, bit for bit.
"""

import torch

from ipc_tpu_torch.utils.observability import count, host_read

__all__ = ["activate", "deactivate", "active_group", "rank", "world", "owner",
           "all_sum", "df_all_sum", "all_min", "all_any", "sum_ints"]

_CTX = {"group": None, "rank": 0, "world": 1, "device": None}


def activate(group, device):
    """Make `group` (a torch.distributed process group) the active one;
    `device` holds the buffers of host-value collectives (the rank's card,
    or the CPU under gloo)."""
    import torch.distributed as dist

    _CTX.update(group=group, rank=dist.get_rank(group), world=dist.get_world_size(group),
                device=torch.device(device))


def deactivate():
    _CTX.update(group=None, rank=0, world=1, device=None)


def active_group():
    return _CTX["group"]


def rank():
    return _CTX["rank"]


def world():
    return _CTX["world"]


def owner():
    """True on the rank that adds the replicated terms (rank 0), and with
    no active group."""
    return _CTX["rank"] == 0


def _all_reduce(buf, op=None):
    import torch.distributed as dist

    count("spmd.collectives")
    dist.all_reduce(buf, op=dist.ReduceOp.SUM if op is None else op, group=_CTX["group"])
    return buf


def _slots(t):
    """(n, *t.shape) buffer after the all_reduce: slot r holds rank r's t."""
    buf = torch.zeros((_CTX["world"],) + tuple(t.shape), dtype=t.dtype, device=t.device)
    buf[_CTX["rank"]] = t
    return _all_reduce(buf)


def all_sum(t):
    """Sum of t over ranks in rank order (module docstring)."""
    if _CTX["group"] is None:
        return t
    buf = _slots(t)
    out = buf[0]
    for r in range(1, _CTX["world"]):
        out = out + buf[r]
    return out


def df_all_sum(E):
    """Compensated (hi, lo) pair summed over ranks with df_add in rank
    order."""
    if _CTX["group"] is None:
        return E
    from ipc_tpu_torch.ops.compensated import df_add

    buf = _slots(torch.stack(E))
    out = (buf[0, 0], buf[0, 1])
    for r in range(1, _CTX["world"]):
        out = df_add(out, (buf[r, 0], buf[r, 1]))
    return out


def all_min(t):
    """Element-wise minimum of t over ranks."""
    if _CTX["group"] is None:
        return t
    import torch.distributed as dist

    return _all_reduce(t.reshape(-1).clone(), dist.ReduceOp.MIN).reshape(t.shape)


def all_any(t):
    """0-d bool: t (0-d bool) on any rank."""
    if _CTX["group"] is None:
        return t
    return _all_reduce(t.reshape(1).to(torch.int32))[0] > 0


def sum_ints(vals):
    """Host integers summed over ranks (one collective); the list as given
    with no active group."""
    if _CTX["group"] is None:
        return list(vals)
    buf = torch.as_tensor(list(vals), dtype=torch.int64, device=_CTX["device"])
    return [int(v) for v in host_read("spmd.sum_ints", _all_reduce(buf))]
