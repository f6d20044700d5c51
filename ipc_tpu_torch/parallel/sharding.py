"""Sharding plans: one scene's step split over the ranks of a process group.

Port of ipc_tpu/parallel/sharding.py onto torch.distributed. The padding is
the JAX package's, bit for bit (`shard_mesh_data`, `shard_state`): at least
one sentinel vertex parked at bbox_max + 4 max(diag, 1) with mass 0, held
by the Dirichlet mask, component 0; padding tets with all four corners on
the sentinel and rest_inv, vol, mu, lam 0 (zero energy, gradient and
Hessian); padding surface primitives on the sentinel (degenerate, far
away, all-Dirichlet: no candidate pair touches them).

What is split differs from JAX (ROADMAP §3). JAX shards every leading
axis, the vertex state included, and XLA's partitioner gathers it where a
tet reads it. Here each rank owns a contiguous row range of the padded
per-tet arrays (tets, rest_inv, vol, mu, lam: its elasticity energy,
gradient and (T/n,12,12) Hessian blocks, which dominate the memory) and of
the surface primitives it queries in the broad phase (its candidate,
active and friction pairs). The vertex-sized state and vectors (x, v, a,
mass, the Dirichlet mask, the PCG vectors) are replicated: V x 3 is small
beside H, every rank reads them without a gather, and every value that
drives a host decision comes out of a sum over ranks, so every rank takes
the same branch (parallel/spmd.py).

`shard_stepper` turns a scene's IPCStepper into one rank's: its mesh is the
padded mesh with the rank's tet rows only (vertex and surface arrays whole),
and the self-contact pipeline is rebound to it. With rank=None it pads and
keeps every tet: the unsharded step over the padded mesh, the reference a
sharded run is held to.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ipc_tpu_torch.mesh import MeshData

__all__ = ["Shard", "make_group", "row_range", "shard_mesh_data", "shard_state",
           "shard_stepper", "replicate", "shard_report"]

TET_FIELDS = ("tets", "rest_inv", "vol", "mu", "lam")
VERT_FIELDS = ("x_rest", "mass", "dbc_mask", "vert_comp")
SURF_FIELDS = ("surf_tris", "surf_edges", "surf_verts")


@dataclass(frozen=True)
class Shard:
    """Which part of a padded mesh a stepper holds: rank `rank` of `world`;
    n_tets is the whole padded mesh's tet count."""

    rank: int
    world: int
    n_tets: int


def make_group(backend, init_method, rank, world):
    """Initialize the default process group (`backend` "nccl" or "gloo",
    `init_method` e.g. "tcp://localhost:<port>" or "file://<path>") and
    return it."""
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    return dist.group.WORLD


def row_range(n_rows, rank, world):
    """(start, stop) of rank's contiguous share of n_rows rows."""
    return n_rows * rank // world, n_rows * (rank + 1) // world


def _pad_rows(t, rem, fill):
    if rem == 0:
        return t
    fill = torch.as_tensor(np.asarray(fill), device=t.device).to(t.dtype)
    return torch.cat([t, fill.expand((rem,) + tuple(t.shape[1:]))], dim=0)


def shard_mesh_data(mesh, world, rank=0):
    """(padded MeshData, rank's rows): every leading axis padded to a
    multiple of `world` as ipc_tpu.parallel.sharding.shard_mesh_data pads
    it (module docstring), on the mesh's device, and the (start, stop)
    rows of `rank` of each per-tet and surface array."""
    n = int(world)
    V0 = int(mesh.x_rest.shape[0])
    padV = ((-(V0 + 1)) % n) + 1  # at least one sentinel, total a multiple of n
    sent = V0
    xr = mesh.x_rest.cpu().numpy()
    bmin, bmax = xr.min(axis=0), xr.max(axis=0)
    diag = float(np.linalg.norm(bmax - bmin))
    sentinel = bmax + 4.0 * max(diag, 1.0)

    def pad(name, fill):
        t = getattr(mesh, name)
        if name in TET_FIELDS:
            rem = (-int(t.shape[0])) % n
        elif name in SURF_FIELDS:
            rem = (-int(t.shape[0])) % n
        else:
            rem = padV
        return _pad_rows(t, rem, fill)

    out = MeshData(
        x_rest=pad("x_rest", sentinel),
        tets=pad("tets", np.full(4, sent)),
        rest_inv=pad("rest_inv", np.zeros((3, 3))),
        vol=pad("vol", 0.0),
        mass=pad("mass", 0.0),
        mu=pad("mu", 0.0),
        lam=pad("lam", 0.0),
        surf_tris=pad("surf_tris", np.full(3, sent)),
        surf_edges=pad("surf_edges", np.full(2, sent)),
        surf_verts=pad("surf_verts", sent),
        dbc_mask=pad("dbc_mask", True),
        vert_comp=pad("vert_comp", 0),
    )
    rows = {k: row_range(int(getattr(out, k).shape[0]), rank, n)
            for k in TET_FIELDS + SURF_FIELDS}
    return out, rows


def shard_state(state, mesh):
    """SimState padded to the padded `mesh`: positions on the sentinel,
    velocities, accelerations and dx_el zero (ipc_tpu's shard_state)."""
    Vp = int(mesh.x_rest.shape[0])
    sent = mesh.x_rest[-1]

    def pad_vec(t, fill_sent):
        if t is None:
            return None
        rem = Vp - int(t.shape[0])
        if rem <= 0:
            return t
        fill = sent if fill_sent else torch.zeros(3, dtype=t.dtype, device=t.device)
        return torch.cat([t, fill.to(t.dtype).expand(rem, 3)], dim=0)

    return dataclasses.replace(
        state, x=pad_vec(state.x, True), x_prev=pad_vec(state.x_prev, True),
        v=pad_vec(state.v, False), a=pad_vec(state.a, False),
        dx_el=pad_vec(state.dx_el, False))


def local_mesh(mesh, rows):
    """The padded mesh with only the rows `rows` of its per-tet arrays
    (copies: the other ranks' rows are not kept)."""
    return dataclasses.replace(mesh, **{k: getattr(mesh, k)[slice(*rows[k])].clone()
                                        for k in TET_FIELDS})


def shard_stepper(stepper, world, rank=None, pad=None):
    """Make `stepper` (an IPCStepper built on an unpadded mesh) rank's part
    of a `world`-rank run: the padded mesh, with rank's tet rows only, and
    the self-contact pipeline rebound to it (stepper.shard says which).
    rank=None pads and keeps every tet (stepper.shard None): the unsharded
    step over the same padded mesh. `pad` pads for another rank count than
    `world` (a 1-rank group over the mesh of a 2-rank run). The scene's
    scalars (voxel, bbox, dHat) stay the unpadded mesh's, as in the JAX
    package's multichip entry point. Returns the stepper."""
    padded, _ = shard_mesh_data(stepper.mesh, pad or world)
    rows = {k: row_range(int(getattr(padded, k).shape[0]), rank or 0, world)
            for k in TET_FIELDS + SURF_FIELDS}
    mesh = padded if rank is None else local_mesh(padded, rows)
    stepper.mesh = mesh
    stepper._sv = mesh.surf_verts
    stepper._dbc_sv = mesh.dbc_mask[mesh.surf_verts]
    stepper._dbc_np = mesh.dbc_mask.cpu().numpy()
    stepper._sv_np = mesh.surf_verts.cpu().numpy()
    stepper._terms = {}
    stepper.shard = None if rank is None else Shard(rank, world, int(padded.tets.shape[0]))
    if stepper.sc is not None:
        stepper.sc.rebind_mesh(mesh)
    return stepper


def replicate(tree, src=0):
    """Broadcast every tensor of `tree` (a tensor, a dataclass such as
    SimState, a dict or a list of them) from rank `src` of the active group,
    in place; returns the tree. The identity with no active group."""
    from ipc_tpu_torch.parallel import spmd

    group = spmd.active_group()
    if group is None:
        return tree
    import torch.distributed as dist

    def visit(a):
        if torch.is_tensor(a):
            dist.broadcast(a, src=src, group=group)
        elif dataclasses.is_dataclass(a):
            for f in dataclasses.fields(a):
                visit(getattr(a, f.name))
        elif isinstance(a, dict):
            for v in a.values():
                visit(v)
        elif isinstance(a, (list, tuple)):
            for v in a:
                visit(v)

    visit(tree)
    return tree


def shard_report(mesh, state=None, shard=None):
    """[(name, bytes over all ranks, bytes on this rank, "split" or
    "replicated")] of the mesh's arrays, the elasticity Hessian blocks
    (T,12,12) of a Newton iteration and the state's vertex arrays, for a
    rank's mesh (`shard` from shard_stepper) or an unsharded one."""
    n = 1 if shard is None else shard.world
    out = []
    for k in TET_FIELDS:
        t = getattr(mesh, k)
        b = t.numel() * t.element_size()
        out.append((f"mesh.{k}", b * n, b, "split" if n > 1 else "replicated"))
    T = int(mesh.tets.shape[0])
    hb = T * 144 * mesh.x_rest.element_size()
    out.append(("newton.H_el", hb * n, hb, "split" if n > 1 else "replicated"))
    for k in VERT_FIELDS + SURF_FIELDS:
        t = getattr(mesh, k)
        b = t.numel() * t.element_size()
        out.append((f"mesh.{k}", b, b, "replicated"))
    if state is not None:
        for k in ("x", "x_prev", "v", "a"):
            t = getattr(state, k)
            b = t.numel() * t.element_size()
            out.append((f"state.{k}", b, b, "replicated"))
    return out
