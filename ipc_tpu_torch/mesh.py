"""Tet mesh + embedded surface state as tensors.

Port of ipc_tpu/mesh.py. The host side is the same numpy code (copied, not
imported: ipc_tpu.mesh imports jax), including the reorientation and the
stable sort of tets by minimum vertex id, so tet order matches the JAX mesh
exactly. Index fields are int64 (torch's index type); the CUDA kernel's
int32 tables are built beside it (ops/tet_hv.py).

`append_kinematic_surface` adds a kinematic collision object (the scene
file's codimensional shapes and `meshCO` obstacles) as tet-less,
Dirichlet-constrained surface vertices on the mesh's device.
"""

from dataclasses import dataclass, field, fields, replace

import numpy as np
import torch

from ipc_tpu_torch.device import resolve_device

__all__ = [
    "MeshData",
    "MeshMeta",
    "build_mesh",
    "lame_params",
    "merge_meshes",
    "append_kinematic_surface",
]


@dataclass(frozen=True)
class MeshData:
    """Device-side mesh tensors; all on one device, floats in one dtype."""

    x_rest: torch.Tensor  # (V,3)
    tets: torch.Tensor  # (T,4) int64
    rest_inv: torch.Tensor  # (T,3,3)
    vol: torch.Tensor  # (T,)
    mass: torch.Tensor  # (V,) lumped, includes density
    mu: torch.Tensor  # (T,) first Lame parameter (shear)
    lam: torch.Tensor  # (T,) second Lame parameter
    surf_tris: torch.Tensor  # (S,3) int64, outward oriented
    surf_edges: torch.Tensor  # (E,2) int64, undirected unique
    surf_verts: torch.Tensor  # (Sv,) int64
    dbc_mask: torch.Tensor  # (V,) bool — Dirichlet-constrained vertices
    vert_comp: torch.Tensor  # (V,) int64 — component id per vertex

    @property
    def device(self):
        return self.x_rest.device

    @property
    def dtype(self):
        return self.x_rest.dtype


FLOAT_FIELDS = ("x_rest", "rest_inv", "vol", "mass", "mu", "lam")
MESH_FIELDS = tuple(f.name for f in fields(MeshData))


@dataclass
class MeshMeta:
    """Host-side metadata."""

    n_verts: int = 0
    n_tets: int = 0
    bbox: np.ndarray = None  # (2,3) min/max of rest positions
    bbox_diag2: float = 0.0
    avg_edge_len: float = 0.0
    avg_node_mass: float = 0.0
    comp_ranges: list = field(default_factory=list)
    dbc_is_zero: np.ndarray = None


def lame_params(ym, pr):
    """Young's modulus + Poisson ratio -> (mu, lambda)."""
    mu = ym / (2.0 * (1.0 + pr))
    lam = ym * pr / ((1.0 + pr) * (1.0 - 2.0 * pr))
    return mu, lam


_FACES = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], dtype=np.int64)


def _boundary_faces(tets):
    """Outward-oriented boundary faces of a positively-oriented tet mesh."""
    faces = tets[:, _FACES].reshape(-1, 3)  # (4T,3)
    key = np.sort(faces, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    return faces[counts[inv.reshape(-1)] == 1]


def _reorient_positive(V, T):
    D = np.stack(
        [V[T[:, 1]] - V[T[:, 0]], V[T[:, 2]] - V[T[:, 0]], V[T[:, 3]] - V[T[:, 0]]],
        axis=2,
    )
    neg = np.linalg.det(D) < 0
    T = T.copy()
    T[neg, 2], T[neg, 3] = T[neg, 3], T[neg, 2].copy()
    return T


def mesh_arrays(
    V,
    T,
    density=1000.0,
    ym=1e5,
    pr=0.4,
    dbc_mask=None,
    vert_comp=None,
    comp_ranges=None,
):
    """Host half of build_mesh: (dict of numpy MeshData fields, MeshMeta)."""
    V = np.asarray(V, dtype=np.float64)
    T = _reorient_positive(V, np.asarray(T, dtype=np.int64))
    # sort tets by min vertex id (semantics-free; keeps the JAX tet order)
    T = T[np.argsort(T.min(axis=1), kind="stable")]
    nV, nT = len(V), len(T)

    D = np.stack(
        [V[T[:, 1]] - V[T[:, 0]], V[T[:, 2]] - V[T[:, 0]], V[T[:, 3]] - V[T[:, 0]]],
        axis=2,
    )
    det = np.linalg.det(D)
    if np.any(det <= 0):
        raise ValueError("degenerate or inverted rest tets")
    rest_inv = np.linalg.inv(D)
    vol = det / 6.0

    density = np.broadcast_to(np.asarray(density, dtype=np.float64), (nT,))
    mass = np.zeros(nV)
    np.add.at(mass, T.reshape(-1), np.repeat(vol * density / 4.0, 4))

    mu, lam = lame_params(np.broadcast_to(np.asarray(ym, dtype=np.float64), (nT,)),
                          np.broadcast_to(np.asarray(pr, dtype=np.float64), (nT,)))

    SF = _boundary_faces(T)
    se = np.concatenate([SF[:, [0, 1]], SF[:, [1, 2]], SF[:, [2, 0]]], axis=0)
    se = np.unique(np.sort(se, axis=1), axis=0)
    SV = np.unique(SF.reshape(-1))

    if dbc_mask is None:
        dbc_mask = np.zeros(nV, dtype=bool)
    if vert_comp is None:
        vert_comp = np.zeros(nV, dtype=np.int64)

    bbox = np.stack([V.min(axis=0), V.max(axis=0)])
    meta = MeshMeta(
        n_verts=nV,
        n_tets=nT,
        bbox=bbox,
        bbox_diag2=float(np.sum((bbox[1] - bbox[0]) ** 2)),
        avg_edge_len=float(np.mean(np.linalg.norm(V[se[:, 0]] - V[se[:, 1]], axis=1)))
        if len(se)
        else 0.0,
        avg_node_mass=float(mass.sum() / nV),
        comp_ranges=comp_ranges or [(0, nV)],
        dbc_is_zero=np.ones(nV, dtype=bool),
    )
    arrays = dict(
        x_rest=V, tets=T, rest_inv=rest_inv, vol=vol, mass=mass,
        mu=np.asarray(mu), lam=np.asarray(lam), surf_tris=SF, surf_edges=se,
        surf_verts=SV, dbc_mask=np.asarray(dbc_mask, bool),
        vert_comp=np.asarray(vert_comp),
    )
    return arrays, meta


def mesh_from_arrays(arrays, device, dtype):
    """MeshData from numpy arrays named like its fields: floats cast to
    `dtype`, indices to int64, the mask to bool, all on `device`, each
    row-major (a column-major V, as a rotated scene shape gives, would
    carry its layout into the state and every vector the step derives
    from it; the Hv kernel takes only contiguous vectors)."""

    def conv(name):
        a = np.asarray(arrays[name])
        if name in FLOAT_FIELDS:
            return torch.as_tensor(np.array(a, np.float64, order="C"), device=device).to(dtype)
        if name == "dbc_mask":
            return torch.as_tensor(a.astype(bool), device=device)
        return torch.as_tensor(a.astype(np.int64), device=device)

    return MeshData(**{name: conv(name) for name in MESH_FIELDS})


def build_mesh(
    V,
    T,
    density=1000.0,
    ym=1e5,
    pr=0.4,
    dbc_mask=None,
    vert_comp=None,
    comp_ranges=None,
    dtype=torch.float64,
    device=None,
):
    """Build MeshData + MeshMeta from raw vertices/tets (host numpy, then
    one copy to `device`: the card when None, "cpu" for the CPU). Defaults
    mirror the reference scene defaults (density 1000, YM 1e5, PR 0.4)."""
    arrays, meta = mesh_arrays(V, T, density, ym, pr, dbc_mask, vert_comp,
                               comp_ranges)
    return mesh_from_arrays(arrays, resolve_device(device), dtype), meta


def append_kinematic_surface(mesh, meta, V_co, tris=None, edges=None):
    """Append a kinematic collision object's surface to the scene mesh (the
    JAX package's MeshCO<3> counterpart): its vertices join the vertex array
    as tet-less, Dirichlet-constrained surface geometry with the scene's
    average node mass and a new component id, so the one self-contact
    pipeline handles deformable-vs-object contacts (object-vs-object pairs
    are all-DBC and filtered out). Edges default to the triangles' unique
    edges. The bbox grows; bbox_diag2 stays the deformable one (dHat and
    kappa scale with it).

    Returns (new MeshData on the mesh's device, new MeshMeta,
    (v_start, v_end) of the object's vertices)."""
    device, dtype = mesh.device, mesh.dtype
    V_co = np.array(V_co, dtype=np.float64, order="C")
    n_old = int(mesh.x_rest.shape[0])
    n_co = len(V_co)

    tris = np.zeros((0, 3), np.int64) if tris is None else np.asarray(tris, np.int64)
    if edges is None:
        e = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]], axis=0)
        edges = np.unique(np.sort(e, axis=1), axis=0) if len(e) else np.zeros((0, 2), np.int64)
    else:
        edges = np.asarray(edges, np.int64)
    sv_co = (
        np.unique(np.concatenate([tris.reshape(-1), edges.reshape(-1)]))
        if (len(tris) or len(edges))
        else np.arange(n_co)
    )

    def ids(a):
        return torch.as_tensor(np.asarray(a, np.int64) + n_old, device=device)

    comp_id = int(mesh.vert_comp.max()) + 1 if n_old else 0
    new_mesh = replace(
        mesh,
        x_rest=torch.cat([mesh.x_rest, torch.as_tensor(V_co, device=device).to(dtype)]),
        mass=torch.cat([mesh.mass, torch.full((n_co,), meta.avg_node_mass, dtype=dtype,
                                              device=device)]),
        surf_tris=torch.cat([mesh.surf_tris, ids(tris)]),
        surf_edges=torch.cat([mesh.surf_edges, ids(edges)]),
        surf_verts=torch.cat([mesh.surf_verts, ids(sv_co)]),
        dbc_mask=torch.cat([mesh.dbc_mask, torch.ones((n_co,), dtype=torch.bool,
                                                      device=device)]),
        vert_comp=torch.cat([mesh.vert_comp, torch.full((n_co,), comp_id, dtype=torch.int64,
                                                        device=device)]),
    )
    new_meta = MeshMeta(
        n_verts=n_old + n_co,
        n_tets=meta.n_tets,
        bbox=np.stack([np.minimum(meta.bbox[0], V_co.min(axis=0)),
                       np.maximum(meta.bbox[1], V_co.max(axis=0))]) if n_co else meta.bbox,
        bbox_diag2=meta.bbox_diag2,
        avg_edge_len=meta.avg_edge_len,
        avg_node_mass=meta.avg_node_mass,
        comp_ranges=meta.comp_ranges + [(n_old, n_old + n_co)],
        dbc_is_zero=meta.dbc_is_zero,
    )
    return new_mesh, new_meta, (n_old, n_old + n_co)


def merge_meshes(parts):
    """Concatenate (V, T) parts into one scene mesh:
    (V, T, per-vertex component id, [(v_start, v_end)] per part)."""
    Vs, Ts, comp = [], [], []
    off = 0
    ranges = []
    for i, (V, T) in enumerate(parts):
        Vs.append(V)
        Ts.append(np.asarray(T) + off)
        comp.append(np.full(len(V), i, dtype=np.int32))
        ranges.append((off, off + len(V)))
        off += len(V)
    return (
        np.concatenate(Vs, axis=0),
        np.concatenate(Ts, axis=0),
        np.concatenate(comp),
        ranges,
    )
