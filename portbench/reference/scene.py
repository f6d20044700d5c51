"""A configuration's scene, rebuilt from its own parameters.

`build(cfg, device)` turns the "scene" block of a configuration file
(portbench/configs/<config>.json) into the tensors the reference judges a
step with: rest positions, tets, lumped masses, rest-shape inverses,
volumes, Lame parameters, the boundary surface (triangles, edges,
vertices), the scripted handles and the scene's constants (time step,
gravity, barrier and friction widths). The box-grid generator is a frozen
copy of the Kuhn triangulation that the IPC reference's cube and mat meshes
use (6 tets per cell); vertex order is the generator's, bodies in the order
the file lists them.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Scene", "box_grid", "build"]

# Kuhn subdivision of the unit cell; corner ids: bit0 = x, bit1 = y, bit2 = z
_KUHN = ((0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7))
# the four faces of a positively oriented tet, outward
_FACES = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]], np.int64)


def box_grid(cells, size, origin):
    """(V (n,3) float64, T (m,4) int64) of an axis-aligned box of
    cells = (nx, ny, nz) cells, 6 tets per cell."""
    nx, ny, nz = cells
    axes = [np.linspace(0.0, s, n + 1) + o for n, s, o in zip(cells, size, origin)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    V = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    i, j, k = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    i, j, k = i.reshape(-1), j.reshape(-1), k.reshape(-1)
    corner = np.stack([((i + (c & 1)) * (ny + 1) + j + ((c >> 1) & 1)) * (nz + 1)
                       + k + ((c >> 2) & 1) for c in range(8)], axis=1)
    T = corner[:, np.array(_KUHN)].reshape(-1, 4).astype(np.int64)
    return V, T


def _orient(V, T):
    D = np.stack([V[T[:, 1]] - V[T[:, 0]], V[T[:, 2]] - V[T[:, 0]],
                  V[T[:, 3]] - V[T[:, 0]]], axis=2)
    neg = np.linalg.det(D) < 0
    T = T.copy()
    T[neg, 2], T[neg, 3] = T[neg, 3], T[neg, 2].copy()
    return T


def _surface(T):
    faces = T[:, _FACES].reshape(-1, 3)
    _, inv, counts = np.unique(np.sort(faces, axis=1), axis=0, return_inverse=True,
                               return_counts=True)
    tris = faces[counts[inv.reshape(-1)] == 1]
    edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    return tris, edges, np.unique(tris.reshape(-1))


def _rotation(axis, angle):
    a = np.asarray(axis, float)
    a = a / np.linalg.norm(a)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]], [-a[1], a[0], 0.0]])
    return np.eye(3) + math.sin(angle) * K + (1.0 - math.cos(angle)) * (K @ K)


@dataclass
class Scene:
    x_rest: torch.Tensor  # (V,3) float64
    tets: torch.Tensor  # (T,4) int64, positively oriented
    mass: torch.Tensor  # (V,) lumped
    vol: torch.Tensor  # (T,)
    rest_inv: torch.Tensor  # (T,3,3)
    mu: float
    lam: float
    tris: torch.Tensor  # (S,3) surface triangles
    edges: torch.Tensor  # (E,2) surface edges
    surf: torch.Tensor  # (Sv,) surface vertices
    dbc: torch.Tensor  # (V,) bool, scripted vertices
    handles: list  # [(vertex ids (n,), R (3,3), center (3,))]: per-step rotation
    dt: float
    gravity: torch.Tensor  # (3,)
    dhat2: float  # squared barrier width
    eps2: float  # squared friction smoothing width
    mu_self: float
    ground: dict  # {"normal": (3,), "offset": float, "friction": float} or None
    self_contact: bool
    bbox_diag: float
    bodies: list  # [(first vertex, end vertex)] per body, in file order
    rel_gl2_tol: float  # Newton tolerance: |dx|_inf < sqrt(tol) bboxDiag h


def build(cfg, device="cpu"):
    """The Scene of a configuration's "scene" block on `device` (float64)."""
    sc = cfg["scene"]
    Vs, Ts, off, ranges = [], [], 0, []
    for body in sc["bodies"]:
        if body["generator"] != "box_grid":
            raise ValueError(f"unknown generator {body['generator']!r}")
        V, T = box_grid(body["cells"], body["size"], body["offset"])
        Vs.append(V)
        Ts.append(T + off)
        ranges.append((off, off + len(V)))
        off += len(V)
    V = np.concatenate(Vs)
    T = _orient(V, np.concatenate(Ts))
    D = np.stack([V[T[:, 1]] - V[T[:, 0]], V[T[:, 2]] - V[T[:, 0]],
                  V[T[:, 3]] - V[T[:, 0]]], axis=2)
    vol = np.linalg.det(D) / 6.0
    mass = np.zeros(len(V))
    np.add.at(mass, T.reshape(-1), np.repeat(vol * sc["density"] / 4.0, 4))
    E, nu = sc["youngs_modulus"], sc["poisson_ratio"]
    tris, edges, surf = _surface(T)
    lo, hi = V.min(axis=0), V.max(axis=0)
    diag2 = float(((hi - lo) ** 2).sum())
    dbc = np.zeros(len(V), bool)
    handles = []
    script = sc.get("script")
    if script is not None:
        if script["name"] != "twist":
            raise ValueError(f"unknown script {script['name']!r}")
        rng = hi - lo
        ratio = script["handle_ratio"]
        center = 0.5 * (lo + hi)
        sides = (np.nonzero(V[:, 0] < lo[0] + rng[0] * ratio)[0],
                 np.nonzero(V[:, 0] > hi[0] - rng[0] * ratio)[0])
        for ids, w in zip(sides, script["angular_velocity"]):
            dbc[ids] = True
            handles.append((torch.as_tensor(ids, device=device),
                            torch.as_tensor(_rotation(script["axis"], w * sc["dt"]),
                                            device=device),
                            torch.as_tensor(center, device=device)))
    ground = sc.get("ground")
    if ground is not None:
        n = np.asarray(ground["normal"], float)
        n = n / np.linalg.norm(n)
        ground = dict(normal=torch.as_tensor(n, device=device),
                      offset=-float(n @ np.asarray(ground["origin"], float)),
                      friction=float(ground["friction"]))

    def t(a, dtype=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    return Scene(
        x_rest=t(V), tets=t(T, torch.int64), mass=t(mass), vol=t(vol),
        rest_inv=t(np.linalg.inv(D)),
        mu=E / (2.0 * (1.0 + nu)), lam=E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu)),
        tris=t(tris, torch.int64), edges=t(edges, torch.int64), surf=t(surf, torch.int64),
        dbc=t(dbc, torch.bool), handles=handles, dt=float(sc["dt"]),
        gravity=t(sc["gravity"]),
        dhat2=sc["dhat_rel"] ** 2 * diag2,
        eps2=sc["epsv_rel"] ** 2 * sc["dt"] ** 2 * diag2,
        mu_self=float(sc["self_friction"]), ground=ground,
        self_contact=bool(sc["self_contact"]), bbox_diag=math.sqrt(diag2), bodies=ranges,
        rel_gl2_tol=float(sc["rel_gl2_tol"]),
    )
