"""Procedural tet meshes: the port's own copy of ipc_tpu/models/primitives.py.

Host numpy only. An axis-aligned box grid Kuhn-triangulated into 6 tets per
cell (the topology family of the reference's cube.msh / mat*x* meshes), and
the cube, mat and rod shapes built on it. The port keeps this copy so that
it imports nothing of the JAX package; tests/test_torch_scenes.py holds it
equal to the original.
"""

import numpy as np

__all__ = ["box_grid", "cube", "mat", "rod"]

# Kuhn subdivision of the unit cell into 6 positively-oriented tets.
# Corner ids: bit0 = x, bit1 = y, bit2 = z  (c000=0, c100=1, c010=2, ...)
_KUHN = [
    (0, 1, 3, 7),
    (0, 3, 2, 7),
    (0, 2, 6, 7),
    (0, 6, 4, 7),
    (0, 4, 5, 7),
    (0, 5, 1, 7),
]


def box_grid(nx, ny, nz, size=(1.0, 1.0, 1.0), origin=(0.0, 0.0, 0.0)):
    """Tet-mesh an axis-aligned box with (nx,ny,nz) cells -> (V, T)."""
    xs = np.linspace(0, size[0], nx + 1) + origin[0]
    ys = np.linspace(0, size[1], ny + 1) + origin[1]
    zs = np.linspace(0, size[2], nz + 1) + origin[2]
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    V = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    tets = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                corner = [
                    vid(i + (c & 1), j + ((c >> 1) & 1), k + ((c >> 2) & 1))
                    for c in range(8)
                ]
                for t in _KUHN:
                    tets.append([corner[t[0]], corner[t[1]], corner[t[2]], corner[t[3]]])
    T = np.asarray(tets, dtype=np.int32)
    # fix orientation (build_mesh also reorients, but keep them positive here)
    D = np.stack(
        [V[T[:, 1]] - V[T[:, 0]], V[T[:, 2]] - V[T[:, 0]], V[T[:, 3]] - V[T[:, 0]]],
        axis=2,
    )
    neg = np.linalg.det(D) < 0
    T[neg, 2], T[neg, 3] = T[neg, 3], T[neg, 2].copy()
    return V, T


def cube(n=1, size=1.0, origin=(0.0, 0.0, 0.0)):
    """n x n x n cell cube (n=1 -> 6 tets, like the reference cube.msh)."""
    return box_grid(n, n, n, (size, size, size), origin)


def mat(n, size=1.0, thickness_cells=1):
    """Thin mat: n x 1 x n cells (the reference's matNxN family)."""
    t = thickness_cells
    return box_grid(n, t, n, (size, size * t / n, size))


def rod(n, length=1.0, width=0.1):
    """Slender rod along x: n x 1 x 1 cells."""
    return box_grid(n, 1, 1, (length, width, width))
