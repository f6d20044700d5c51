"""Mesh file IO: Gmsh .msh (4.1 ASCII), Wavefront .obj, .seg, .node/.ele.

The port's own copy of ipc_tpu/io_mesh.py (numpy only; the port imports
nothing of the JAX package). tests/test_torch_io_config.py holds it equal
to the original: the same bytes written, the same arrays read.

Host-side (numpy) replacements for the reference's readers
(reference: src/Utils/IglUtils.cpp readTetMesh/readTetMesh_msh4/readNodeEle/
readSEG :211-337 via MshIO/libigl). Only the formats the reference's input
suites actually use are supported; everything returns plain numpy arrays.
"""

import numpy as np

__all__ = [
    "read_msh",
    "read_obj",
    "read_seg",
    "read_node_ele",
    "write_obj",
    "write_seg",
    "write_msh",
]


def read_msh(path):
    """Read a Gmsh 4.1 ASCII .msh tet mesh -> (V (n,3) f64, T (m,4) i32).

    Handles the node-tag indirection (tags need not be 1..n contiguous).
    """
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0
    V = None
    tets = []
    tag2idx = {}

    def expect(section):
        nonlocal i
        while i < len(lines) and lines[i].strip() != section:
            i += 1
        i += 1

    # $MeshFormat
    expect("$MeshFormat")
    version = lines[i].split()[0]
    if not version.startswith("4"):
        return _read_msh_legacy(lines)
    expect("$Nodes")
    header = lines[i].split()
    i += 1
    num_blocks, num_nodes = int(header[0]), int(header[1])
    V = np.zeros((num_nodes, 3))
    count = 0
    for _ in range(num_blocks):
        blk = lines[i].split()
        i += 1
        n_in_blk = int(blk[3])
        tags = []
        for k in range(n_in_blk):
            tags.append(int(lines[i]))
            i += 1
        for k in range(n_in_blk):
            xyz = lines[i].split()
            i += 1
            V[count] = [float(xyz[0]), float(xyz[1]), float(xyz[2])]
            tag2idx[tags[k]] = count
            count += 1
    expect("$Elements")
    header = lines[i].split()
    i += 1
    num_blocks = int(header[0])
    for _ in range(num_blocks):
        blk = lines[i].split()
        i += 1
        etype, n_in_blk = int(blk[2]), int(blk[3])
        for k in range(n_in_blk):
            toks = lines[i].split()
            i += 1
            if etype == 4:  # linear tetrahedron
                tets.append([tag2idx[int(t)] for t in toks[1:5]])
    T = np.asarray(tets, dtype=np.int32).reshape(-1, 4)
    return V, T


def _read_msh_legacy(lines):
    """Gmsh 2.2 ASCII fallback."""
    i = 0
    V = None
    tets = []
    tag2idx = {}
    while i < len(lines):
        s = lines[i].strip()
        if s == "$Nodes":
            i += 1
            n = int(lines[i])
            i += 1
            V = np.zeros((n, 3))
            for k in range(n):
                toks = lines[i].split()
                i += 1
                tag2idx[int(toks[0])] = k
                V[k] = [float(toks[1]), float(toks[2]), float(toks[3])]
        elif s == "$Elements":
            i += 1
            n = int(lines[i])
            i += 1
            for _ in range(n):
                toks = lines[i].split()
                i += 1
                etype = int(toks[1])
                ntags = int(toks[2])
                if etype == 4:
                    vs = toks[3 + ntags : 7 + ntags]
                    tets.append([tag2idx[int(t)] for t in vs])
        else:
            i += 1
    return V, np.asarray(tets, dtype=np.int32).reshape(-1, 4)


def read_obj(path):
    """Read .obj -> (V (n,3) f64, F (m,3) i32). Polygons are fan-triangulated."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "v":
                verts.append([float(toks[1]), float(toks[2]), float(toks[3])])
            elif toks[0] == "f":
                idx = [int(t.split("/")[0]) - 1 for t in toks[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32).reshape(-1, 3)


def read_seg(path):
    """Read a .seg codimensional segment file (reference readSEG,
    IglUtils.cpp): lines `v x y z` then `s i j` (1-based)."""
    verts, segs = [], []
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "v":
                verts.append([float(toks[1]), float(toks[2]), float(toks[3])])
            elif toks[0] == "s":
                segs.append([int(toks[1]) - 1, int(toks[2]) - 1])
    return np.asarray(verts, dtype=np.float64), np.asarray(segs, dtype=np.int32).reshape(-1, 2)


def read_node_ele(prefix):
    """Read TetGen .node/.ele pair (reference readNodeEle, IglUtils.cpp)."""
    with open(prefix + ".node") as f:
        toks = f.readline().split()
        n = int(toks[0])
        V = np.zeros((n, 3))
        first_idx = None
        for k in range(n):
            toks = f.readline().split()
            if first_idx is None:
                first_idx = int(toks[0])
            V[k] = [float(toks[1]), float(toks[2]), float(toks[3])]
    with open(prefix + ".ele") as f:
        toks = f.readline().split()
        m = int(toks[0])
        T = np.zeros((m, 4), dtype=np.int32)
        for k in range(m):
            toks = f.readline().split()
            T[k] = [int(t) - first_idx for t in toks[1:5]]
    return V, T


def write_obj(path, V, F=None):
    with open(path, "w") as f:
        for v in np.asarray(V):
            f.write(f"v {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        if F is not None:
            for t in np.asarray(F):
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def write_seg(path, V, E):
    with open(path, "w") as f:
        for v in np.asarray(V):
            f.write(f"v {v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        for e in np.asarray(E):
            f.write(f"s {e[0] + 1} {e[1] + 1}\n")


def write_msh(path, V, T):
    """Write Gmsh 4.1 ASCII (mirrors the reference's saveAsMesh output role)."""
    V = np.asarray(V)
    T = np.asarray(T)
    with open(path, "w") as f:
        f.write("$MeshFormat\n4.1 0 8\n$EndMeshFormat\n$Nodes\n")
        f.write(f"1 {len(V)} 1 {len(V)}\n")
        f.write(f"3 0 0 {len(V)}\n")
        for i in range(len(V)):
            f.write(f"{i + 1}\n")
        for v in V:
            f.write(f"{v[0]:.17g} {v[1]:.17g} {v[2]:.17g}\n")
        f.write("$EndNodes\n$Elements\n")
        f.write(f"1 {len(T)} 1 {len(T)}\n")
        f.write(f"3 0 4 {len(T)}\n")
        for i, t in enumerate(T):
            f.write(f"{i + 1} {t[0] + 1} {t[1] + 1} {t[2] + 1} {t[3] + 1}\n")
        f.write("$EndElements\n")
