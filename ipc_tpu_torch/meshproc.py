"""Mesh processing CLI: generation, conversion, surface extraction.

Port of ipc_tpu/meshproc.py, the analog of the reference's MeshProcessing
sub-project (src/Projects/MeshProcessing/MeshProcessing.cpp: tetgen mode 3
:72, .tet -> .msh mode 19 :106, surface extraction -> .obj mode 20 :131).
Tetgen is an external binary; structured tetrahedralizations of primitive
shapes (box, mat and rod grids) take its place, beside the converters:

    python -m ipc_tpu_torch.meshproc gen box 8 8 8 out.msh [--size 1 1 1]
    python -m ipc_tpu_torch.meshproc gen mat 10 out.msh
    python -m ipc_tpu_torch.meshproc gen rod 10 out.msh
    python -m ipc_tpu_torch.meshproc surf in.msh out.obj     (mode 20)
    python -m ipc_tpu_torch.meshproc info in.msh [--device cpu]  (mode 26 stats)
    python -m ipc_tpu_torch.meshproc nodele2msh prefix out.msh

A host-side tool: numpy and the port's io_mesh / models / mesh modules.
`info` builds the mesh (volumes, surface) on the card, as every entry
point of the port runs, unless `--device` names another device.
"""

import sys

import numpy as np

__all__ = ["main"]


def cmd_gen(args):
    from ipc_tpu_torch.io_mesh import write_msh
    from ipc_tpu_torch.models import primitives as P

    kind = args[0]
    if kind == "box":
        nx, ny, nz = int(args[1]), int(args[2]), int(args[3])
        out = args[4]
        size = (1.0, 1.0, 1.0)
        if "--size" in args:
            i = args.index("--size")
            size = tuple(float(v) for v in args[i + 1:i + 4])
        V, T = P.box_grid(nx, ny, nz, size)
    elif kind == "mat":
        out = args[2]
        V, T = P.mat(int(args[1]))
    elif kind == "rod":
        out = args[2]
        V, T = P.rod(int(args[1]))
    else:
        raise SystemExit(f"unknown shape {kind}")
    write_msh(out, V, T)
    print(f"wrote {out}: {len(V)} verts, {len(T)} tets")


def cmd_surf(args):
    from ipc_tpu_torch.io_mesh import read_msh, write_obj
    from ipc_tpu_torch.mesh import _boundary_faces

    V, T = read_msh(args[0])
    F = _boundary_faces(np.asarray(T, np.int64))
    used = np.unique(F.reshape(-1))
    remap = -np.ones(len(V), np.int64)
    remap[used] = np.arange(len(used))
    write_obj(args[1], V[used], remap[F])
    print(f"wrote {args[1]}: {len(used)} verts, {len(F)} faces")


def cmd_info(args):
    from ipc_tpu_torch.device import resolve_device
    from ipc_tpu_torch.io_mesh import read_msh
    from ipc_tpu_torch.mesh import build_mesh

    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1]
        args = args[:i] + args[i + 2:]
    V, T = read_msh(args[0])
    mesh, meta = build_mesh(V, T, device=resolve_device(device))
    print(f"verts {meta.n_verts}  tets {meta.n_tets}")
    print(f"surface tris {mesh.surf_tris.shape[0]}  edges {mesh.surf_edges.shape[0]}"
          f"  verts {mesh.surf_verts.shape[0]}")
    print(f"bbox {meta.bbox[0]} .. {meta.bbox[1]}")
    print(f"avg edge len {meta.avg_edge_len:.6g}  total volume "
          f"{float(mesh.vol.sum()):.6g}")


def cmd_nodele2msh(args):
    from ipc_tpu_torch.io_mesh import read_node_ele, write_msh

    V, T = read_node_ele(args[0])
    write_msh(args[1], V, T)
    print(f"wrote {args[1]}: {len(V)} verts, {len(T)} tets")


COMMANDS = dict(gen=cmd_gen, surf=cmd_surf, info=cmd_info, nodele2msh=cmd_nodele2msh)


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 0
    fn = COMMANDS.get(argv[0])
    if fn is None:
        print(f"unknown command {argv[0]}; commands: {', '.join(COMMANDS)}")
        return 2
    fn(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
