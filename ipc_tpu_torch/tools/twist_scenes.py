"""Scene files of the paper's mat twist with scenes/matTwist20.txt's
settings, over meshes written from models/primitives.mat(n):

    python -m ipc_tpu_torch.tools.twist_scenes DIR 40 100 150 225

writes DIR/matTwist{n}.txt and DIR/input/tetMeshes/mat{n}x{n}.msh for each
n (6 n^2 tets: 9,600 / 60,000 / 135,000 / 303,750 for the paper's
scalability sizes). The scene names its mesh as the reference's paper
scenes do (`input/tetMeshes/...`, resolved from the scene's folder), so
paper_battery's asset check and its --route mesh bytes find it.
"""

import argparse
import os

__all__ = ["TWIST_SCENE", "write_twist_scene"]

# scenes/matTwist20.txt with the mesh path relative to the scene's folder:
# NH, backward Euler, dt 0.04, no gravity, self-contact on (the default),
# Newton tolerance 1e-2 (rel_gl2_tol 1e-4)
TWIST_SCENE = """shapes input 1
{mesh} 0 0 0  90 0 0  1 1 1

script twist
energy NH
timeIntegration BE
warmStart 0
size 1.0
time 100 0.04
density 1000
stiffness 2e4 0.4
turnOffGravity
tol 1
1e-2
"""


def write_twist_scene(folder, n, name=None):
    """Write `folder/<name>` (default matTwist{n}.txt) and its mesh
    `folder/input/tetMeshes/mat{n}x{n}.msh` (mat(n)); returns the scene
    path. The mesh is written once per folder and size."""
    from ipc_tpu_torch import io_mesh
    from ipc_tpu_torch.models.primitives import mat

    mesh = f"input/tetMeshes/mat{n}x{n}.msh"
    mesh_path = os.path.join(folder, mesh)
    if not os.path.exists(mesh_path):
        os.makedirs(os.path.dirname(mesh_path), exist_ok=True)
        V, T = mat(n, size=1.0)
        tmp = f"{mesh_path}.{os.getpid()}.tmp"
        io_mesh.write_msh(tmp, V, T)
        os.replace(tmp, mesh_path)
    scene = os.path.join(folder, name or f"matTwist{n}.txt")
    with open(scene, "w") as f:
        f.write(TWIST_SCENE.format(mesh=mesh))
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("folder")
    ap.add_argument("sizes", nargs="+", type=int, help="mat sizes n (n x n cells)")
    args = ap.parse_args(argv)
    for n in args.sizes:
        print(write_twist_scene(args.folder, n), flush=True)


if __name__ == "__main__":
    main()
