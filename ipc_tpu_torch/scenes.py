"""Procedural scenes.

`build_scene`, the counterpart of __graft_entry__._build_scene: two
Neo-Hookean `box_grid` boxes (n_cells^3 cells, 6 tets per cell) under
backward Euler, one resting 0.01 above the ground half-space and one 1.2
above it, with friction 0.1 against the ground and, with_contact=True,
self-contact with friction 0.1 between them — the 2cubesFall tutorial
family, and the scene bench.py runs.

`build_twist_scene`, the paper's mat-twist scalability scene
(scenes/matTwist20.txt; at n = 100 the paper's mat100x100 twist): a thin
mat, n x 1 x n cells of `models.primitives.mat` in place of the .msh
asset, whose two x-border handles turn about the x axis in opposite
senses (script `twist`).
"""

import numpy as np

from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
from ipc_tpu_torch.device import as_dtype, resolve_device
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.mesh import build_mesh, mesh_arrays, merge_meshes
from ipc_tpu_torch.models.primitives import box_grid, mat
from ipc_tpu_torch.scripting import build_script
from ipc_tpu_torch.timestepper import IPCStepper, SimParams

__all__ = ["build_scene", "build_twist_scene"]


def build_scene(n_cells=6, dtype="float32", device=None, with_contact=False):
    """IPCStepper of the two-box scene on `device` (the card when None; pass
    "cpu" for the CPU): ground contact, and self-contact between the boxes
    when with_contact (the bench scene, __graft_entry__._build_scene's
    default)."""
    device = resolve_device(device)
    V1, T1 = box_grid(n_cells, n_cells, n_cells)
    V1 = V1 + np.array([0.0, 0.01, 0.0])
    V2, T2 = box_grid(n_cells, n_cells, n_cells)
    V2 = V2 + np.array([0.0, 1.2, 0.0])
    V, T, comp, ranges = merge_meshes([(V1, T1), (V2, T2)])
    mesh, meta = build_mesh(V, T, vert_comp=comp, comp_ranges=ranges,
                            dtype=as_dtype(dtype), device=device)
    halfspaces = [HalfSpace(HalfSpaceParams(friction=0.1))]
    sc = SelfContact(mesh, meta, friction=0.1) if with_contact else None
    return IPCStepper(mesh, meta, SimParams(), halfspaces=halfspaces, self_contact=sc)


def build_twist_scene(n=100, dtype="float32", device=None):
    """IPCStepper of the mat-twist scene on `device` (the card when None;
    pass "cpu" for the CPU): `mat(n)` (6 n^2 tets; at n = 100 60,000 tets,
    20,402 vertices, 40,800 surface triangles), script `twist` with
    handle_ratio 0.01 (each border handle turns at 0.4 pi rad/s about the
    bbox centre's x axis, the two in opposite senses), Neo-Hookean, backward
    Euler, dt 0.04, density 1000, E 2e4, nu 0.4, no gravity, rel_gl2_tol
    1e-4 (matTwist20.txt's `tol 1e-2`, squared), self-contact without
    friction, no half-space.

    The config also turns the mesh 90 degrees about x. A rotation about the
    twist axis changes nothing of the motion without gravity, so the scene
    keeps mat's own orientation, as the JAX package's twist test does."""
    device = resolve_device(device)
    V, T = mat(n, size=1.0)
    surface = np.zeros(len(V), bool)
    surface[mesh_arrays(V, T)[0]["surf_verts"]] = True
    script = build_script("twist", V, surface, [(0, len(V))], handle_ratio=0.01)
    mesh, meta = build_mesh(V, T, density=1000.0, ym=2e4, pr=0.4, dbc_mask=script.dbc_mask(),
                            dtype=as_dtype(dtype), device=device)
    sc = SelfContact(mesh, meta, friction=0.0)
    params = SimParams(dt=0.04, gravity=(0.0, 0.0, 0.0), rel_gl2_tol=1e-4)
    return IPCStepper(mesh, meta, params, self_contact=sc, script=script)
