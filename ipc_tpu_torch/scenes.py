"""Procedural scenes: the counterpart of __graft_entry__._build_scene.

Two Neo-Hookean `box_grid` boxes (n_cells^3 cells, 6 tets per cell) under
backward Euler, one resting 0.01 above the ground half-space and one 1.2
above it, with friction 0.1 against the ground — the 2cubesFall tutorial
family, and the scene bench.py runs.
"""

import numpy as np

from ipc_tpu.models.primitives import box_grid  # numpy only, no jax
from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
from ipc_tpu_torch.device import as_dtype
from ipc_tpu_torch.mesh import build_mesh, merge_meshes
from ipc_tpu_torch.timestepper import IPCStepper, SimParams

__all__ = ["build_scene"]


def build_scene(n_cells=6, dtype="float32", device="cpu", with_contact=False):
    """IPCStepper of the two-box ground-contact scene on `device`.

    with_contact=True (self-contact between the boxes, the bench scene)
    arrives with slice 2 and raises NotImplementedError until then."""
    if with_contact:
        raise NotImplementedError(
            "self-contact (with_contact=True) arrives with slice 2 of the port")
    V1, T1 = box_grid(n_cells, n_cells, n_cells)
    V1 = V1 + np.array([0.0, 0.01, 0.0])
    V2, T2 = box_grid(n_cells, n_cells, n_cells)
    V2 = V2 + np.array([0.0, 1.2, 0.0])
    V, T, comp, ranges = merge_meshes([(V1, T1), (V2, T2)])
    mesh, meta = build_mesh(V, T, vert_comp=comp, comp_ranges=ranges,
                            dtype=as_dtype(dtype), device=device)
    halfspaces = [HalfSpace(HalfSpaceParams(friction=0.1))]
    return IPCStepper(mesh, meta, SimParams(), halfspaces=halfspaces)
