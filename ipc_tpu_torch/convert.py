"""Carry meshes and states between the JAX package and the port as numpy.

The JAX package's MeshData / SimState fields go through numpy arrays
(`np.asarray(field)`) so both packages can start from the same state, the
device-script state `aux` (a dict of arrays, or None) included.
"""

import numpy as np
import torch

from ipc_tpu_torch.device import as_dtype, resolve_device
from ipc_tpu_torch.mesh import MESH_FIELDS, mesh_from_arrays
from ipc_tpu_torch.timestepper import SimState

__all__ = ["mesh_from_numpy", "state_from_numpy", "state_to_numpy"]

STATE_ARRAYS = ("x", "x_prev", "v", "a")


def mesh_from_numpy(arrays, device=None, dtype=torch.float64):
    """MeshData from a dict of numpy arrays named like its fields (the JAX
    MeshData fields), on `device` (the card when None, "cpu" for the CPU)."""
    missing = [n for n in MESH_FIELDS if n not in arrays]
    if missing:
        raise KeyError(f"mesh arrays lack {missing}")
    return mesh_from_arrays(arrays, resolve_device(device), as_dtype(dtype))


def _aux_tensor(a, device, dtype):
    a = np.asarray(a)
    if a.dtype == bool:
        return torch.as_tensor(np.array(a), device=device)
    return torch.as_tensor(np.array(a, np.float64), device=device).to(dtype)


def state_from_numpy(arrays, device=None, dtype=torch.float64):
    """SimState from a dict with x, x_prev, v, a ((V,3) arrays) and
    optionally t, step and aux (a dict of arrays: floats are cast to
    `dtype`, bool arrays stay bool), on `device` (the card when None, "cpu"
    for the CPU)."""
    dtype = as_dtype(dtype)
    device = resolve_device(device)
    conv = {k: torch.as_tensor(np.array(arrays[k], np.float64), device=device).to(dtype)
            for k in STATE_ARRAYS}
    aux = arrays.get("aux")
    if aux is not None:
        aux = {k: _aux_tensor(v, device, dtype) for k, v in aux.items()}
    return SimState(**conv, t=float(np.asarray(arrays.get("t", 0.0))),
                    step=int(np.asarray(arrays.get("step", 0))), aux=aux)


def state_to_numpy(state):
    """dict of numpy arrays (x, x_prev, v, a), host t and step, and aux (a
    dict of numpy arrays, or None)."""
    out = {k: getattr(state, k).detach().cpu().numpy() for k in STATE_ARRAYS}
    out["t"] = float(state.t)
    out["step"] = int(state.step)
    out["aux"] = (None if state.aux is None
                  else {k: v.detach().cpu().numpy() for k, v in state.aux.items()})
    return out
