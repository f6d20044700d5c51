"""The port's scene inputs: its own mesh primitives and its default device.

* `ipc_tpu_torch.models.primitives` is the port's copy of
  `ipc_tpu.models.primitives` (the port imports nothing of the JAX
  package): vertices and tets equal exactly on a few shapes.
* The entry points (`build_scene`, `build_mesh`, `mesh_from_numpy`,
  `state_from_numpy`) run on the card unless the caller passes "cpu": with
  no device given and no card they raise RuntimeError.
"""

import numpy as np
import pytest
import torch

from ipc_tpu.models import primitives as JP
from ipc_tpu_torch.convert import mesh_from_numpy, state_from_numpy
from ipc_tpu_torch.device import resolve_device
from ipc_tpu_torch.mesh import MESH_FIELDS, build_mesh, mesh_arrays
from ipc_tpu_torch.models import primitives as TP
from ipc_tpu_torch.scenes import build_scene


@pytest.mark.parametrize("name,args,kwargs", [
    ("box_grid", (1, 1, 1), {}),
    ("box_grid", (3, 2, 4), dict(size=(2.0, 0.5, 1.5), origin=(0.1, -0.2, 0.3))),
    ("cube", (2,), dict(size=0.5)),
    ("mat", (4,), dict(thickness_cells=2)),
    ("rod", (5,), {}),
])
def test_primitives_equal_the_jax_package(name, args, kwargs):
    V_ref, T_ref = getattr(JP, name)(*args, **kwargs)
    V, T = getattr(TP, name)(*args, **kwargs)
    assert V.dtype == V_ref.dtype and T.dtype == T_ref.dtype
    np.testing.assert_array_equal(V, V_ref)
    np.testing.assert_array_equal(T, T_ref)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would be the card")


def _state_arrays(n=4):
    z = np.zeros((n, 3))
    return dict(x=z, x_prev=z, v=z, a=z)


ENTRY_POINTS = {
    "build_scene": lambda: build_scene(1),
    "build_mesh": lambda: build_mesh(*TP.cube(1)),
    "mesh_from_numpy": lambda: mesh_from_numpy(mesh_arrays(*TP.cube(1))[0]),
    "state_from_numpy": lambda: state_from_numpy(_state_arrays()),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()


def test_cpu_is_asked_for_explicitly():
    assert resolve_device("cpu") == torch.device("cpu")
    st = build_scene(1, torch.float64, "cpu")
    assert st.mesh.x_rest.device.type == "cpu"
    m = mesh_from_numpy(mesh_arrays(*TP.cube(1))[0], "cpu")
    assert all(getattr(m, f).device.type == "cpu" for f in MESH_FIELDS)
    s = state_from_numpy(_state_arrays(), "cpu")
    assert s.x.device.type == "cpu" and s.x.dtype == torch.float64
