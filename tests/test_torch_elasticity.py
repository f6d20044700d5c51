"""Port parity, mesh + elasticity: ipc_tpu_torch against ipc_tpu in float64.

build_mesh: every field equal exactly (index fields) or to 1e-15 (floats:
the same numpy host code). NH and FCR energy, gradient, SPD-projected
12x12 blocks and the inversion step bound on a randomly deformed
box_grid(2,2,2): rtol 1e-10 (the chain of 3x3 SVD, 9x9 and 12x12 products
sums in library order on each side).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ipc_tpu.energy import elasticity as JEL
from ipc_tpu.mesh import build_mesh as j_build_mesh, merge_meshes as j_merge
from ipc_tpu.models.primitives import box_grid
from ipc_tpu.ops.scatter import make_gather_sum as j_gather_sum
from ipc_tpu_torch.convert import mesh_from_numpy
from ipc_tpu_torch.energy import elasticity as TEL
from ipc_tpu_torch.mesh import MESH_FIELDS, build_mesh as t_build_mesh, merge_meshes as t_merge
from ipc_tpu_torch.ops.scatter import make_gather_sum as t_gather_sum

RTOL = 1e-10


def _two_boxes():
    V1, T1 = box_grid(2, 2, 2)
    V2, T2 = box_grid(2, 3, 2, origin=(0.1, 1.3, -0.2))
    return [(V1, T1), (V2, T2)]


@pytest.fixture(scope="module")
def meshes():
    V, T, comp, ranges = j_merge(_two_boxes())
    jm, jmeta = j_build_mesh(V, T, vert_comp=comp, comp_ranges=ranges, dtype=np.float64)
    V2, T2, comp2, ranges2 = t_merge(_two_boxes())
    tm, tmeta = t_build_mesh(V2, T2, vert_comp=comp2, comp_ranges=ranges2,
                             dtype=torch.float64, device="cpu")
    return jm, jmeta, tm, tmeta


def test_build_mesh_parity(meshes):
    jm, jmeta, tm, tmeta = meshes
    for name in MESH_FIELDS:
        ref = np.asarray(getattr(jm, name))
        got = getattr(tm, name).numpy()
        assert got.shape == ref.shape, name
        if np.issubdtype(ref.dtype, np.floating):
            np.testing.assert_allclose(got, ref, rtol=1e-15, atol=1e-15, err_msg=name)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
    for key in ("n_verts", "n_tets", "bbox_diag2", "avg_edge_len", "avg_node_mass",
                "comp_ranges"):
        assert getattr(tmeta, key) == getattr(jmeta, key), key
    # the converter rebuilds the same mesh from the JAX arrays
    conv = mesh_from_numpy({n: np.asarray(getattr(jm, n)) for n in MESH_FIELDS}, "cpu")
    for name in MESH_FIELDS:
        assert torch.equal(getattr(conv, name), getattr(tm, name)), name


def _deformed(meshes, seed=0, scale=0.05):
    jm, _, tm, _ = meshes
    rng = np.random.default_rng(seed)
    x0 = np.asarray(jm.x_rest)
    x = x0 + scale * rng.normal(size=x0.shape)
    p = 0.2 * rng.normal(size=x0.shape)
    return jm, tm, x, p


@pytest.mark.parametrize("model", ["NH", "FCR"])
def test_energy_gradient(meshes, model):
    jm, tm, x, _ = _deformed(meshes)
    xt = torch.as_tensor(x)
    ref_e = np.asarray(JEL.elasticity_energy_per_elem(jnp.asarray(x), jm, model))
    np.testing.assert_allclose(TEL.elasticity_energy_per_elem(xt, tm, model).numpy(),
                               ref_e, rtol=RTOL, atol=1e-12 * np.abs(ref_e).max())
    nV = x.shape[0]
    jg = j_gather_sum(np.asarray(jm.tets).reshape(-1), nV)
    tg = t_gather_sum(tm.tets.numpy().reshape(-1), nV)
    ref_g = np.asarray(JEL.elasticity_gradient(jnp.asarray(x), jm, model, vert_sum=jg))
    got_g = TEL.elasticity_gradient(xt, tm, model, vert_sum=tg).numpy()
    np.testing.assert_allclose(got_g, ref_g, rtol=RTOL, atol=1e-12 * np.abs(ref_g).max())
    # the scatter-add form of the JAX package sums the same rows
    ref_s = np.asarray(JEL.elasticity_gradient(jnp.asarray(x), jm, model))
    np.testing.assert_allclose(got_g, ref_s, rtol=RTOL, atol=1e-12 * np.abs(ref_g).max())


@pytest.mark.parametrize("model", ["NH", "FCR"])
@pytest.mark.parametrize("project", [True, False])
def test_hessian_blocks(meshes, model, project):
    jm, tm, x, _ = _deformed(meshes, seed=1, scale=0.08)
    ref = np.asarray(JEL.elasticity_hessian_blocks(jnp.asarray(x), jm, model, project))
    got = TEL.elasticity_hessian_blocks(torch.as_tensor(x), tm, model, project).numpy()
    assert got.shape == (tm.tets.shape[0], 12, 12)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-12 * np.abs(ref).max())
    if project:
        assert np.linalg.eigvalsh(got).min() > -1e-8 * np.abs(got).max()


@pytest.mark.parametrize("model", ["NH", "FCR"])
def test_filter_step_size(meshes, model):
    jm, tm, x, p = _deformed(meshes, seed=2)
    ref = float(JEL.filter_step_size(jnp.asarray(x), jnp.asarray(p), jm, model))
    got = float(TEL.filter_step_size(torch.as_tensor(x), torch.as_tensor(p), tm, model))
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    if model == "NH":
        assert got < 1.0  # the random direction inverts some tet within [0, 1]
