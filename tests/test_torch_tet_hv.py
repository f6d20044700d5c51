"""The per-tet Hessian-vector product: plain version and CUDA kernel.

`tet_hv_reference` against the JAX package's jnp route for the same product
(jit_step.py:471-474: v[tets] -> einsum -> make_gather_sum), in float64 to
1e-13 of the largest entry, with DBC-masked rows of v. The kernel-vs-plain
case needs a card (marker `cuda`) and skips here: it holds the kernel to
the plain version at 1e-5 (f32) / 1e-12 (f64) of the largest entry, since
the two sum in different orders, and requires bitwise-equal repeats.

The module imports no JAX at top level, so the card case runs where only
PyTorch is installed: python -m pytest --noconftest -m cuda tests/test_torch_tet_hv.py
"""

import numpy as np
import pytest
import torch

from ipc_tpu_torch.ops.tet_hv import make_tet_hv_table, tet_hv, tet_hv_reference
from ipc_tpu_torch.scenes import build_scene


def _problem(n_cells, dtype, seed=0, device="cpu", extra_vertex=False):
    """Scene topology, random SPD-like H (T,12,12) and v (V,3) with DBC rows
    of v zeroed; optionally one isolated vertex that no tet touches."""
    st = build_scene(n_cells, dtype, "cpu")
    tets = st.mesh.tets.numpy()
    n_verts = st.mesh.x_rest.shape[0] + (1 if extra_vertex else 0)
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(tets.shape[0], 12, 12))
    H = M @ np.swapaxes(M, 1, 2) / 12.0
    v = rng.normal(size=(n_verts, 3))
    dbc = rng.uniform(size=n_verts) < 0.2
    v[dbc] = 0.0
    table = make_tet_hv_table(tets, n_verts, device)
    conv = lambda a: torch.as_tensor(a, device=device).to(dtype)
    return tets, H, v, table, conv(H), conv(v)


def test_reference_matches_jax_route():
    jnp = pytest.importorskip("jax.numpy")
    from ipc_tpu.ops.scatter import make_gather_sum as j_gather_sum

    tets, H, v, table, Ht, vt = _problem(2, torch.float64, extra_vertex=True)
    n_verts = v.shape[0]
    gsum = j_gather_sum(tets.reshape(-1), n_verts)
    v4 = jnp.asarray(v)[jnp.asarray(tets)].reshape(-1, 12)
    ref = np.asarray(gsum(jnp.einsum("cij,cj->ci", jnp.asarray(H), v4).reshape(-1, 3)))
    got = tet_hv_reference(Ht, table.tets, vt, table.gsum).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())
    assert np.all(got[-1] == 0.0)  # the isolated vertex


def test_cpu_wrapper_takes_plain_version():
    _, _, _, table, Ht, vt = _problem(2, torch.float64, seed=1)
    before = tet_hv.launches
    out = tet_hv(Ht, vt, table)
    assert torch.equal(out, tet_hv_reference(Ht, table.tets, vt, table.gsum))
    assert tet_hv.launches == before  # only kernel launches count


def test_table_layout():
    tets, _, v, table, _, _ = _problem(2, torch.float64, extra_vertex=True)
    inc = table.inc.numpy()
    n_rows = tets.size
    assert table.inc.dtype == torch.int32 and table.tets32.dtype == torch.int32
    flat = inc[inc < n_rows]
    assert np.array_equal(np.sort(flat), np.arange(n_rows))  # each incidence once
    for vert in range(v.shape[0]):
        row = inc[vert]
        real = row[row < n_rows]
        assert np.all(np.diff(real) > 0)  # fixed ascending order
        assert np.all(row[len(real):] == n_rows)  # padding at the end
        assert np.all(tets.reshape(-1)[real] == vert)


def test_wrapper_rejects_bad_inputs():
    _, _, _, table, Ht, vt = _problem(2, torch.float64)
    with pytest.raises(ValueError):
        tet_hv(Ht[:-1], vt, table)
    with pytest.raises(TypeError):
        tet_hv(Ht.float(), vt, table)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tet_hv kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_kernel_matches_plain(cuda_device, dtype, rel_tol):
    _, _, _, table, Ht, vt = _problem(4, dtype, seed=2, device=cuda_device,
                                      extra_vertex=True)
    before = tet_hv.launches
    out = tet_hv(Ht, vt, table)
    again = tet_hv(Ht, vt, table)
    torch.cuda.synchronize()
    assert tet_hv.launches == before + 2
    plain = tet_hv_reference(Ht, table.tets, vt, table.gsum)
    err = (out - plain).abs().max().item()
    assert err <= rel_tol * plain.abs().max().item()
    assert torch.equal(out, again)
    assert torch.all(out[-1] == 0)
