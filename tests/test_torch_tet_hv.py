"""The per-tet Hessian-vector product: plain version and CUDA kernel.

`tet_hv_reference` against the JAX package's jnp route for the same product
(jit_step.py:471-474: v[tets] -> einsum -> make_gather_sum), in float64 to
1e-13 of the largest entry, with DBC-masked rows of v. On the CPU also the
layout the kernel's two passes share: the (4T,3) rows scratch, row 4t + c,
summed per vertex in the table's order, gives the plain result.

The kernel-vs-plain cases need a card (marker `cuda`) and skip here: they
hold the kernel to the plain version at 1e-5 (f32) / 1e-12 (f64) of the
largest entry, since the two sum in different orders, and require
bitwise-equal repeats, on shapes that stress the tiling of pass A (32 tets
a tile in f32, 16 in f64; a two-stage ring in each block): a tet count
that is not a multiple of the tile, fewer tets than one tile, one tet,
enough tiles that each persistent block wraps its ring, and a vertex in 40
tets (pass B holds 32 indices in registers); every case has an isolated
vertex.

The module imports no JAX at top level, so the card case runs where only
PyTorch is installed: python -m pytest --noconftest -m cuda tests/test_torch_tet_hv.py
"""

import numpy as np
import pytest
import torch

from ipc_tpu_torch.hv_timing import assemble_csr, hv_bound
from ipc_tpu_torch.models.primitives import box_grid
from ipc_tpu_torch.ops.tet_hv import (_launch_args, device_launches, make_tet_hv_table,
                                      tet_hv, tet_hv_reference, tet_rows_reference)
from ipc_tpu_torch.scenes import build_scene
from ipc_tpu_torch.utils import observability as obs

# tet topologies for the kernel cases: (tets, n_verts) builders
SHAPES = {
    "scene_n4": lambda: _scene_tets(4),                 # 768 tets: whole tiles
    "ragged_tile": lambda: _grid_tets(3, 2, 5),         # 180 tets
    "under_one_tile": lambda: _grid_tets(1, 1, 2),      # 12 tets
    "one_tet": lambda: (np.array([[0, 1, 2, 3]]), 4),
    # vertex 0 in 40 tets: pass B's indices beyond the 32 it holds in registers
    "degree_40": lambda: (np.array([[0, 3 * i + 1, 3 * i + 2, 3 * i + 3] for i in range(40)]), 121),
    "ring_wraps": lambda: _scene_tets(16),              # 49,152 tets
    # a sharded step's rank: its half of the padded tets over every vertex
    "rank_shard": lambda: _shard_tets(4, 0),             # 384 tets
}


def _shard_tets(n_cells, rank, world=2):
    """Rank's tets of the scene padded for `world` ranks (parallel/
    sharding.py), over the padded mesh's vertices."""
    from ipc_tpu_torch.parallel.sharding import shard_mesh_data

    padded, rows = shard_mesh_data(build_scene(n_cells, torch.float64, "cpu").mesh, world, rank)
    return padded.tets.numpy()[slice(*rows["tets"])], int(padded.x_rest.shape[0])


def _scene_tets(n_cells):
    st = build_scene(n_cells, torch.float64, "cpu")
    return st.mesh.tets.numpy(), st.mesh.x_rest.shape[0]


def _grid_tets(nx, ny, nz):
    V, T = box_grid(nx, ny, nz)
    return T.astype(np.int64), V.shape[0]


def _problem(n_cells, dtype, seed=0, device="cpu", extra_vertex=False, topology=None):
    """Scene topology (or `topology` = (tets, n_verts)), random SPD-like H
    (T,12,12) and v (V,3) with DBC rows of v zeroed; optionally one isolated
    vertex that no tet touches."""
    tets, n_verts = topology if topology is not None else _scene_tets(n_cells)
    n_verts += 1 if extra_vertex else 0
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
    before = obs.counter("tet_hv.launches")
    out = tet_hv(Ht, vt, table)
    assert torch.equal(out, tet_hv_reference(Ht, table.tets, vt, table.gsum))
    assert obs.counter("tet_hv.launches") == before  # only kernel launches count


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


def test_two_pass_layout():
    """The rows scratch the wrapper hands the kernel is (4T,3) like H, and
    pass B's walk over it (row inc[v,d], component k, in the table's order)
    reproduces the plain result."""
    tets, H, v, table, Ht, vt = _problem(2, torch.float64, seed=3, extra_vertex=True)
    (n_tets, n_verts, D), rows = _launch_args(Ht, vt, table)
    assert (n_tets, n_verts, D) == (tets.shape[0], v.shape[0], table.inc.shape[1])
    assert rows.shape == (4 * n_tets, 3) and rows.dtype == Ht.dtype
    ref_rows = tet_rows_reference(Ht, table.tets, vt).numpy()
    for t in range(n_tets):  # row 4t + c is corner c of tet t: H_t[3c:3c+3] . v4_t
        np.testing.assert_allclose(ref_rows[4 * t:4 * t + 4].reshape(-1),
                                   H[t] @ v[tets[t]].reshape(-1), rtol=1e-13, atol=1e-13)
    inc = table.inc.numpy()
    walked = np.zeros((n_verts, 3))
    for vert in range(n_verts):
        for i in inc[vert]:
            if i >= 4 * n_tets:
                break
            walked[vert] += ref_rows[i]
    plain = tet_hv(Ht, vt, table).numpy()
    np.testing.assert_allclose(walked, plain, rtol=0, atol=1e-13 * np.abs(plain).max())


def test_launch_args_reject_misaligned():
    _, _, _, table, Ht, vt = _problem(2, torch.float64)
    buf = torch.zeros(Ht.numel() + 1, dtype=torch.float64)
    shifted = buf[1:].view(Ht.shape)  # contiguous, 8 bytes off a 16-byte boundary
    shifted.copy_(Ht)
    with pytest.raises(ValueError, match="aligned"):
        _launch_args(shifted, vt, table)
    _launch_args(Ht, vt, table)  # a fresh tensor passes


def test_yardstick_computes_the_same_map():
    """hv_timing's library yardstick: the assembled CSR matrix times v is
    the plain result (at n_cells=2, 4,014 stored values)."""
    _, _, v, table, Ht, vt = _problem(2, torch.float64, seed=4)
    A = assemble_csr(Ht, table.tets, v.shape[0])
    assert A.layout == torch.sparse_csr and A.values().numel() == 4014
    got = (A @ vt.reshape(-1)).reshape(-1, 3)
    plain = tet_hv_reference(Ht, table.tets, vt, table.gsum)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0,
                               atol=1e-13 * plain.abs().max().item())


@pytest.mark.parametrize("dtype,nbytes,bound_us", [
    (torch.float32, 59_054_640, 17.628),  # 96,000 tets, 18,522 verts, D = 24
    (torch.float64, 114_795_168, 34.267),
])
def test_bound_of_the_main_path_shape(dtype, nbytes, bound_us):
    got_bytes, flops, got_us, by = hv_bound(96_000, 18_522, 24, dtype)
    assert got_bytes == nbytes and flops == 2 * 144 * 96_000 and by == "bytes"
    assert got_us == pytest.approx(bound_us, abs=1e-3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tet_hv kernel runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_kernel_matches_plain(cuda_device, shape, dtype, rel_tol):
    _, _, _, table, Ht, vt = _problem(None, dtype, seed=2, device=cuda_device,
                                      extra_vertex=True, topology=SHAPES[shape]())
    before = obs.counter("tet_hv.launches")
    out = tet_hv(Ht, vt, table)
    again = tet_hv(Ht, vt, table)
    torch.cuda.synchronize()
    assert obs.counter("tet_hv.launches") == before + 2
    plain = tet_hv_reference(Ht, table.tets, vt, table.gsum)
    err = (out - plain).abs().max().item()
    assert err <= rel_tol * plain.abs().max().item()
    assert torch.equal(out, again)
    assert torch.all(out[-1] == 0)


def _tetless_problem(dtype, device="cpu"):
    """The n_cells=4 scene's tets with four tet-less vertices appended (a
    kinematic obstacle's rows: degree 0, their table rows all padding)."""
    tets, n = _scene_tets(4)
    return n, _problem(None, dtype, seed=5, device=device, topology=(tets, n + 4))


@pytest.mark.parametrize("world", [2, 4])
def test_rank_shards_sum_to_the_whole_product(world):
    """Each rank's table covers its own tets over all vertices: the rows
    its tets do not touch are exact zeros, and the ranks' products add up
    to the whole padded mesh's (1e-13 of its largest entry)."""
    from ipc_tpu_torch.parallel.sharding import shard_mesh_data

    padded, _ = shard_mesh_data(build_scene(3, torch.float64, "cpu").mesh, world)
    whole, n_verts = padded.tets.numpy(), int(padded.x_rest.shape[0])
    _, H, v, table, Ht, vt = _problem(None, torch.float64, seed=7, topology=(whole, n_verts))
    ref = tet_hv(Ht, vt, table)
    total = torch.zeros_like(ref)
    T = whole.shape[0]
    for rank in range(world):
        tets, n = _shard_tets(3, rank, world)
        a, b = T * rank // world, T * (rank + 1) // world
        assert n == n_verts and np.array_equal(tets, whole[a:b])
        part = tet_hv(Ht[a:b].contiguous(), vt, make_tet_hv_table(tets, n))
        untouched = np.ones(n, bool)
        untouched[tets.reshape(-1)] = False
        assert untouched.any() and bool((part[torch.as_tensor(untouched)] == 0).all())
        total = total + part
    assert (total - ref).abs().max().item() <= 1e-13 * ref.abs().max().item()


def test_tetless_rows_are_all_padding():
    n, (tets, _, _, table, Ht, vt) = _tetless_problem(torch.float64)
    assert table.n_verts == n + 4
    assert bool((table.inc[n:] == 4 * tets.shape[0]).all())
    out = tet_hv(Ht, vt, table)
    assert bool((out[n:] == 0).all()) and bool(out[:n].abs().max() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
def test_kernel_writes_zeros_for_tetless_vertices(cuda_device, dtype, rel_tol):
    n, (_, _, _, table, Ht, vt) = _tetless_problem(dtype, cuda_device)
    out = tet_hv(Ht, vt, table)
    again = tet_hv(Ht, vt, table)
    plain = tet_hv_reference(Ht, table.tets, vt, table.gsum)
    torch.cuda.synchronize()
    assert torch.all(out[n:] == 0) and torch.equal(out, again)
    err = (out[:n] - plain[:n]).abs().max().item()
    assert err <= rel_tol * plain.abs().max().item()


@pytest.mark.cuda
def test_the_card_counts_its_launches(cuda_device):
    """device_launches reads the kernel's own device counter: one per call,
    and one per replay of a CUDA graph that holds a call."""
    _, _, _, table, Ht, vt = _problem(None, torch.float32, seed=3, device=cuda_device,
                                      topology=SHAPES[sorted(SHAPES)[0]]())
    n0 = device_launches(cuda_device)
    out = tet_hv(Ht, vt, table)
    assert device_launches(cuda_device) == n0 + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tet_hv(Ht, vt, table)  # the warm-up before a capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tet_hv(Ht, vt, table)
    for _ in range(3):
        graph.replay()
    assert device_launches(cuda_device) == n0 + 5
    assert torch.equal(got, out)
