"""The grid broad phase's walk kernel (csrc/grid_pairs.cu) and its routes
(contact/spatial_hash.py).

On the CPU the grid runs its plain version (`_run_plain`): the candidate
pairs of `fused_candidates` and `et_candidates` equal the dense path's
(contact/broadphase.py) element for element, in float32 and float64, on
seeded soups of small triangles along a random walk (adjacent triangles
share vertices, some vertices are DBC), swept and unswept, with `shard=`
(the ranks' sets, in rank order, are the whole set), with big primitives
(a few triangles and edges stretched across the soup, swept densely), and
on the mat twist (n = 8 and 12) under its scripted prologue's sweep. The
wrappers refuse a dtype other than float32 / float64, a device that is
neither the CPU nor CUDA, and arrays of the wrong shape, dtype or device.
Under tracing, `broadphase.calls` counts the grid calls, `broadphase.rows`
the (query cell, target) rows walked and `broadphase.kept` the pairs the
grid kept; `broadphase.kernel_calls` stays 0 and the kernel launches
nothing.

On the card (marker `cuda`; they skip here), float32 and float64: the
kernel's pair arrays equal the plain version's on the same card (both
routes on the same families, grid_timing.compare) on a larger seeded soup,
with big primitives and sharded, on the prologue's sweep of the 225^2 mat
twist (303,750 tets: some 357M rows) and of the 100^2 one, and on the
largest grid call of the landing's step 8 (the boxes at n_cells 20). At
225^2 the kernel route's peak device memory above its inputs stays below
one byte per row walked, so no tensor with an element per row exists.
Over the landing's step, `broadphase.kernel_calls == broadphase.calls`,
the kernel launched once per family of each call (the count pass) and
once more per family that keeps a grid pair (the write pass), and the
broad phase's only host reads were one `broadphase.counts` read per call.
Where a family keeps nothing (two thin triangles crossing, whose
vertices lie far from the other triangle: no point-triangle pair; two
triangles far apart: no pair at all) the grid equals the dense path on the
CPU, and on the card the kernel equals the plain version, with no write
pass for the empty family.

The module imports no JAX, so the card runs it where only PyTorch is
installed: python -m pytest --noconftest -m cuda tests/test_torch_grid_pairs_kernel.py
"""

import math

import numpy as np
import pytest
import torch

from ipc_tpu_torch.contact import broadphase as BP
from ipc_tpu_torch.contact import spatial_hash as SH
from ipc_tpu_torch.grid_timing import compare, launches_of, parts, scene_calls, twist_sweep
from ipc_tpu_torch.utils import observability as obs

DTYPES = [torch.float64, torch.float32]
SOUP_SEEDS = [20261018, 7, 2**31 + 11]


def soup_gap(n_tris):
    """The gap of a soup of n_tris triangles: about a quarter of a step."""
    return 0.25 / math.sqrt(n_tris)


def soup(n_tris, seed, dtype, device="cpu", big=0):
    """A seeded soup: vertices along a random walk in a unit box (steps of
    about 1 / sqrt(n_tris)), triangles (i, i+1, i+2) of it, their unique
    edges, every vertex on the surface, 10% of the vertices DBC, a random
    sweep of about soup_gap(n_tris). With `big`, that many extra triangles
    (and their edges) span the whole soup.
    Returns (x, surf_verts, surf_edges, surf_tris, dbc, disp)."""
    rng = np.random.default_rng(seed)
    V = n_tris + 2
    walk = np.cumsum(rng.normal(scale=0.02, size=(V, 3)), axis=0)
    walk = (walk - walk.min(axis=0)) / max(np.ptp(walk), 1e-9)
    tris = np.stack([np.arange(n_tris), np.arange(1, n_tris + 1), np.arange(2, n_tris + 2)], 1)
    if big:
        far = V + np.arange(3 * big).reshape(big, 3)
        walk = np.concatenate([walk, rng.uniform(-0.2, 1.2, size=(3 * big, 3))])
        tris = np.concatenate([tris, far])
    edges = np.unique(np.sort(np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]],
                                              tris[:, [0, 2]]]), axis=1), axis=0)
    V = walk.shape[0]
    dbc = rng.random(V) < 0.1
    disp = rng.normal(scale=soup_gap(n_tris), size=(V, 3))

    def t(a, dt=None):
        return torch.as_tensor(a, device=device).to(dt) if dt else torch.as_tensor(a, device=device)

    return (t(walk, dtype), t(np.arange(V), torch.int64), t(edges, torch.int64),
            t(tris, torch.int64), t(dbc), t(disp, dtype))


def big_of(surf_edges, surf_tris, n_big):
    """The `big` dict of a soup whose last n_big triangles (and the edges
    among their vertices) are the oversized ones."""
    S, dev = surf_tris.shape[0], surf_tris.device
    tri_mask = torch.zeros(S, dtype=torch.bool, device=dev)
    tri_mask[S - n_big:] = True
    far = surf_tris[S - n_big:].flatten()
    edge_mask = torch.isin(surf_edges, far).all(dim=1)
    return dict(tri_ids=torch.nonzero(tri_mask).flatten(), tri_mask=tri_mask,
                edge_ids=torch.nonzero(edge_mask).flatten(), edge_mask=edge_mask)


def two_triangles(layout, dtype, device="cpu"):
    """Two triangles and their edges, every vertex on the surface, none
    DBC, with a gap of 0.02. "crossing": two thin triangles 2 long, one
    along x and one along y, 0.01 apart in z, their long edges crossing:
    each vertex lies about 1 from the other triangle, so no point-triangle
    pair is kept, while edge-edge and edge-triangle pairs are. "apart": two
    small triangles 10 apart: nothing is kept.
    Returns (x, surf_verts, surf_edges, surf_tris, dbc, disp (None), gap)."""
    if layout == "crossing":
        x = [[-1, 0, 0], [1, 0, 0], [1, 0.02, 0],
             [0.005, -1, 0.01], [0.005, 1, 0.01], [0.025, 1, 0.01]]
    else:
        x = [[0, 0, 0], [0.1, 0, 0], [0, 0.1, 0], [10, 10, 10], [10.1, 10, 10], [10, 10.1, 10]]
    tris = [[0, 1, 2], [3, 4, 5]]
    edges = [[0, 1], [0, 2], [1, 2], [3, 4], [3, 5], [4, 5]]
    i64 = dict(dtype=torch.int64, device=device)
    return (torch.tensor(x, dtype=dtype, device=device), torch.arange(6, **i64),
            torch.tensor(edges, **i64), torch.tensor(tris, **i64),
            torch.zeros(6, dtype=torch.bool, device=device), None, 0.02)


def dense(x, sv, se, st, dbc, disp, gap):
    return dict(pt=BP.pt_candidates(x, sv, st, dbc, disp, gap),
                ee=BP.ee_candidates(x, se, dbc, disp, gap),
                et=BP.et_candidates(x, se, st, disp, gap, dbc))


def assert_same(got, want):
    for k in ("pt", "ee", "et"):
        (a, m), (b, n) = got[k], want[k]
        assert m == n and torch.equal(a, b), (k, m, n)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("seed", SOUP_SEEDS)
@pytest.mark.parametrize("swept", [False, True])
def test_cpu_grid_equals_dense_on_soups(dtype, seed, swept):
    x, sv, se, st, dbc, disp = soup(600, seed, dtype)
    disp = disp if swept else None
    gap = soup_gap(600)
    got = SH.fused_candidates(x, sv, se, st, dbc, disp, gap)
    want = dense(x, sv, se, st, dbc, disp, gap)
    assert all(want[k][1] > 0 for k in want)
    assert_same(got, want)
    et = SH.et_candidates(x, se, st, disp, gap, dbc)
    assert et[1] == want["et"][1] and torch.equal(et[0], want["et"][0])
    no_et = SH.fused_candidates(x, sv, se, st, dbc, disp, gap, with_et=False)
    assert no_et["et"][1] == 0 and torch.equal(no_et["ee"][0], want["ee"][0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("world", [2, 3])
def test_cpu_shards_partition_the_set(dtype, world):
    x, sv, se, st, dbc, disp = soup(600, SOUP_SEEDS[0], dtype)
    gap = soup_gap(600)
    whole = SH.fused_candidates(x, sv, se, st, dbc, disp, gap)
    ranks = [SH.fused_candidates(x, sv, se, st, dbc, disp, gap, shard=(r, world))
             for r in range(world)]
    for k in ("pt", "ee", "et"):
        assert torch.equal(torch.cat([r[k][0] for r in ranks]), whole[k][0])
        assert sum(r[k][1] for r in ranks) == whole[k][1]
    ets = [SH.et_candidates(x, se, st, disp, gap, dbc, shard=(r, world)) for r in range(world)]
    assert torch.equal(torch.cat([e[0] for e in ets]), whole["et"][0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("swept", [False, True])
def test_cpu_grid_with_big_primitives_equals_dense(dtype, swept):
    x, sv, se, st, dbc, disp = soup(600, SOUP_SEEDS[1], dtype, big=3)
    disp = disp if swept else None
    big = big_of(se, st, 3)
    assert int(big["edge_mask"].sum()) == 9
    gap = soup_gap(600)
    got = SH.fused_candidates(x, sv, se, st, dbc, disp, gap, big=big)
    want = dense(x, sv, se, st, dbc, disp, gap)
    assert_same(got, want)
    et = SH.et_candidates(x, se, st, disp, gap, dbc, big=big)
    assert torch.equal(et[0], want["et"][0])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [8, 12])
def test_cpu_grid_on_the_twist_prologue_sweep(dtype, n):
    kind, args, kwargs = twist_sweep(n, dtype, "cpu")
    got = SH.fused_candidates(*args, **kwargs)
    want = dense(*args)
    assert all(want[k][1] > 0 for k in want)
    assert_same(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["crossing", "apart"])
def test_cpu_grid_equals_dense_where_a_family_keeps_nothing(dtype, layout):
    args = two_triangles(layout, dtype)
    got = SH.fused_candidates(*args)
    want = dense(*args)
    kept = [want[k][1] for k in ("pt", "ee", "et")]
    assert kept[0] == 0 and (min(kept[1:]) > 0 if layout == "crossing" else max(kept) == 0)
    assert_same(got, want)
    x, sv, se, st, dbc, disp, gap = args
    et = SH.et_candidates(x, se, st, disp, gap, dbc)
    assert et[1] == want["et"][1] and torch.equal(et[0], want["et"][0])


REFUSED = {
    "float16": (lambda a: [a[0].half()] + a[1:5] + [None], TypeError),
    "integer": (lambda a: [a[0].long()] + a[1:5] + [None], TypeError),
    "meta device": (lambda a: [t.to("meta") if torch.is_tensor(t) else t for t in a], ValueError),
    "two devices": (lambda a: a[:5] + [a[5].to("meta")], ValueError),
    "x (V,2)": (lambda a: [a[0][:, :2]] + a[1:5] + [None], ValueError),
    "triangles (S,2)": (lambda a: a[:3] + [a[3][:, :2]] + a[4:], ValueError),
    "int32 ids": (lambda a: a[:2] + [a[2].int()] + a[3:], ValueError),
    "disp float32": (lambda a: a[:5] + [a[5].float()], ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_wrappers_refuse(case):
    make, err = REFUSED[case]
    args = make(list(soup(50, 1, torch.float64)))
    x, sv, se, st, dbc, disp = args
    with pytest.raises(err):
        SH.fused_candidates(x, sv, se, st, dbc, disp, 0.01)
    with pytest.raises(err):
        SH.et_candidates(x, se, st, disp, 0.01, dbc)


def test_counters_under_tracing_on_the_cpu():
    x, sv, se, st, dbc, disp = soup(600, SOUP_SEEDS[0], torch.float32)
    gap = soup_gap(600)
    call = ("fused", [x, sv, se, st, dbc, disp, gap], {})
    rows = sum(int(f.n.sum()) for f in parts(call)[0])
    off = SH.fused_candidates(x, sv, se, st, dbc, disp, gap)
    launches = SH.grid_pairs.launches
    obs.set_tracing(True)
    try:
        on = SH.fused_candidates(x, sv, se, st, dbc, disp, gap)
        et = SH.et_candidates(x, se, st, disp, gap, dbc)
    finally:
        obs.set_tracing(False)
    assert_same(on, off)
    et_rows = sum(int(f.n.sum()) for f in parts(("et", [x, se, st, disp, gap, dbc], {}))[0])
    c = obs.collect()["counters"]
    assert c["broadphase.calls"] == 2
    assert c["broadphase.rows"] == rows + et_rows > 0
    assert c["broadphase.kept"] == sum(on[k][1] for k in on) + et[1]
    assert c.get("broadphase.kernel_calls", 0) == 0
    assert SH.grid_pairs.launches == launches


# --- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grid's walk kernel runs only on the card")
    return torch.device("cuda")


def _against_plain(call, dtype, label):
    rec = compare(call, dtype)
    print(f"[grid] {label} {dtype}: rows={rec['rows']} kept={rec['kept']} "
          f"equal={rec['equal']}")
    assert rec["equal"]
    return rec


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["plain", "big", "shard"])
def test_kernel_matches_plain_on_a_soup(cuda_device, dtype, variant):
    x, sv, se, st, dbc, disp = soup(60_000, SOUP_SEEDS[2], dtype, cuda_device,
                                    big=3 if variant == "big" else 0)
    kwargs = {}
    if variant == "big":
        kwargs["big"] = big_of(se, st, 3)
    ranks = [(0, 1)] if variant != "shard" else [(r, 3) for r in range(3)]
    for shard in ranks:
        if variant == "shard":
            kwargs["shard"] = shard
        gap = soup_gap(60_000)
        rec = _against_plain(("fused", [x, sv, se, st, dbc, disp, gap], dict(kwargs)), dtype,
                             f"soup {variant} {shard}")
        assert min(rec["kept"]) > 0
        _against_plain(("et", [x, se, st, disp, gap, dbc], dict(kwargs)), dtype,
                       f"soup et {variant} {shard}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [100, 225])
def test_kernel_matches_plain_on_the_twist_sweep(cuda_device, dtype, n):
    call = twist_sweep(n, "float32", cuda_device)
    rec = _against_plain(call, dtype, f"twist {n}")
    if n == 225 and dtype == torch.float32:
        p = parts(call)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        SH._run_kernel(*p)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
        print(f"[grid] twist 225 kernel route: peak {extra} B above its inputs, "
              f"{sum(rec['rows'])} rows")
        assert extra < sum(rec["rows"])


@pytest.mark.cuda
def test_kernel_on_the_landing_step(cuda_device):
    calls, counters = scene_calls("boxes", cuda_device)
    print(f"[grid] landing step 8: {len(calls)} grid calls, counters {counters}")
    assert counters["broadphase.calls"] == counters["broadphase.kernel_calls"] == len(calls) > 0
    assert counters["launches"] == launches_of(calls)
    assert counters["broadphase.rows"] >= counters["broadphase.kept"] > 0
    assert counters["reads"] == {"broadphase.counts": len(calls)}
    call = max(calls, key=lambda c: sum(compare(c)["kept"]))
    for dtype in DTYPES:
        _against_plain(call, dtype, "landing step 8")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["crossing", "apart"])
def test_kernel_matches_plain_where_a_family_keeps_nothing(cuda_device, dtype, layout):
    args = two_triangles(layout, dtype, cuda_device)
    call = ("fused", list(args), {})
    rec = _against_plain(call, dtype, f"two triangles {layout}")
    assert rec["kept"][0] == 0
    launches = SH.grid_pairs.launches
    got = SH.fused_candidates(*args)
    torch.cuda.synchronize()
    # a count pass per family, a write pass only where the grid keeps a pair
    assert SH.grid_pairs.launches - launches == 3 + sum(n > 0 for _, n in got.values())
    assert_same(got, dense(*args))
