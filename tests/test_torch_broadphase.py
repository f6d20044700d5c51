"""Port parity: the broad phase (ipc_tpu_torch.contact.broadphase and
.spatial_hash) against the JAX package's.

Scenes are the two-box bench scene at small sizes (`scenes.build_scene`);
both packages get the same numpy positions, topology and seeded
displacements. The dense path must give JAX's pairs exactly, order
included (`torch.nonzero` and `jnp.nonzero` are both row-major). The grid
path is held to the candidate SET: equal to the port's dense set and to
JAX's `spatial_hash.fused_candidates` set (whose fixed-K bucket table is
checked not to overflow), at n_cells 4 and 8, static and swept, gaps 0
and sqrt(dHat).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu.contact import broadphase as JBP
from ipc_tpu.contact import spatial_hash as JSH
from ipc_tpu_torch.contact import broadphase as BP
from ipc_tpu_torch.contact import spatial_hash as SH
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.scenes import build_scene

K_BUCKET = 256  # JAX grid bucket capacity for these scenes (checked below)


def _scene(n_cells):
    st = build_scene(n_cells, torch.float64, "cpu")
    m = st.mesh
    arrays = dict(x=m.x_rest.numpy(), sv=m.surf_verts.numpy(), se=m.surf_edges.numpy(),
                  sf=m.surf_tris.numpy(), dbc=m.dbc_mask.numpy())
    return st, arrays


def _disp(arrays, swept, seed=0):
    if not swept:
        return None
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.02, size=arrays["x"].shape)


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _pairset(pairs):
    p = np.asarray(pairs)
    return set(map(tuple, p[p[:, 0] >= 0].tolist()))


def _port_dense(a, disp, gap):
    x, d = _t(a["x"]), _t(disp)
    sv, se, sf, dbc = (torch.as_tensor(a[k]) for k in ("sv", "se", "sf", "dbc"))
    return dict(pt=BP.pt_candidates(x, sv, sf, dbc, d, gap)[0],
                ee=BP.ee_candidates(x, se, dbc, d, gap)[0],
                et=BP.et_candidates(x, se, sf, d, gap, dbc)[0])


def _port_grid(a, disp, gap):
    sv, se, sf, dbc = (torch.as_tensor(a[k]) for k in ("sv", "se", "sf", "dbc"))
    out = SH.fused_candidates(_t(a["x"]), sv, se, sf, dbc, _t(disp), gap, with_et=True)
    return {k: out[k][0] for k in ("pt", "ee", "et")}


@pytest.mark.parametrize("swept", [False, True])
@pytest.mark.parametrize("gap_kind", ["zero", "sqrt_dhat"])
def test_dense_pairs_equal_jax_in_order(swept, gap_kind):
    st, a = _scene(2)
    gap = 0.0 if gap_kind == "zero" else float(np.sqrt(st.dHat))
    disp = _disp(a, swept)
    got = _port_dense(a, disp, gap)
    x, d = jnp.asarray(a["x"]), _j(disp)
    sv, se, sf, dbc = (jnp.asarray(a[k]) for k in ("sv", "se", "sf", "dbc"))
    cap = 20000
    ref = dict(pt=JBP.pt_candidates(x, sv, sf, dbc, cap, d, gap),
               ee=JBP.ee_candidates(x, se, dbc, cap, d, gap),
               et=JBP.et_candidates(x, se, sf, cap, d, gap, dbc))
    for k in ("pt", "ee", "et"):
        pairs, n = ref[k]
        n = int(n)
        assert n < cap and n > 0
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(pairs)[:n], err_msg=k)


@pytest.fixture(scope="module")
def jax_fused():
    return jax.jit(JSH.fused_candidates, static_argnames=("cap_pt", "cap_ee", "cap_et", "K",
                                                          "with_et"))


@pytest.mark.parametrize("n_cells", [4, 8])
@pytest.mark.parametrize("swept", [False, True])
@pytest.mark.parametrize("gap_kind", ["zero", "sqrt_dhat"])
def test_grid_sets_equal_dense_and_jax(jax_fused, n_cells, swept, gap_kind):
    st, a = _scene(n_cells)
    gap = 0.0 if gap_kind == "zero" else float(np.sqrt(st.dHat))
    disp = _disp(a, swept, seed=n_cells)
    grid = _port_grid(a, disp, gap)
    dense = _port_dense(a, disp, gap)
    sizes = {k: int(v.shape[0]) for k, v in grid.items()}
    caps = {k: 2 * n + 64 for k, n in sizes.items()}
    ref = jax_fused(jnp.asarray(a["x"]), jnp.asarray(a["sv"]), jnp.asarray(a["se"]),
                    jnp.asarray(a["sf"]), jnp.asarray(a["dbc"]), cap_pt=caps["pt"],
                    cap_ee=caps["ee"], cap_et=caps["et"], disp=_j(disp), gap=gap,
                    K=K_BUCKET, with_et=True)
    assert int(ref["overflow"]) <= K_BUCKET  # no JAX bucket truncated
    for k in ("pt", "ee", "et"):
        assert sizes[k] > 0
        assert _pairset(grid[k]) == _pairset(dense[k]), k
        assert int(ref[k][1]) == sizes[k], k
        assert _pairset(grid[k]) == _pairset(ref[k][0]), k
        # the port's grid also returns the dense path's order
        np.testing.assert_array_equal(grid[k].numpy(), dense[k].numpy())


def test_nonfinite_boxes_register_nowhere():
    """One NaN vertex: its primitives register nowhere and query nothing,
    the grid's cell and origin come from the finite boxes alone, and every
    pair of finite primitives is still found. A NaN sweep empties the
    sets."""
    st, a = _scene(4)
    gap = float(np.sqrt(st.dHat))
    base = _port_grid(a, None, gap)
    sv, se, sf = a["sv"], a["se"], a["sf"]
    bad_v = int(sv[0])
    xb = a["x"].copy()
    xb[bad_v] = np.nan
    got = _port_grid(dict(a, x=xb), None, gap)
    bad = dict(pt=(np.isin(sv, [bad_v]), np.isin(sf, [bad_v]).any(1)),
               ee=(np.isin(se, [bad_v]).any(1), np.isin(se, [bad_v]).any(1)),
               et=(np.isin(se, [bad_v]).any(1), np.isin(sf, [bad_v]).any(1)))
    for k, (bq, bt) in bad.items():
        keep = {p for p in _pairset(base[k]) if not (bq[p[0]] or bt[p[1]])}
        assert _pairset(got[k]) == keep, k
        assert not any(bq[p[0]] or bt[p[1]] for p in _pairset(got[k]))
    # the geometry ignores the non-finite boxes
    boxes = [BP.tri_aabbs(_t(xb), torch.as_tensor(sf), None, gap)]
    fin = torch.isfinite(boxes[0]).all(dim=2).all(dim=1)
    o1, c1 = SH.grid_geometry(boxes[0])
    o2, c2 = SH.grid_geometry(boxes[0][fin])
    assert torch.equal(o1, o2) and torch.equal(c1, c2)
    nan_sweep = _port_grid(a, np.full(a["x"].shape, np.nan), gap)
    assert all(v.shape[0] == 0 for v in nan_sweep.values())


def test_comoving_sweep_invariance():
    """SelfContact's candidates do not change when a common translation is
    added to the sweep, and a rigid fall gives the static set."""
    st = build_scene(8, torch.float64, "cpu", with_contact=True)
    sc = st.sc
    assert sc.broadphase == "grid"
    x = st.mesh.x_rest
    rng = np.random.default_rng(7)
    disp = torch.as_tensor(rng.uniform(-0.02, 0.02, tuple(x.shape)))
    shift = torch.tensor([13.0, -4.0, 9.0], dtype=torch.float64)
    gap = float(np.sqrt(st.dHat))

    def key(c):
        return (_pairset(c.pt_vids), _pairset(c.ee_vids), _pairset(c.et_pairs))

    a = key(sc.build_candidates(x, disp, gap))
    b = key(sc.build_candidates(x, disp + shift[None, :], gap))
    assert a == b and all(len(s) for s in a)
    fall = torch.tensor([0.0, -50.0, 0.0], dtype=torch.float64).expand_as(x)
    assert key(sc.build_candidates(x, fall, gap)) == key(
        sc.build_candidates(x, torch.zeros_like(x), gap))


def test_grid_chunks_match_single_pass(monkeypatch):
    """A budget that splits the pair expansion into several chunks gives
    the same pairs as one pass."""
    st, a = _scene(4)
    gap = float(np.sqrt(st.dHat))
    disp = _disp(a, True, seed=3)
    one = _port_grid(a, disp, gap)
    monkeypatch.setattr(SH, "BUDGET", 997)
    many = _port_grid(a, disp, gap)
    for k in one:
        np.testing.assert_array_equal(many[k].numpy(), one[k].numpy())
