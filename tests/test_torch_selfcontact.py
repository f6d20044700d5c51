"""Port parity: the self-contact pipeline (ipc_tpu_torch.contact.pipeline)
against ipc_tpu.contact.pipeline, in float64, on the two-box scene at
n_cells=2 pressed together: the upper box is lowered onto the lower one to
0.4 sqrt(dHat), shifted sideways by a third of a cell and jittered (seeded),
so PT and EE pairs of several closest-point types sit inside the barrier
band.

Candidates and active sets must be identical (the dense path keeps JAX's
order); barrier energy, gradient and pair blocks, the lagged self-friction
state and its energy, gradient and blocks, and the coarse assembly with
pair families agree to rtol 1e-10. The port's sets are exact-size; the JAX
package's padded rows are dropped by their valid masks before comparing.
The friction stencil helpers are also held to JAX on every closest-point
type, on seeded stencils.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ipc_tpu.contact import selfcollision as JSC
from ipc_tpu.ops import friction as JFR
from ipc_tpu.solver import coarse as JCO
from ipc_tpu_torch.contact import selfcollision as TSC
from ipc_tpu_torch.ops import friction as TFR
from ipc_tpu_torch.ops.compensated import df_to_float
from ipc_tpu_torch.ops.scatter import make_dynamic_gather_sum
from ipc_tpu_torch.scenes import build_scene
from ipc_tpu_torch.solver import coarse as TCO
from ipc_tpu_torch.utils import observability as obs

RTOL = 1e-10
KAPPA = 1.3e7


def _tables():
    """Gather-sum tables built so far: their host reads."""
    return obs.host_reads_by_site().get("gather_sum.table", 0)


def close(got, ref, rtol=RTOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * max(1e-300, np.abs(ref).max()))


@pytest.fixture(scope="module")
def scene():
    jst = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=True)
    pst = build_scene(2, torch.float64, "cpu", with_contact=True)
    for f in ("surf_verts", "surf_edges", "surf_tris", "tets"):
        np.testing.assert_array_equal(getattr(pst.mesh, f).numpy(),
                                      np.asarray(getattr(jst.mesh, f)))
    x = pst.mesh.x_rest.numpy().copy()
    comp = np.asarray(jst.meta.vert_comp) if hasattr(jst.meta, "vert_comp") else None
    upper = x[:, 1] > 0.6 if comp is None else comp == 1
    gap = np.sqrt(pst.dHat)
    cell = 1.0 / 2
    x[upper, 1] += x[~upper, 1].max() + 0.4 * gap - x[upper, 1].min()
    x[upper, 0] += cell / 3.0
    rng = np.random.default_rng(11)
    x[upper] += rng.uniform(-0.1, 0.1, size=(int(upper.sum()), 3)) * gap
    anchor = x - rng.normal(scale=1e-3, size=x.shape)  # the lagged friction anchor
    disp = rng.normal(scale=0.3 * gap, size=x.shape)  # a line-search sweep
    return dict(jsc=jst.sc, psc=pst.sc, x=x, anchor=anchor, disp=disp, dHat=pst.dHat,
                gap=float(gap), mesh=pst.mesh, jmesh=jst.mesh)


def _cands(s, disp=None, with_et=True):
    d = None if disp is None else s["disp"]
    jc = s["jsc"].build_candidates(jnp.asarray(s["x"]), None if d is None else jnp.asarray(d),
                                   s["gap"], with_et=with_et)
    pc = s["psc"].build_candidates(torch.as_tensor(s["x"]),
                                   None if d is None else torch.as_tensor(d), s["gap"],
                                   with_et=with_et)
    return jc, pc


@pytest.mark.parametrize("swept", [False, True])
def test_candidates_and_active_sets_match(scene, swept):
    jc, pc = _cands(scene, swept)
    for name, n in (("pt", pc.pt_count), ("ee", pc.ee_count), ("et", pc.et_count)):
        assert n == int(getattr(jc, f"{name}_count"))
    n_pt, n_ee = pc.pt_count, pc.ee_count
    np.testing.assert_array_equal(pc.pt_vids.numpy(), np.asarray(jc.pt_vids)[:n_pt])
    np.testing.assert_array_equal(pc.ee_vids.numpy(), np.asarray(jc.ee_vids)[:n_ee])
    np.testing.assert_array_equal(pc.et_pairs.numpy(), np.asarray(jc.et_pairs)[:pc.et_count])
    close(pc.ee_eps_x, np.asarray(jc.ee_eps_x)[:n_ee])
    x_j, x_t = jnp.asarray(scene["x"]), torch.as_tensor(scene["x"])
    for disp in (None, scene["disp"]):
        ja = scene["jsc"].active_set(x_j, jc, scene["dHat"],
                                     disp=None if disp is None else jnp.asarray(disp))
        pa = scene["psc"].active_set(x_t, pc, scene["dHat"],
                                     disp=None if disp is None else torch.as_tensor(disp))
        ok_p, ok_e = np.asarray(ja.ok_p), np.asarray(ja.ok_e)
        assert pa.cnt_pt == int(ja.cnt_pt) == ok_p.sum() > 0
        assert pa.cnt_ee == int(ja.cnt_ee) == ok_e.sum() > 0
        np.testing.assert_array_equal(pa.vids_p.numpy(), np.asarray(ja.vids_p)[ok_p])
        np.testing.assert_array_equal(pa.vids_e.numpy(), np.asarray(ja.vids_e)[ok_e])
        close(pa.eps_e, np.asarray(ja.eps_e)[ok_e])


@pytest.fixture(scope="module")
def active(scene):
    jc, pc = _cands(scene)
    x_j, x_t = jnp.asarray(scene["x"]), torch.as_tensor(scene["x"])
    ja = scene["jsc"].active_set(x_j, jc, scene["dHat"])
    pa = scene["psc"].active_set(x_t, pc, scene["dHat"])
    return jc, pc, ja, pa, x_j, x_t


def test_barrier_terms_match(scene, active):
    jc, pc, ja, pa, x_j, x_t = active
    jsc, psc, dHat = scene["jsc"], scene["psc"], scene["dHat"]
    e_j = float(jsc.energy_active(x_j, ja, KAPPA, dHat))
    close(psc.energy_active(x_t, pa, KAPPA, dHat), e_j)
    hi_j, lo_j = jsc.energy_active(x_j, ja, KAPPA, dHat, df=True)
    hi_t, lo_t = psc.energy_active(x_t, pa, KAPPA, dHat, df=True)
    close(df_to_float((hi_t, lo_t)), float(hi_j) + float(lo_j))
    assert e_j > 0
    close(psc.gradient_active(x_t, pa, KAPPA, dHat), jsc.gradient_active(x_j, ja, KAPPA, dHat))
    ok = np.concatenate([np.asarray(ja.ok_p), np.asarray(ja.ok_e)])
    # the ctype mix: the pressed state reaches several closest-point types
    codes = TSC.pt_reduce(x_t[pa.vids_p], psc.tab)[1].unique().numel() + \
        TSC.ee_reduce(x_t[pa.vids_e], psc.tab)[1].unique().numel()
    assert codes >= 3
    for project in (False, True):
        vj, Hj, cj = jsc.hessian_blocks_from_active(x_j, ja, KAPPA, dHat, project)
        vt, Ht, ct = psc.hessian_blocks_from_active(x_t, pa, KAPPA, dHat, project)
        assert ct == (int(cj[0]), int(cj[1]))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj)[ok])
        close(Ht, np.asarray(Hj)[ok])
    # the wrapper that compacts first gives the same blocks
    vt2, Ht2, _ = psc.hessian_blocks_active(x_t, pc, KAPPA, dHat, True)
    assert torch.equal(vt2, vt) and torch.equal(Ht2, Ht)


def test_friction_terms_match(scene, active):
    jc, pc, ja, pa, x_j, x_t = active
    jsc, psc, dHat = scene["jsc"], scene["psc"], scene["dHat"]
    fj = jsc.capture_friction(x_j, jc, KAPPA, dHat)
    ft = psc.capture_friction(x_t, pc, KAPPA, dHat)
    ok = np.asarray(fj["lam"]) > 0
    assert ft["count"] == int(fj["count"]) == ok.sum() > 0
    np.testing.assert_array_equal(ft["vids"].numpy(), np.asarray(fj["vids"])[ok])
    np.testing.assert_array_equal(ft["ctype"].numpy(), np.asarray(fj["ctype"])[ok])
    for k in ("lam", "coords", "basis"):
        close(ft[k], np.asarray(fj[k])[ok])
    anchor_j, anchor_t = jnp.asarray(scene["anchor"]), torch.as_tensor(scene["anchor"])
    eps2 = (1e-3 * 0.025) ** 2 * 3.0
    e2j, e2t = jnp.asarray(eps2), torch.tensor(eps2, dtype=torch.float64)
    n_verts = int(scene["x"].shape[0])
    close(TSC.friction_energy(ft, x_t, anchor_t, e2t, 1.0),
          JSC.friction_energy(fj, x_j, anchor_j, e2j, 1.0))
    close(TSC.friction_gradient(ft, x_t, anchor_t, e2t, 1.0, ft["vert_sum"]),
          JSC.friction_gradient(fj, x_j, anchor_j, e2j, 1.0, n_verts))
    close(TSC.friction_hessian_blocks(ft, x_t, anchor_t, e2t, 1.0),
          np.asarray(JSC.friction_hessian_blocks(fj, x_j, anchor_j, e2j, 1.0))[ok])


def test_coarse_assembly_with_pair_families(scene, active):
    jc, pc, ja, pa, x_j, x_t = active
    jsc, psc, dHat = scene["jsc"], scene["psc"], scene["dHat"]
    mesh, jmesh = scene["mesh"], scene["jmesh"]
    agg, C = TCO.build_aggregates(mesh.x_rest.numpy(), size=8)
    tets = mesh.tets.numpy()
    vj, Hj, _ = jsc.hessian_blocks_from_active(x_j, ja, KAPPA, dHat, True)
    vt, Ht, _ = psc.hessian_blocks_from_active(x_t, pa, KAPPA, dHat, True)
    fj = jsc.capture_friction(x_j, jc, KAPPA, dHat)
    ft = psc.capture_friction(x_t, pc, KAPPA, dHat)
    eps2 = (1e-3 * 0.025) ** 2 * 3.0
    anchor_j, anchor_t = jnp.asarray(scene["anchor"]), torch.as_tensor(scene["anchor"])
    Fj = JSC.friction_hessian_blocks(fj, x_j, anchor_j, jnp.asarray(eps2), 1.0)
    Ft = TSC.friction_hessian_blocks(ft, x_t, anchor_t, torch.tensor(eps2, dtype=torch.float64),
                                     1.0)
    j_asm, _ = JCO.make_coarse_assembler(agg, C, jmesh.dbc_mask, jnp.float64, tets=tets)
    t_asm, _ = TCO.make_coarse_assembler(agg, C, mesh.dbc_mask, torch.float64, tets=tets)
    Aj = j_asm(jmesh.mass, [(vj, Hj), (fj["vids"], Fj)])
    tables0 = _tables()
    At = t_asm(mesh.mass, [(vt, Ht), (ft["vids"], Ft)])
    assert _tables() - tables0 == 2  # one table per pair family
    close(At, Aj, rtol=1e-9)  # a dense (3C,3C) inverse, as in the slice-1 test


@pytest.mark.parametrize("shape", [(3,), (3, 3)])
def test_dynamic_gather_sum_matches_index_add(shape):
    rng = np.random.default_rng(3)
    n_out, N = 50, 400
    ids = torch.as_tensor(rng.integers(0, n_out - 10, size=N))  # 10 rows untouched
    vals = torch.as_tensor(rng.normal(size=(N,) + shape))
    tables0 = _tables()
    gs = make_dynamic_gather_sum(ids, n_out)
    assert _tables() - tables0 == 1
    want = torch.zeros((n_out,) + shape, dtype=torch.float64).index_add_(0, ids, vals)
    got = gs(vals)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-13, atol=1e-13)
    untouched = ~torch.isin(torch.arange(n_out), ids)
    assert untouched.any() and torch.equal(got[untouched], torch.zeros_like(got[untouched]))
    assert torch.equal(gs.rows, torch.unique(ids))
    # ascending position order within each segment: a row's sum is the
    # left-to-right sum of its addends
    for r in gs.rows[:5].tolist():
        acc = torch.zeros(shape, dtype=torch.float64)
        for v in vals[ids == r]:
            acc = acc + v
        np.testing.assert_allclose(got[r].numpy(), acc.numpy(), rtol=1e-14, atol=1e-15)
    tables0 = _tables()
    empty = make_dynamic_gather_sum(torch.zeros((0,), dtype=torch.int64), n_out)
    assert _tables() == tables0
    assert torch.equal(empty(torch.zeros((0,) + shape, dtype=torch.float64)),
                       torch.zeros((n_out,) + shape, dtype=torch.float64))


@pytest.mark.parametrize("ctype", [0, 1, 2, 3])
def test_friction_stencil_helpers_match_jax(ctype):
    """Tangent basis, closest-point coordinates and relative-displacement
    weights of one closest-point type (PP, PE, PT, EE) on seeded stencils,
    against ipc_tpu.ops.friction."""
    rng = np.random.default_rng(40 + ctype)
    X = rng.normal(size=(64, 4, 3))
    dX = rng.normal(size=(64, 4, 3))
    ct = np.full(64, ctype)
    J = [jnp.asarray(a) for a in (ct, X, dX)]
    ct_t, X_t, dX_t = (torch.as_tensor(a) for a in (ct, X, dX))
    basis = jax.vmap(JFR.tangent_basis)(J[0], J[1])
    coords = jax.vmap(JFR.closest_point_coords)(J[0], J[1])
    close(TFR.tangent_basis(ct_t, X_t), basis)
    close(TFR.closest_point_coords(ct_t, X_t), coords)
    close(TFR.rel_dx_weights(ct_t, torch.as_tensor(np.asarray(coords))),
          jax.vmap(JFR.rel_dx_weights)(J[0], coords))
    close(TFR.rel_dx(ct_t, torch.as_tensor(np.asarray(coords)), dX_t),
          jax.vmap(JFR.rel_dx)(J[0], coords, J[2]))
