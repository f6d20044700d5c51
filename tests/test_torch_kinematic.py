"""Port parity: kinematic mesh collision objects against the JAX package, in
float64 on the CPU.

The scene: a box_grid(3) cube (the deformable mesh) over a two-triangle
plate, 4 wide at y = 0, appended as a kinematic surface (tet-less DBC
vertices). Its two triangles and five edges are oversized against the
cube's primitives, so the grid broad phase takes the dense big sweep.

* append_kinematic_surface gives the JAX package's arrays and meta
  (triangles, edges, a point set);
* SelfContact._classify_big names the JAX package's big primitives;
* grid + big sweep gives the dense path's pairs in its order, and JAX's
  fused_candidates(..., big=...) / et_candidates sets, swept and unswept;
* capture_friction with vert_mu gives JAX's lambda * mu per pair;
* make_step equals make_jit_step for 3 steps of the cube sliding onto the
  plate with selfFric 0 and plate mu 0.2 (friction against the plate is
  captured only through vert_mu: this holds the step's friction gate):
  identical Newton, PCG and kappa counts, x within 1e-9, the plate
  bitwise in place.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu import mesh as JM
from ipc_tpu.contact import selfcollision as JSCm
from ipc_tpu.contact import spatial_hash as JSH
from ipc_tpu.contact.pipeline import SelfContact as JSelfContact
from ipc_tpu.jit_step import make_jit_step
from ipc_tpu.timestepper import IPCStepper as JStepper
from ipc_tpu.timestepper import SimParams as JParams
from ipc_tpu_torch import mesh as PM
from ipc_tpu_torch.contact import broadphase as BP
from ipc_tpu_torch.contact import spatial_hash as SH
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.convert import state_from_numpy
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.models.primitives import box_grid
from ipc_tpu_torch.timestepper import IPCStepper, SimParams

F64 = torch.float64
PLATE_V = np.array([[-2.0, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]]) + np.array([0.5, 0, 0.5])
PLATE_F = np.array([[0, 2, 1], [0, 3, 2]])
K_BUCKET = 64  # JAX grid bucket capacity (checked below)


def _meshes(y0, kind="tris"):
    """(port (mesh, meta, range), JAX (mesh, meta, range)) of the cube at
    height y0 with the plate appended as triangles, edges or points."""
    V, T = box_grid(3, 3, 3)
    V = V + np.array([0.0, y0, 0.0])
    tris = PLATE_F if kind == "tris" else None
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 0], [0, 2]]) if kind == "edges" else None
    pm, pmeta = PM.build_mesh(V, T, dtype=F64, device="cpu")
    jm, jmeta = JM.build_mesh(V, T)
    return (PM.append_kinematic_surface(pm, pmeta, PLATE_V, tris=tris, edges=edges),
            JM.append_kinematic_surface(jm, jmeta, PLATE_V, tris=tris, edges=edges))


@pytest.mark.parametrize("kind", ["tris", "edges", "points"])
def test_append_kinematic_surface_matches_jax(kind):
    (pm, pmeta, prng), (jm, jmeta, jrng) = _meshes(0.01, kind)
    assert prng == jrng == (64, 68)
    for name in PM.MESH_FIELDS:
        a, b = getattr(pm, name).numpy(), np.asarray(getattr(jm, name))
        assert a.shape == b.shape and np.array_equal(a, b), name
        assert getattr(pm, name).device.type == "cpu"
    assert pm.x_rest.dtype == F64 and pm.mass.dtype == F64
    for f in ("n_verts", "n_tets", "bbox_diag2", "avg_edge_len", "avg_node_mass",
              "comp_ranges"):
        assert getattr(pmeta, f) == getattr(jmeta, f), f
    assert np.array_equal(pmeta.bbox, jmeta.bbox)
    assert np.array_equal(pmeta.dbc_is_zero, jmeta.dbc_is_zero)
    # tet-less, pinned, a component of their own; the bbox grew, its
    # diagonal (dHat's scale) did not
    assert pm.dbc_mask[64:].all() and not pm.dbc_mask[:64].any()
    assert (pm.vert_comp[64:] == 1).all() and int(pm.tets.max()) < 64
    assert pmeta.bbox[0, 0] == -1.5 and pmeta.bbox_diag2 == 3.0


def test_classify_big_matches_jax():
    (pm, pmeta, _), (jm, jmeta, _) = _meshes(0.01)
    sc = SelfContact(pm, pmeta, broadphase="grid")
    jsc = JSelfContact(jm, jmeta, broadphase="grid")
    for k in ("tri_ids", "tri_mask", "edge_ids", "edge_mask"):
        assert np.array_equal(sc.big[k].numpy(), np.asarray(jsc.big[k])), k
    assert sc.big["tri_ids"].tolist() == [108, 109]
    assert sc.big["edge_ids"].tolist() == list(range(162, 167))
    # no obstacle, nothing oversized; the dense path classifies nothing
    V, T = box_grid(3, 3, 3)
    m, meta = PM.build_mesh(V, T, dtype=F64, device="cpu")
    assert SelfContact(m, meta, broadphase="grid").big is None
    assert SelfContact(pm, pmeta, broadphase="dense").big is None


def _pairset(pairs, unordered=False):
    p = np.asarray(pairs)
    p = p[p[:, 0] >= 0]
    return set(map(frozenset if unordered else tuple, p.tolist()))


CAP = 8192  # JAX candidate capacity, one compile for every case (checked below)


@pytest.fixture(scope="module")
def jax_fused():
    return (jax.jit(JSH.fused_candidates,
                    static_argnames=("cap_pt", "cap_ee", "cap_et", "K", "with_et")),
            jax.jit(JSH.et_candidates, static_argnames=("cap", "K")))


@pytest.mark.parametrize("swept", [False, True])
@pytest.mark.parametrize("gap", [0.0, 0.02])
def test_grid_with_big_sweep_equals_dense_and_jax(jax_fused, swept, gap):
    (pm, pmeta, _), (jm, jmeta, _) = _meshes(0.005)
    sc = SelfContact(pm, pmeta, broadphase="grid")
    jsc = JSelfContact(jm, jmeta, broadphase="grid")
    disp = None
    if swept:
        disp = np.random.default_rng(3).normal(scale=0.02, size=tuple(pm.x_rest.shape))
        disp[64:] = 0.0
    d = None if disp is None else torch.as_tensor(disp)
    x, sv, se, st, dbc = pm.x_rest, pm.surf_verts, pm.surf_edges, pm.surf_tris, pm.dbc_mask
    grid = SH.fused_candidates(x, sv, se, st, dbc, d, gap, with_et=True, big=sc.big)
    dense = dict(pt=BP.pt_candidates(x, sv, st, dbc, d, gap),
                 ee=BP.ee_candidates(x, se, dbc, d, gap),
                 et=BP.et_candidates(x, se, st, d, gap, dbc))
    et_alone = SH.et_candidates(x, se, st, d, gap, dbc, big=sc.big)
    jd = None if disp is None else jnp.asarray(disp)
    fused, et_only = jax_fused
    ref = fused(jm.x_rest, jm.surf_verts, jm.surf_edges, jm.surf_tris, jm.dbc_mask,
                cap_pt=CAP, cap_ee=CAP, cap_et=CAP, disp=jd, gap=gap, K=K_BUCKET,
                with_et=True, big=jsc.big)
    ref_et = et_only(jm.x_rest, jm.surf_edges, jm.surf_tris, cap=CAP, disp=jd, gap=gap,
                     dbc_mask=jm.dbc_mask, K=K_BUCKET, big=jsc.big)
    assert int(ref["overflow"]) <= K_BUCKET and int(ref_et[2]) <= K_BUCKET
    assert max(n for _, n in dense.values()) < CAP
    plate_tris = {108, 109}
    for k in ("pt", "ee", "et"):
        pairs, n = dense[k]
        assert n > 0 and grid[k][1] == n, k
        # the port's grid + sweep returns the dense pairs in the dense order
        assert torch.equal(grid[k][0], pairs), k
        assert int(ref[k][1]) == n, k
        assert _pairset(grid[k][0], k == "ee") == _pairset(ref[k][0], k == "ee"), k
    assert torch.equal(et_alone[0], dense["et"][0]) and et_alone[1] == dense["et"][1]
    assert _pairset(et_alone[0]) == _pairset(ref_et[0]) and int(ref_et[1]) == dense["et"][1]
    # the sweep's pairs are there: cube vertices against the plate, which is
    # 0.005 below the cube
    near = any(t in plate_tris for _, t in grid["pt"][0].tolist())
    assert near == (gap > 0.005 or swept)


@pytest.mark.parametrize("self_mu", [0.0, 0.1])
def test_capture_friction_with_vert_mu_matches_jax(self_mu):
    (pm, pmeta, (p0, p1)), (jm, jmeta, _) = _meshes(4e-4)
    vert_mu = np.zeros(pmeta.n_verts)
    vert_mu[p0:p1] = 0.2
    sc = SelfContact(pm, pmeta, friction=self_mu, vert_mu=vert_mu, broadphase="grid")
    dHat = (1e-3) ** 2 * pmeta.bbox_diag2
    x = pm.x_rest.clone()
    x[:64, 1] -= 1e-4 * torch.sin(torch.arange(64, dtype=F64))  # a slightly uneven base
    cand = sc.build_candidates(x, None, float(np.sqrt(dHat)), with_et=False)
    kappa = 1e5
    fr = sc.capture_friction(x, cand, kappa, dHat)
    n_pt, n_ee = cand.pt_count, cand.ee_count
    jfr = JSCm.capture_friction(
        jnp.asarray(x.numpy()), jnp.asarray(cand.pt_vids.numpy()), jnp.ones(n_pt, bool),
        jnp.asarray(cand.ee_vids.numpy()), jnp.ones(n_ee, bool),
        jnp.asarray(cand.ee_eps_x.numpy()), kappa, dHat,
        vert_mu=jnp.asarray(vert_mu), self_mu=self_mu)
    lam = np.asarray(jfr["lam"])
    keep = lam > 0.0
    want = sorted(zip(map(tuple, np.asarray(jfr["vids"])[keep].tolist()),
                      np.asarray(jfr["ctype"])[keep].tolist(), lam[keep].tolist()))
    got = sorted(zip(map(tuple, fr["vids"].tolist()), fr["ctype"].tolist(),
                     fr["lam"].tolist()))
    assert fr["count"] == len(want) > 0
    assert [g[:2] for g in got] == [w[:2] for w in want]
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], rtol=1e-12, atol=0)
    # the plate's pairs carry the plate's mu; without vert_mu and at
    # self_mu 0 nothing would be captured
    assert all(any(v >= p0 for v in g[0]) for g in got)
    fr_plain = SelfContact(pm, pmeta, friction=0.1, broadphase="grid").capture_friction(
        x, cand, kappa, dHat)
    np.testing.assert_allclose(sorted(fr["lam"].tolist()),
                               sorted((fr_plain["lam"] * 2.0).tolist()), rtol=1e-12)


def _arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step))


COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings", "pt_count", "ee_count",
          "et_count", "active_pt_max", "active_ee_max", "fric_count")


def test_cube_on_plate_step_matches_jax_float64():
    (pm, pmeta, (p0, p1)), (jm, jmeta, _) = _meshes(0.001)
    vert_mu = np.zeros(pmeta.n_verts)
    vert_mu[p0:p1] = 0.2
    jsc = JSelfContact(jm, jmeta, friction=0.0, vert_mu=jnp.asarray(vert_mu),
                       broadphase="grid", grid_K=K_BUCKET)
    jst = JStepper(jm, jmeta, JParams(), halfspaces=[], self_contact=jsc)
    sc = SelfContact(pm, pmeta, friction=0.0, vert_mu=vert_mu, broadphase="grid")
    st = IPCStepper(pm, pmeta, SimParams(), halfspaces=[], self_contact=sc)
    assert sc.big is not None and st._solve_fric
    v0 = np.zeros((pmeta.n_verts, 3))
    v0[:p0, 0] = 0.5  # the cube slides along the plate
    jstep, step = make_jit_step(jst, donate=False), make_step(st)
    s = jst.initial_state(v0=v0)
    for i in range(3):
        pre = _arrays(s)
        s, js = jstep(s)
        ps, stats = step(state_from_numpy(pre, "cpu", F64))
        jstats = {k: int(np.asarray(getattr(js, k))) for k in COUNTS}
        assert int(np.asarray(js.bucket_overflow)) <= K_BUCKET
        for k, cap in (("pt_count", jsc.cap_pt), ("ee_count", jsc.cap_ee),
                       ("et_count", jsc.cap_et), ("active_pt_max", jsc.cap_act_pt),
                       ("active_ee_max", jsc.cap_act_ee), ("fric_count", jsc.cap_fric)):
            assert jstats[k] <= cap, (i, k)
        assert {k: getattr(stats, k) for k in COUNTS} == jstats, i
        np.testing.assert_allclose(stats.kappa, float(np.asarray(js.kappa)), rtol=1e-12)
        np.testing.assert_allclose(ps.x.numpy(), np.asarray(s.x), rtol=0, atol=1e-9)
        assert stats.fric_count > 0 and stats.active_pt_max > 0, i
        assert torch.equal(ps.x[p0:p1], pm.x_rest[p0:p1])
        assert ps.x[:p0, 1].min() > 0.0
    # the plate's friction slowed the slide
    assert 0.0 < float(np.asarray(s.v)[:p0, 0].mean()) < 0.5


def test_step_accepts_vert_mu_and_the_sweep():
    """What the port used to refuse is taken: SelfContact(vert_mu=...) on the grid
    path with oversized primitives, through make_step."""
    (pm, pmeta, (p0, _)), _ = _meshes(0.001)
    sc = SelfContact(pm, pmeta, friction=0.0, vert_mu=np.where(np.arange(68) >= p0, 0.2, 0.0),
                     broadphase="grid")
    assert sc.vert_mu.dtype == F64 and sc.big["tri_ids"].numel() == 2
    with pytest.raises(ValueError):
        SelfContact(pm, pmeta, vert_mu=np.ones(3))
    st = IPCStepper(pm, pmeta, SimParams(), self_contact=sc)
    s, stats = make_step(st)(st.initial_state())
    assert stats.newton_iters > 0 and stats.fric_count > 0
    assert torch.isfinite(s.x).all()
