"""Port parity: ACCD and the interval CCD (ipc_tpu_torch.contact.ccd), the
interval branch of SelfContact.ccd_alpha, and the edge-triangle
intersection test (contact.intersection) against the JAX package.

The cases of tests/test_ccd.py and tests/test_ccd_corpus.py are rebuilt in
numpy in tests/ccd_cases.py (head-on, grazing, moving triangle, parallel
motion, crossing and near-parallel edges, separating motion, no motion,
impacts at known t*, a tilted resting slide, degenerate stencils). The port's safe steps must equal
JAX's to 1e-12 in float64. A seeded fuzz corpus checks the port's own
guarantee: no sampled point of [0, t] comes closer than the preserved gap.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccd_cases import ee_cases as _ee_cases
from ccd_cases import pt as _pt
from ccd_cases import pt_cases as _pt_cases
from ccd_cases import random_ee_cases as _random_ee_cases
from ccd_cases import random_pt_cases as _random_pt_cases
from ipc_tpu.contact import ccd as JCCD
from ipc_tpu.contact import intersection as JI
from ipc_tpu_torch.contact import ccd as CCD
from ipc_tpu_torch.contact import intersection as TI
from ipc_tpu_torch.ops.distance import edge_edge_dist2, point_triangle_dist2

KINDS = {
    "pt": (CCD.accd_pt, JCCD.accd_pt, point_triangle_dist2, _pt_cases),
    "ee": (CCD.accd_ee, JCCD.accd_ee, edge_edge_dist2, _ee_cases),
}


def _jax_accd(fn, X, P, max_iter):
    return np.asarray(jax.vmap(fn, in_axes=(0, 0, None, None))(
        jnp.asarray(X), jnp.asarray(P), 0.2, max_iter))


@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("max_iter", [64, 128])
def test_accd_matches_jax_on_the_cases(kind, max_iter):
    port, ref, _, cases = KINDS[kind]
    cases = cases()
    X = np.stack([c[0] for c in cases])
    P = np.stack([c[1] for c in cases])
    got = port(torch.as_tensor(X), torch.as_tensor(P), 0.2, max_iter).numpy()
    want = _jax_accd(ref, X, P, max_iter)
    assert np.isfinite(got).all() and ((got >= 0) & (got <= 1)).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_accd_known_answers():
    """No motion and separating motion keep the full step; an impact at a
    known t* is never passed and leaves ~0.2 d0 of clearance."""
    X, P = _pt(*[[0, 0.5, 0.1], [0, 0, 0]])
    sep = _pt([0, 0.5, 0.1], [0, 2.0, 0])
    a = CCD.accd_pt(torch.as_tensor(np.stack([X, sep[0]])),
                    torch.as_tensor(np.stack([P, sep[1]]))).numpy()
    assert a[0] == 1.0 and a[1] >= 0.99
    for t_star in (0.25, 0.5, 0.9):
        x4, p4 = _pt([0, 1.0, 0], [0, -1.0 / t_star, 0])
        t = float(CCD.accd_pt(torch.as_tensor(x4[None]), torch.as_tensor(p4[None]))[0])
        assert 0.5 * t_star <= t <= t_star
        d_end = 1.0 - t / t_star  # the point falls straight onto the plane
        assert 0.05 <= d_end <= 0.5


def _min_dist2_along(dist2, X, P, alphas, n_samples=1024):
    ts = torch.linspace(0.0, 1.0, n_samples, dtype=torch.float64)
    Y = X[:, None] + (ts[None, :] * alphas[:, None])[..., None, None] * P[:, None]
    d2 = dist2(Y[..., 0, :], Y[..., 1, :], Y[..., 2, :], Y[..., 3, :])
    return d2.amin(dim=1)


@pytest.mark.parametrize("kind", ["pt", "ee"])
def test_accd_conservative_on_seeded_fuzz(kind):
    port, ref, dist2, _ = KINDS[kind]
    rng = np.random.default_rng(20260817)
    X, P = (_random_pt_cases if kind == "pt" else _random_ee_cases)(rng, 160)
    Xt, Pt = torch.as_tensor(X), torch.as_tensor(P)
    alphas = port(Xt, Pt)
    np.testing.assert_allclose(alphas.numpy(), _jax_accd(ref, X, P, 64), rtol=0, atol=1e-12)
    a = alphas.numpy()
    assert np.isfinite(a).all() and ((a >= 0) & (a <= 1)).all()
    min_d2 = _min_dist2_along(dist2, Xt, Pt, alphas).numpy()
    m = np.maximum(1.0, np.maximum(np.abs(X).max(axis=(1, 2)), np.abs(X + P).max(axis=(1, 2))))
    ok = (a <= 0.0) | (min_d2 > 1e-24 * m * m)
    assert ok.all(), np.nonzero(~ok)[0][:5]
    assert (a > 0).mean() > 0.9  # and useful: almost every case advances


def _intersection_cases(rng, n):
    """Edges through random triangles (crossing), beside them (missing),
    and lying in their plane (coplanar: not a proper crossing)."""
    X = []
    for i in range(n):
        tri = rng.normal(size=(3, 3))
        nrm = np.cross(tri[1] - tri[0], tri[2] - tri[0])
        nrm /= np.linalg.norm(nrm)
        b = rng.dirichlet([1.0, 1.0, 1.0])
        kind = i % 3
        if kind == 1:  # through a point outside the triangle
            b = b - np.array([1.2, 0.0, 0.0]) + np.array([0.0, 0.6, 0.6])
        hit = b @ tri
        d = nrm + 0.3 * rng.normal(size=3)
        if kind == 2:  # in the plane
            d = np.cross(nrm, rng.normal(size=3))
        s = rng.uniform(0.2, 1.0, 2)
        X.append(np.vstack([hit + s[0] * d, hit - s[1] * d, tri]))
    return np.stack(X)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_edge_triangle_intersection_matches_jax(dtype):
    rng = np.random.default_rng(5)
    X = _intersection_cases(rng, 300).astype(dtype)
    T = [torch.as_tensor(X[:, k]) for k in range(5)]
    J = [jnp.asarray(X[:, k]) for k in range(5)]
    got = TI.segment_triangle_intersects(*T).numpy()
    want = np.asarray(jax.vmap(JI.segment_triangle_intersects)(*J))
    np.testing.assert_array_equal(got, want)
    assert got[0::3].all() and not got[1::3].any() and not got[2::3].any()
    # the batched any() over (edge, tri) index pairs, one hit or none
    n = X.shape[0]
    x = X.reshape(-1, 3)
    edges = np.arange(5 * n).reshape(n, 5)[:, :2]
    tris = np.arange(5 * n).reshape(n, 5)[:, 2:]
    for rows in (np.arange(1, n, 3), np.array([1, 2, 4, 3, 5])):
        pairs = np.stack([rows, rows], axis=1)
        t_hit = TI.any_edge_tri_intersection(torch.as_tensor(x), torch.as_tensor(edges),
                                             torch.as_tensor(tris), torch.as_tensor(pairs))
        j_hit = JI.any_edge_tri_intersection(jnp.asarray(x), jnp.asarray(edges),
                                             jnp.asarray(tris), jnp.asarray(pairs),
                                             jnp.ones(len(rows), bool))
        assert bool(t_hit) == bool(j_hit) == bool(got[rows].any())
    empty = torch.zeros((0, 2), dtype=torch.int64)
    assert not bool(TI.any_edge_tri_intersection(torch.as_tensor(x), torch.as_tensor(edges),
                                                 torch.as_tensor(tris), empty))


def test_warped_face_is_no_intersection_in_float32():
    """An edge and a triangle of one flat box face, disjoint, after the face
    warped by ~1e-5 (float32 positions from a 6,144-tet run): the edge's
    endpoints lie on both sides of the triangle's plane and the in-plane
    volumes are float32 noise. The JAX package's float32 test reports an
    intersection; the port evaluates in float64, as the JAX package does on
    the same coordinates in float64, and reports none."""
    x = np.array([[-1.0274411e-05, 1.6816107e+00, 6.2499380e-01],
                  [9.5561347e-07, 1.8066101e+00, 7.4999720e-01],
                  [-3.8370299e-06, 1.8066144e+00, 6.2499994e-01],
                  [-2.9880944e-06, 1.9316105e+00, 7.4999434e-01],
                  [-3.8233447e-06, 1.9316109e+00, 6.2499750e-01]], np.float32)
    edges, tris, pairs = np.array([[0, 1]]), np.array([[2, 3, 4]]), np.array([[0, 0]])

    def jax_hit(xx):
        return bool(JI.any_edge_tri_intersection(jnp.asarray(xx), jnp.asarray(edges),
                                                 jnp.asarray(tris), jnp.asarray(pairs),
                                                 jnp.ones(1, bool)))

    assert jax_hit(x) and not jax_hit(x.astype(np.float64))
    got = TI.any_edge_tri_intersection(torch.as_tensor(x), torch.as_tensor(edges),
                                       torch.as_tensor(tris), torch.as_tensor(pairs))
    assert not bool(got)


# -- Tight-Inclusion-style interval CCD ---------------------------------------

TI_KINDS = {"pt": (CCD.ti_pt, JCCD.ti_pt, point_triangle_dist2, _pt_cases, _random_pt_cases),
            "ee": (CCD.ti_ee, JCCD.ti_ee, edge_edge_dist2, _ee_cases, _random_ee_cases)}


@pytest.mark.parametrize("kind", ["pt", "ee"])
@pytest.mark.parametrize("max_iter", [32, 64])
def test_ti_matches_jax(kind, max_iter):
    """The cases and 200 seeded stencils, with no minimum separation and
    with ccd_alpha's 0.2 d0: within one bisection interval of JAX's safe
    steps. Past ~40 halvings the interval nears float64's spacing of t and
    the two packages' rounding (autograd against jax.grad in the frame)
    may flip a late box test, so the bound stays at 2^-40 there."""
    port, ref, dist2, cases, rand = TI_KINDS[kind]
    cases = cases()
    X2, P2 = rand(np.random.default_rng(3), 200)
    X = np.concatenate([np.stack([c[0] for c in cases]), X2])
    P = np.concatenate([np.stack([c[1] for c in cases]), P2])
    Xt, Pt = torch.as_tensor(X), torch.as_tensor(P)
    d0 = torch.sqrt(torch.clamp(dist2(Xt[:, 0], Xt[:, 1], Xt[:, 2], Xt[:, 3]), min=0.0))
    tol = 2.0 ** -min(max_iter, 40)
    for ms in (torch.zeros_like(d0), 0.2 * d0):
        got = port(Xt, Pt, 1.0, ms, max_iter).numpy()
        want = np.asarray(jax.vmap(lambda a, b, m: ref(a, b, 1.0, m, max_iter))(
            jnp.asarray(X), jnp.asarray(P), jnp.asarray(ms.numpy())))
        assert np.isfinite(got).all() and ((got >= 0) & (got <= 1)).all()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)
        assert (got < 1).mean() > 0.5  # most cases do bound the step


@pytest.fixture(scope="module")
def ti_scene():
    """The two-box scene at n_cells=2, the upper box lowered onto the lower
    one to 0.4 sqrt(dHat) and jittered (seeded); both packages' self-contact
    with ccd_method="ti"; a seeded sweep that closes the boxes."""
    import __graft_entry__ as ge
    from ipc_tpu.contact.pipeline import SelfContact as JSelfContact
    from ipc_tpu_torch.contact.pipeline import SelfContact as PSelfContact
    from ipc_tpu_torch.scenes import build_scene

    jst = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=True)
    pst = build_scene(2, torch.float64, "cpu", with_contact=True)
    x = pst.mesh.x_rest.numpy().copy()
    upper = np.asarray(jst.mesh.vert_comp) == 1
    gap = float(np.sqrt(pst.dHat))
    x[upper, 1] += x[~upper, 1].max() + 0.4 * gap - x[upper, 1].min()
    x[upper, 0] += 0.5 / 3.0
    rng = np.random.default_rng(12)
    x[upper] += rng.uniform(-0.1, 0.1, size=(int(upper.sum()), 3)) * gap
    disp = rng.normal(scale=0.3 * gap, size=x.shape)
    disp[upper, 1] -= 0.6 * gap
    jsc = JSelfContact(jst.mesh, jst.meta, friction=0.1, ccd_method="ti")
    psc = PSelfContact(pst.mesh, pst.meta, friction=0.1, ccd_method="ti")
    return jsc, psc, x, disp, gap


def test_ti_ccd_alpha_matches_jax(ti_scene):
    jsc, psc, x, disp, gap = ti_scene
    xj, dj = jnp.asarray(x), jnp.asarray(disp)
    xt, dt = torch.as_tensor(x), torch.as_tensor(disp)
    jc = jax.jit(lambda a, b: jsc.build_candidates(a, b, gap))(xj, dj)
    pc = psc.build_candidates(xt, dt, gap)
    assert (pc.pt_count, pc.ee_count) == (int(jc.pt_count), int(jc.ee_count))
    assert pc.pt_count > 0 and pc.ee_count > 0
    for max_iter in (32, 64):
        want = float(jax.jit(lambda a, b, c: jsc.ccd_alpha(a, b, c, 0.2, max_iter))(xj, dj, jc))
        got = psc.ccd_alpha(xt, dt, pc, 0.2, max_iter).item()
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -min(max_iter, 40))
        assert 0.0 < got < 1.0  # the sweep closes the boxes: the step is bounded
        # the hybrid bound is the larger of the two conservative ones
        psc.ccd_method = "accd"
        assert got >= psc.ccd_alpha(xt, dt, pc, 0.2, max_iter).item()
        psc.ccd_method = "ti"
