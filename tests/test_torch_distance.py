"""Port parity: contact distances, classifiers, mollifier and the per-pair
barrier derivatives (ipc_tpu_torch.ops.distance, contact.selfcollision)
against the JAX package.

Stencils come from a seeded numpy generator and go to both packages as the
same arrays. Values: rtol 1e-12 in float64 (same formulas; libraries sum
3-term dot products in their own order), 1e-5 in float32; the dType codes
must be identical, including float32's near-parallel edge pairs (the
dtype-aware threshold of ipc_tpu/ops/distance.py:243). Pair gradients and
12x12 Hessians: rtol 1e-10 against jax.grad / jax.hessian in float64 on
every PT code 0-6, every EE code 0-8, and a mollified EE pair.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ipc_tpu.contact import selfcollision as JSC
from ipc_tpu.ops import distance as JD
from ipc_tpu_torch.contact import selfcollision as TSC
from ipc_tpu_torch.ops import distance as TD

DHAT = 10.0  # larger than any squared distance below: every barrier active


def close(got, ref, rtol, floor=None):
    """|got - ref| <= rtol |ref| + floor max(1, max |ref|); rtol may be an
    array over the leading axis (a per-row tolerance)."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    rtol = np.asarray(rtol, np.float64)
    floor = float(rtol.min()) if floor is None else floor
    atol = floor * max(1.0, float(np.abs(ref).max(initial=0.0)))
    rtol = rtol.reshape(rtol.shape + (1,) * (ref.ndim - rtol.ndim))
    bad = np.abs(got - ref) > rtol * np.abs(ref) + atol
    assert not bad.any(), (np.argwhere(bad)[:5], got[bad][:5], ref[bad][:5])


def stencils(rng, n, near_parallel=0):
    """(n,4,3) stencils in the unit box; the last `near_parallel` rows are
    edge pairs at ~1e-5..1e-2 rad and 0.3 apart."""
    X = rng.uniform(-0.5, 0.5, (n, 4, 3))
    for i in range(n - near_parallel, n):
        a0 = rng.uniform(-0.5, 0.5, 3)
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        off = np.cross(d, rng.normal(size=3))
        off = 0.3 * off / np.linalg.norm(off)
        tilt = np.cross(d, off) / 0.3 * 10.0 ** rng.uniform(-5, -2)
        X[i] = [a0, a0 + d, a0 + off + rng.uniform(-0.3, 0.3) * d,
                a0 + off + d + tilt]
    return X


def rows(X):
    return [X[:, k] for k in range(4)]


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(20261016)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_distances_and_classifiers_match(rng, dtype):
    X = stencils(rng, 400, near_parallel=100).astype(dtype)
    J = [jnp.asarray(r) for r in rows(X)]
    T = [torch.as_tensor(r) for r in rows(X)]
    rtol = 1e-12 if dtype == "float64" else 1e-5
    v = jax.vmap
    for jf, tf, k in ((JD.d_PP, TD.d_PP, 2), (JD.d_PE, TD.d_PE, 3), (JD.d_PT, TD.d_PT, 4),
                      (JD.point_edge_dist2, TD.point_edge_dist2, 3),
                      (JD.ee_cross_sq_norm, TD.ee_cross_sq_norm, 4),
                      (JD.eps_x_ee, TD.eps_x_ee, 4)):
        close(tf(*T[:k]), v(jf)(*J[:k]), rtol)
    # the line-line formula (d_EE) loses ~2 eps / sin(theta) to cancellation
    # on near-parallel edges; in float32 the rows where it is evaluated are
    # held to rtol plus 8x that first-order bound (the two packages differ
    # there by up to 3e-4 relative at sin^2 = 1e-6, each as far from the
    # float64 value; dtype_EE deflects the pairs below it to PE/PP)
    u, w = X[:, 1] - X[:, 0], X[:, 3] - X[:, 2]
    sin = np.sqrt((np.cross(u, w) ** 2).sum(1) / ((u * u).sum(1) * (w * w).sum(1)))
    ee_rtol = rtol + (16 * np.finfo(np.float32).eps / sin if dtype == "float32" else 0.0)
    close(TD.d_EE(*T), v(JD.d_EE)(*J), ee_rtol, floor=rtol)
    # classifiers: identical codes (float32 near-parallel pairs included)
    np.testing.assert_array_equal(TD.dtype_PT(*T).numpy(), np.asarray(v(JD.dtype_PT)(*J)))
    codes = TD.dtype_EE(*T).numpy()
    np.testing.assert_array_equal(codes, np.asarray(v(JD.dtype_EE)(*J)))
    assert (codes[-100:] != 8).any()  # the parallel deflection is exercised
    close(TD.point_triangle_dist2(*T), v(JD.point_triangle_dist2)(*J), rtol)
    close(TD.edge_edge_dist2(*T), v(JD.edge_edge_dist2)(*J),
          np.where(codes == 8, ee_rtol, rtol), floor=rtol)
    ct = rng.integers(0, 4, size=X.shape[0])
    close(TD.stencil_dist2(torch.as_tensor(ct), torch.as_tensor(X)),
          v(JD.stencil_dist2)(jnp.asarray(ct), jnp.asarray(X)),
          np.where(ct == 3, ee_rtol, rtol), floor=rtol)
    eps = np.abs(rng.normal(size=X.shape[0])).astype(dtype) * 1e-2
    close(TD.mollifier_ee(torch.as_tensor(X), torch.as_tensor(eps)),
          v(JD.mollifier_ee)(jnp.asarray(X), jnp.asarray(eps)), rtol)


def _one_per_code(rng, classify, n_codes, near_parallel=0):
    X = stencils(rng, 4000, near_parallel=near_parallel)
    codes = np.asarray(jax.vmap(classify)(*[jnp.asarray(r) for r in rows(X)]))
    picks = [np.nonzero(codes == c)[0] for c in range(n_codes)]
    assert all(len(p) for p in picks), [len(p) for p in picks]
    return np.stack([X[p[0]] for p in picks])


def test_pt_pair_derivatives_every_code(rng):
    X = _one_per_code(rng, JD.dtype_PT, 7)
    tab = TSC.SlotTables("cpu", torch.float64)
    jg = jax.vmap(jax.grad(JSC.pt_pair_energy), in_axes=(0, None))(jnp.asarray(X), DHAT)
    jh = jax.vmap(JSC._pair_hess(JSC.pt_pair_energy), in_axes=(0, None))(jnp.asarray(X), DHAT)
    je = jax.vmap(JSC.pt_pair_energy, in_axes=(0, None))(jnp.asarray(X), DHAT)
    T = torch.as_tensor(X)
    assert (np.asarray(je) > 0).all()
    close(TSC.pt_pair_energy(T, DHAT, tab), je, 1e-12)
    close(TSC.pt_pair_grad(T, DHAT, tab), jg, 1e-10)
    close(TSC.pt_pair_hess(T, DHAT, tab), jh, 1e-10)


def test_ee_pair_derivatives_every_code_and_mollified(rng):
    X = _one_per_code(rng, JD.dtype_EE, 9)
    # a mollified pair: nearly parallel, the rest-shape threshold above c
    a = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.05, 0.2, 0.0], [1.05, 0.2, 1e-3]])
    X = np.concatenate([X, a[None]])
    eps = np.array(jax.vmap(JD.eps_x_ee)(*[jnp.asarray(r) for r in rows(X)]))
    eps[-1] = 1e-3 * 4.0  # rest lengths ~1: c = |ea x eb|^2 ~ 4e-8 << eps
    c_last = float(JD.ee_cross_sq_norm(*map(jnp.asarray, a)))
    assert c_last < eps[-1]
    tab = TSC.SlotTables("cpu", torch.float64)
    JX, JE = jnp.asarray(X), jnp.asarray(eps)
    je = jax.vmap(JSC.ee_pair_energy, in_axes=(0, 0, None))(JX, JE, DHAT)
    jg = jax.vmap(jax.grad(JSC.ee_pair_energy), in_axes=(0, 0, None))(JX, JE, DHAT)
    jh = jax.vmap(JSC._pair_hess(JSC.ee_pair_energy), in_axes=(0, 0, None))(JX, JE, DHAT)
    T, TE = torch.as_tensor(X), torch.as_tensor(eps)
    assert (np.asarray(je) > 0).all()
    close(TSC.ee_pair_energy(T, TE, DHAT, tab), je, 1e-12)
    close(TSC.ee_pair_grad(T, TE, DHAT, tab), jg, 1e-10)
    close(TSC.ee_pair_hess(T, TE, DHAT, tab), jh, 1e-10)


def test_degenerate_stencils_stay_finite():
    z = np.zeros((4, 3))
    line = np.array([[0.0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]])
    X = np.stack([z, line, np.array([[0.0, 0.1, 0], [0, 0, 0], [0, 0, 0], [1, 0, 0]]),
                  np.array([[0.0, 0, 0], [0, 0, 0], [0.5, 0.1, 0], [0.5, 0.1, 0]])])
    tab = TSC.SlotTables("cpu", torch.float64)
    T = torch.as_tensor(X)
    eps = torch.full((4,), 1e-3, dtype=torch.float64)
    for out in (TSC.pt_pair_energy(T, DHAT, tab), TSC.pt_pair_grad(T, DHAT, tab),
                TSC.pt_pair_hess(T, DHAT, tab), TSC.ee_pair_energy(T, eps, DHAT, tab),
                TSC.ee_pair_grad(T, eps, DHAT, tab), TSC.ee_pair_hess(T, eps, DHAT, tab),
                TD.point_triangle_dist2(*rows(T)), TD.edge_edge_dist2(*rows(T))):
        assert torch.isfinite(out).all()
