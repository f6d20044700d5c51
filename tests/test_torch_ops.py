"""Port parity, L0 ops: ipc_tpu_torch.ops.* against ipc_tpu.ops.* in float64.

Inputs come from a seeded numpy generator and go to both packages as the
same arrays. Tolerance: rtol 1e-12 (both sides run the same formulas in
IEEE float64; they differ only in how a library sums 3-term dot products),
with an absolute floor of 1e-12 x the largest reference magnitude where
entries can cancel to zero.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ipc_tpu.ops import barrier as JB
from ipc_tpu.ops import compensated as JC
from ipc_tpu.ops import friction as JF
from ipc_tpu.ops import spd as JS
from ipc_tpu.ops import step_bound as JSB
from ipc_tpu.ops import svd3 as J3
from ipc_tpu.ops.scatter import make_gather_sum as j_gather_sum
from ipc_tpu_torch.ops import barrier as TB
from ipc_tpu_torch.ops import compensated as TC
from ipc_tpu_torch.ops import friction as TF
from ipc_tpu_torch.ops import spd as TS
from ipc_tpu_torch.ops import step_bound as TSB
from ipc_tpu_torch.ops import svd3 as T3
from ipc_tpu_torch.ops.scatter import make_gather_sum as t_gather_sum

RTOL = 1e-12


def t64(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def close(got, ref, rtol=RTOL, floor=1e-12):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    atol = floor * max(1.0, float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0)))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def rand_mats(rng, n, neg_det=True):
    F = rng.normal(size=(n, 3, 3)) + 2.0 * np.eye(3)
    if neg_det:
        F[: n // 4, :, 2] *= -1.0  # a quarter with det < 0
    return F


@pytest.mark.parametrize("fn", ["barrier", "barrier_grad", "barrier_hess"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_barrier(fn, order):
    rng = np.random.default_rng(0)
    dHat = 1e-3
    # interior values plus the degenerate ones: coincident points (d = 0),
    # d == dHat, d > dHat and a negative (masked) lane
    d = np.concatenate([rng.uniform(1e-9, dHat, 64), [0.0, dHat, 2 * dHat, -1e-4]])
    ref = np.asarray(getattr(JB, fn)(jnp.asarray(d), dHat, order))
    got = getattr(TB, fn)(t64(d), dHat, order)
    close(got, ref)
    assert np.all(got.numpy()[-3:] == 0.0) and np.all(got.numpy()[64] == 0.0)


@pytest.mark.parametrize("fn", ["f0_sf", "f1_sf_over_x", "f2_sf"])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_friction_clamping(fn, order):
    rng = np.random.default_rng(1)
    eps = 2.5e-5
    x2 = np.concatenate([rng.uniform(0.0, eps * eps, 64), [0.0, eps * eps]])
    ref = np.asarray(getattr(JF, fn)(jnp.asarray(x2), eps, order))
    close(getattr(TF, fn)(t64(x2), eps, order), ref)


def test_svd3_jacobi():
    rng = np.random.default_rng(2)
    F = rand_mats(rng, 64)
    U, s, V = jax.vmap(J3.svd3_jacobi)(jnp.asarray(F))
    Ut, st, Vt = T3.svd3_jacobi(t64(F))
    for got, ref in ((Ut, U), (st, s), (Vt, V)):
        close(got, ref)
    assert np.all((st.numpy()[:, 2] < 0) == (np.linalg.det(F) < 0))


def test_svd3_jacobi_degenerate():
    # rank-deficient and zero F: U, V stay proper rotations and the
    # reconstruction matches the reference's
    F = np.zeros((3, 3, 3))
    F[1] = np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 2.0])  # rank 1
    F[2] = np.diag([2.0, 1.0, 0.0])  # rank 2
    U, s, V = jax.vmap(J3.svd3_jacobi)(jnp.asarray(F))
    Ut, st, Vt = T3.svd3_jacobi(t64(F))
    rec = lambda U, s, V: np.einsum("nik,nk,njk->nij", np.asarray(U), np.asarray(s), np.asarray(V))
    close(rec(Ut.numpy(), st.numpy(), Vt.numpy()), rec(U, s, V))
    close(torch.linalg.det(Ut), np.ones(3))
    close(torch.linalg.det(Vt), np.ones(3))


def test_svd3_flip_matches_reconstruction():
    rng = np.random.default_rng(3)
    F = rand_mats(rng, 32)
    U, s, V = T3.svd3_flip(t64(F))
    close(torch.einsum("nik,nk,njk->nij", U, s, V), F)
    Uj, sj, Vj = jax.vmap(J3.svd3_flip)(jnp.asarray(F))
    close(s, sj)


@pytest.mark.parametrize("sort", [True, False])
def test_eigh3_jacobi(sort):
    rng = np.random.default_rng(4)
    M = rng.normal(size=(64, 3, 3))
    A = M + np.swapaxes(M, 1, 2)
    A[0] = np.diag([1.0, 1.0, 1.0])  # repeated eigenvalues (no pivots)
    w, Q = jax.vmap(lambda a: J3.eigh3_jacobi(a, sort=sort))(jnp.asarray(A))
    wt, Qt = T3.eigh3_jacobi(t64(A), sort=sort)
    close(wt, w)
    close(Qt, Q)


def test_make_psd():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(32, 12, 12))
    A = M + np.swapaxes(M, 1, 2)
    ref = np.asarray(jax.vmap(JS.make_psd)(jnp.asarray(A)))
    got = TS.make_psd(t64(A))
    close(got, ref, rtol=1e-11, floor=1e-12)
    assert np.linalg.eigvalsh(got.numpy()).min() > -1e-10


def test_make_psd2():
    rng = np.random.default_rng(6)
    M = rng.normal(size=(64, 2, 2))
    A = M + np.swapaxes(M, 1, 2)
    A[0] = [[1.0, 0.0], [0.0, -2.0]]  # diagonal (b == 0 branch)
    A[1] = [[-1.0, 0.0], [0.0, -1.0]]  # negative definite -> 0
    A[2] = [[3.0, 0.0], [0.0, 3.0]]
    ref = np.asarray(jax.vmap(JS.make_psd2)(jnp.asarray(A)))
    close(TS.make_psd2(t64(A)), ref)


def test_injective_step_bound():
    rng = np.random.default_rng(7)
    A = rand_mats(rng, 64, neg_det=False)
    B = rng.normal(size=(64, 3, 3))
    B[0] = 0.0  # no motion: the whole ray is safe
    B[1] = -A[1]  # straight collapse at t = 1 - slackness... of det
    B[2] = -A[2] * 3.0
    ref = np.asarray(jax.vmap(lambda a, b: JSB.injective_step_bound(a, b, 0.2))(
        jnp.asarray(A), jnp.asarray(B)))
    got = TSB.injective_step_bound(t64(A), t64(B), 0.2)
    close(got, ref)
    assert got[0].item() == 1e30


def test_smallest_positive_root_cubic_degenerate():
    # cubic, quadratic (c3 = 0), linear (c3 = c2 = 0) and no positive root
    c3 = np.array([1.0, 0.0, 0.0, 1.0, 0.0])
    c2 = np.array([-6.0, 1.0, 0.0, 0.0, 0.0])
    c1 = np.array([11.0, -3.0, 2.0, 0.0, 1.0])
    c0 = np.array([-6.0, 2.0, -1.0, 1.0, 1.0])
    ref = np.asarray(JSB.smallest_positive_root_cubic(*map(jnp.asarray, (c3, c2, c1, c0))))
    got = TSB.smallest_positive_root_cubic(*map(t64, (c3, c2, c1, c0)))
    close(got, ref)
    close(got[:3], [1.0, 1.0, 0.5])


@pytest.mark.parametrize("n", [1, 7, 1000, 4097])
def test_compensated_sums_float32(n):
    # the error-free transforms run the same ops in the same tree order:
    # the (hi, lo) pair is bitwise the JAX package's
    rng = np.random.default_rng(8)
    x = (rng.normal(size=n) * 10.0 ** rng.integers(-6, 6, size=n)).astype(np.float32)
    hi, lo = JC.df_sum(jnp.asarray(x))
    hit, lot = TC.df_sum(torch.as_tensor(x))
    assert hit.item() == float(hi) and lot.item() == float(lo)
    exact = float(np.sum(x.astype(np.float64)))
    assert abs((float(hit) + float(lot)) - exact) <= 1e-12 * np.abs(x).sum() + 1e-30
    y = (hit, lot)
    yj = (hi, lo)
    z = TC.df_add(y, (torch.tensor(np.float32(1e-3)), torch.tensor(np.float32(0.0))))
    zj = JC.df_add(yj, (jnp.float32(1e-3), jnp.float32(0.0)))
    assert z[0].item() == float(zj[0]) and z[1].item() == float(zj[1])
    assert bool(TC.df_leq(y, z)) == bool(JC.df_leq(yj, zj))
    assert TC.df_to_float(z).item() == float(JC.df_to_float(zj))
    s, e = TC.two_sum(torch.tensor(np.float32(1.0)), torch.tensor(np.float32(1e-9)))
    assert s.item() == 1.0 and e.item() == float(np.float32(1e-9))


def test_make_gather_sum():
    rng = np.random.default_rng(9)
    n_out = 40
    ids = rng.integers(0, n_out + 5, size=300)  # ids >= n_out are sinks
    vals = rng.normal(size=(300, 3, 3))
    ref = np.asarray(j_gather_sum(ids, n_out)(jnp.asarray(vals)))
    got = t_gather_sum(ids, n_out)(t64(vals))
    close(got, ref)
    # sink rows are dropped
    close(got.sum(0), vals[ids < n_out].sum(0))
