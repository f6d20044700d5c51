"""The QP path's constraint families and ADMM solver against the JAX
package's (ipc_tpu/qp/constraints.py, ipc_tpu/qp/admm.py), in float64 on
the CPU, from the same numpy inputs made from a seed.

* constraint_c_grad, every reference type name (seven, three families), on
  random PT and EE stencils and on degenerate ones: exactly parallel edges
  (the EE solve's |det| guard), a toi below 0, above 1, NaN and inf (the
  Verschoor `bad` mask), coincident points. Values and gradients within
  1e-12, the 1e28 sentinel rows equal;
* admm_qp on tests/test_qp.py's two problems (no active row; a projection
  onto y >= 0) and on a random one with active rows: the same iteration
  count, x and lambda within 1e-10. With no rows at all (K = 0, the port's
  free-fall case) the port gives what JAX gives on all-invalid rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu.qp.admm import admm_qp as jax_admm
from ipc_tpu.qp.constraints import FAMILY_OF_TYPE as JAX_TYPES
from ipc_tpu.qp.constraints import constraint_c_grad as jax_c_grad
from ipc_tpu_torch.qp.admm import admm_qp
from ipc_tpu_torch.qp.constraints import FAMILY_OF_TYPE, constraint_c_grad
from ipc_tpu_torch.utils import observability as obs


def _stencils(seed=0, K=64):
    """(x4_prev, x4, is_ee, toi) numpy: random stencils, then degenerate
    rows (module docstring)."""
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((K, 4, 3))
    x = xp + 0.1 * rng.standard_normal((K, 4, 3))
    is_ee = rng.random(K) < 0.5
    toi = rng.uniform(0.0, 1.0, K)
    # exactly parallel edges, at both the current and the toi configuration
    for k, d in ((0, (1.0, 0.0, 0.0)), (1, (0.0, 2.0, 0.0))):
        d = np.asarray(d)
        x[k, 1] = x[k, 0] + d
        x[k, 3] = x[k, 2] + 3.0 * d
        xp[k] = x[k]
        is_ee[k] = True
    toi[2:6] = (-0.25, 1.5, np.nan, np.inf)  # outside [0, 1] or not finite
    is_ee[2:6] = (False, True, False, True)
    x[6, 1] = x[6, 0]  # coincident points: a degenerate triangle / edge
    x[7, 2] = x[7, 3]
    is_ee[6:8] = (False, True)
    return xp, x, is_ee, toi


def test_type_names_match():
    assert FAMILY_OF_TYPE == JAX_TYPES


@pytest.mark.parametrize("ctype", sorted(FAMILY_OF_TYPE))
def test_constraint_c_grad_matches_jax(ctype):
    xp, x, is_ee, toi = _stencils()
    jc, jg = jax.vmap(lambda a, b, e, t: jax_c_grad(ctype, a, b, e, t))(
        jnp.asarray(xp), jnp.asarray(x), jnp.asarray(is_ee), jnp.asarray(toi))
    pc, pg = constraint_c_grad(ctype, torch.as_tensor(xp), torch.as_tensor(x),
                               torch.as_tensor(is_ee), torch.as_tensor(toi))
    jc, jg = np.asarray(jc), np.asarray(jg)
    sentinel = jc == 1e28
    np.testing.assert_array_equal(pc.numpy() == 1e28, sentinel)
    np.testing.assert_allclose(pc.numpy(), jc, rtol=0, atol=1e-12)
    np.testing.assert_allclose(pg.numpy(), jg, rtol=0, atol=1e-12)
    assert np.all(pg.numpy()[sentinel] == 0.0)
    fam = FAMILY_OF_TYPE[ctype]
    # the guards: parallel edges (rows 0-1) for the EE families, a point
    # edge (row 7, at x only) for graphics, the toi mask (rows 2-5) for
    # Verschoor; the volume family has none
    expect = {"volume": [], "graphics": [0, 1, 7], "verschoor": [0, 1, 2, 3, 4, 5]}[fam]
    assert sorted(np.nonzero(sentinel)[0].tolist()) == expect


def test_constraints_take_no_rows():
    z = torch.zeros((0, 4, 3), dtype=torch.float64)
    for ctype in FAMILY_OF_TYPE:
        c, g = constraint_c_grad(ctype, z, z, torch.zeros(0, dtype=torch.bool),
                                 torch.zeros(0, dtype=torch.float64))
        assert c.shape == (0,) and g.shape == (0, 4, 3)


def _solve_jax(P, q, rows, vids, valid, l, **kw):
    """JAX's (x, lam, k) of one problem with P a dense (3V,3V) matrix."""
    V = q.shape[0]
    Pj = jnp.asarray(P)
    x, lam, k = jax_admm(lambda v: (Pj @ v.reshape(-1)).reshape(V, 3), jnp.asarray(q),
                         jnp.asarray(rows), jnp.asarray(vids, jnp.int32), jnp.asarray(valid),
                         jnp.asarray(l), **kw)
    return np.asarray(x), np.asarray(lam), int(k)


def _solve_port(P, q, rows, vids, valid, l, **kw):
    """The port's (x, lam, k) of the same problem."""
    V = q.shape[0]
    Pt = torch.as_tensor(P)
    reads0, pcg0 = obs.host_reads(), obs.counter("admm.pcg_iters")
    x, lam, k = admm_qp(lambda v: (Pt @ v.reshape(-1)).reshape(V, 3), torch.as_tensor(q),
                        torch.as_tensor(rows), torch.as_tensor(vids), torch.as_tensor(valid),
                        torch.as_tensor(l), **kw)
    assert obs.host_reads() - reads0 > k and obs.counter("admm.pcg_iters") > pcg0
    return x.numpy(), lam.numpy(), k


def _solve_both(*args, **kw):
    return _solve_jax(*args, **kw), _solve_port(*args, **kw)


def _hold(j, p, tol=1e-10):
    assert p[2] == j[2]
    np.testing.assert_allclose(p[0], j[0], rtol=0, atol=tol)
    np.testing.assert_allclose(p[1], j[1], rtol=0, atol=tol)


def _spd(V, seed):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((3 * V, 3 * V))
    return B @ B.T + 3.0 * np.eye(3 * V), rng.standard_normal((V, 3))


def test_admm_unconstrained_matches_jax():
    """tests/test_qp.py:16-35: four invalid rows, a plain SPD solve."""
    P, q = _spd(16, 0)
    rows, vids = np.zeros((4, 4, 3)), np.zeros((4, 4), np.int64)
    j, p = _solve_both(P, q, rows, vids, np.zeros(4, bool), np.zeros(4), iters=300,
                       pcg_tol=1e-10, pcg_maxiter=400)
    _hold(j, p)
    np.testing.assert_allclose(p[0], np.linalg.solve(P, -q.reshape(-1)).reshape(16, 3),
                               atol=1e-6)


def test_admm_with_no_rows_matches_jax_invalid_rows():
    """K = 0 (exact-size rows, a free-fall step): the port's answer is
    JAX's on all-invalid rows, done after its first iteration."""
    P, q = _spd(16, 1)
    kw = dict(iters=50, pcg_tol=1e-10, pcg_maxiter=400, eps_abs=1e-6)
    j = _solve_jax(P, q, np.zeros((4, 4, 3)), np.zeros((4, 4), np.int64), np.zeros(4, bool),
                   np.zeros(4), **kw)
    p = _solve_port(P, q, np.zeros((0, 4, 3)), np.zeros((0, 4), np.int64), np.zeros(0, bool),
                    np.zeros(0), **kw)
    assert p[1].shape == (0,) and not j[1].any()
    _hold((j[0], j[1][:0], j[2]), p)
    assert p[2] == 1


def test_admm_active_constraint_matches_jax():
    """tests/test_qp.py:38-62: min 1/2|x - target|^2 with every target
    below y = 0, subject to y_v >= 0: lambda = 1 on every row."""
    V = 4
    target = np.zeros((V, 3))
    target[:, 1] = -1.0
    rows = np.zeros((V, 4, 3))
    vids = np.zeros((V, 4), np.int64)
    rows[:, 0, 1] = 1.0
    vids[:, 0] = np.arange(V)
    j, p = _solve_both(np.eye(3 * V), -target, rows, vids, np.ones(V, bool), np.zeros(V),
                       iters=400, pcg_tol=1e-10)
    _hold(j, p)
    assert np.all(p[0][:, 1] > -1e-5) and np.all(p[1] > 0.5)


@pytest.mark.parametrize("seed", [0, 3])
def test_admm_random_active_rows_match_jax(seed):
    """Contact-like rows (a normal on one vertex against three), some
    active at the optimum, one invalid row."""
    rng = np.random.default_rng(seed)
    V, K = 16, 6
    B = rng.standard_normal((3 * V, 3 * V))
    P = B @ B.T / (3 * V) + np.eye(3 * V)
    q = rng.standard_normal((V, 3))
    rows = np.zeros((K, 4, 3))
    vids = np.zeros((K, 4), np.int64)
    for k in range(K):
        n = rng.standard_normal(3)
        vids[k] = rng.choice(V, 4, replace=False)
        rows[k] = np.array([1.0, -0.3, -0.3, -0.4])[:, None] * (n / np.linalg.norm(n))
    valid = np.ones(K, bool)
    valid[-1] = False
    j, p = _solve_both(P, q, rows, vids, valid, rng.uniform(0.1, 0.5, K), rho=10.0, iters=400,
                       pcg_tol=1e-10, pcg_maxiter=400, eps_abs=1e-8)
    _hold(j, p)
    assert p[2] < 400 and np.count_nonzero(p[1] > 1e-6) >= 2


@pytest.mark.parametrize("x0_seed", [None, 3])
def test_buffered_pcg_is_pcg_on_the_cpu(x0_seed):
    """GraphedPCG on CPU tensors (its bodies run eagerly there) gives the
    iterate, the count and the residual tests of `pcg` bit for bit, over
    two solves from the same start, and counts its operator applications
    and host reads as `pcg` makes them."""
    from ipc_tpu_torch.solver.pcg import GraphedPCG, pcg

    P, q = _spd(12, 1)
    Pt = torch.as_tensor(P)
    d = torch.as_tensor(1.0 / np.diag(P).reshape(12, 3))
    applied = [0]

    def op(v):
        applied[0] += 1
        return (Pt @ v.reshape(-1)).reshape(12, 3)

    def residual_tests():
        return obs.host_reads_by_site().get("pcg.residual", 0)

    b = torch.as_tensor(q)
    x0 = (torch.zeros_like(b) if x0_seed is None else
          torch.as_tensor(np.random.default_rng(x0_seed).standard_normal((12, 3))))
    reads0 = residual_tests()
    x_e, k_e, _ = pcg(op, b, lambda r: d * r, x0=x0, tol=1e-9, maxiter=100)
    assert applied[0] == 1 + k_e > 2 and residual_tests() - reads0 == k_e + 1
    g = GraphedPCG(op, lambda r: d * r, b)
    for i in range(2):
        applied[0], reads0 = 0, residual_tests()
        g.state[0].copy_(x0)
        g.start(b, 1e-9, *g.state)
        assert g.iterate(100) == k_e and torch.equal(g.state[0], x_e), i
        assert (applied[0], residual_tests() - reads0) == (1 + k_e, k_e + 1), i
