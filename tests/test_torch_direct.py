"""The direct Newton solves (solver/direct.py, solver/sparse_direct.py)
against the JAX package's, in float64 on the CPU.

* assemble_dense on seeded SPD block families (12x12 on tet-like stencils,
  6x6 on edges, 3x3 on vertices, with Dirichlet rows) equals JAX's to
  1e-13 relative (the port sums each cell in a fixed order, XLA scatters);
* dense_solve on that matrix equals JAX's to 1e-12 relative, and both give
  NaN where the matrix is not positive definite (the caller's fail-safe);
* the sparse solve: the port's tensor wrapper equals JAX's host function
  bitwise (the same SuperLU factorization of the same triplets) and the
  dense solve to 1e-10;
* a host step with linsys "dense" and "sparse" (a cube resting on a
  frictional ground: barrier and friction blocks from step 0) against
  JAX's, held as tests/test_torch_host_step.py holds a step; the two exact
  solves agree with each other, and make_step still refuses both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu.solver import direct as JD
from ipc_tpu.solver import sparse_direct as JSD
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.solver import direct as PD
from ipc_tpu_torch.solver import sparse_direct as PSD
from tests.test_torch_host_step import hold, pair, run_jax

N_VERTS = 14


def families(seed, n_verts=N_VERTS):
    """Seeded SPD block families [(vids (N,k), H (N,3k,3k))], a positive mass
    and a Dirichlet mask (numpy)."""
    rng = np.random.default_rng(seed)
    fams = []
    for k, n in ((4, 9), (2, 7), (1, 5)):
        vids = np.stack([rng.choice(n_verts, size=k, replace=False) for _ in range(n)])
        A = rng.normal(size=(n, 3 * k, 3 * k))
        fams.append((vids, A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3 * k)))
    mass = rng.uniform(0.5, 2.0, size=n_verts)
    dbc = np.zeros(n_verts, bool)
    dbc[rng.choice(n_verts, size=2, replace=False)] = True
    rhs = rng.normal(size=(n_verts, 3))
    return fams, mass, dbc, rhs


def _jax(fams, mass, dbc):
    return ([(jnp.asarray(v), jnp.asarray(H)) for v, H in fams], jnp.asarray(mass),
            jnp.asarray(dbc))


def _torch(fams, mass, dbc):
    return ([(torch.as_tensor(v), torch.as_tensor(H)) for v, H in fams],
            torch.as_tensor(mass), torch.as_tensor(dbc))


@pytest.mark.parametrize("seed", [0, 1])
def test_assemble_and_dense_solve_match_jax(seed):
    fams, mass, dbc, rhs = families(seed)
    jf, jm, jdbc = _jax(fams, mass, dbc)
    Aj = np.array(JD.assemble_dense(N_VERTS, jm, jf, jdbc))
    pf, pm, pdbc = _torch(fams, mass, dbc)
    Ap = PD.assemble_dense(N_VERTS, pm, pf, pdbc)
    np.testing.assert_allclose(Ap.numpy(), Aj, rtol=1e-13, atol=1e-13 * np.abs(Aj).max())
    assert np.array_equal(np.diag(Aj)[np.repeat(dbc, 3)], np.ones(6))
    xj = np.asarray(JD.dense_solve(jnp.asarray(Aj), jnp.asarray(rhs)))
    xp = PD.dense_solve(torch.as_tensor(Aj), torch.as_tensor(rhs)).numpy()
    np.testing.assert_allclose(xp, xj, rtol=0, atol=1e-12 * np.abs(xj).max())
    np.testing.assert_allclose(Aj @ xp.reshape(-1), rhs.reshape(-1), atol=1e-10)


def test_dense_solve_not_positive_definite_gives_nan():
    fams, mass, dbc, rhs = families(2)
    jf, jm, jdbc = _jax(fams, mass, dbc)
    A = np.array(JD.assemble_dense(N_VERTS, jm, jf, jdbc))
    A[5, 5] = -1.0
    xj = np.asarray(JD.dense_solve(jnp.asarray(A), jnp.asarray(rhs)))
    xp = PD.dense_solve(torch.as_tensor(A), torch.as_tensor(rhs)).numpy()
    assert np.isnan(xj).any() and np.isnan(xp).all()


@pytest.mark.parametrize("seed", [0, 3])
def test_sparse_solve_matches_jax(seed):
    fams, mass, dbc, rhs = families(seed)
    want = JSD.sparse_solve_host(N_VERTS, mass, fams, dbc, rhs)
    pf, pm, pdbc = _torch(fams, mass, dbc)
    got = PSD.sparse_solve(pm, pdbc, torch.as_tensor(rhs), pf)
    assert got.dtype == torch.float64 and got.shape == (N_VERTS, 3)
    assert np.array_equal(got.numpy(), want)
    dense = PD.dense_solve(PD.assemble_dense(N_VERTS, pm, pf, pdbc), torch.as_tensor(rhs))
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                               atol=1e-10 * np.abs(want).max())
    # a float32 right-hand side comes back in float32 (factorized in float64)
    got32 = PSD.sparse_solve(pm, pdbc, torch.as_tensor(rhs).float(), pf)
    assert got32.dtype == torch.float32


def test_host_step_with_direct_solves_matches_jax():
    xs = {}
    for linsys in ("dense", "sparse"):
        jst, pst = pair("resting", gap=0.02, mu=0.2, linsys=linsys)
        rows = run_jax(jst, 2)
        out = hold(jst, pst, rows, linsys)
        assert all(r["stats"].pcg_iters and set(r["stats"].pcg_iters) == {1} for r in rows)
        xs[linsys] = out[-1][0].x.numpy()
        assert xs[linsys][:, 1].min() > 0.0
        with pytest.raises(NotImplementedError, match="linsys"):
            make_step(pst)
    np.testing.assert_allclose(xs["sparse"], xs["dense"], rtol=0, atol=1e-9)
