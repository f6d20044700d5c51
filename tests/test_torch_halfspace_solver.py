"""Port parity, ground contact + linear solver, in float64.

Half-space barrier and friction terms (rtol 1e-12, the same elementwise
formulas); PCG on one SPD operator (the same iteration count, solutions to
1e-10); block-Jacobi inverse; the two-level coarse assembler's inverse and
correction (rtol 1e-9 of the largest entry: a dense inverse of a
(3C,3C) matrix amplifies rounding by its condition number).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ipc_tpu.contact.halfspace import HalfSpace as JHS, HalfSpaceParams as JHP
from ipc_tpu.mesh import build_mesh as j_build_mesh
from ipc_tpu.models.primitives import box_grid
from ipc_tpu.solver import coarse as JCO
from ipc_tpu.solver import pcg as JPCG
from ipc_tpu_torch.contact.halfspace import HalfSpace as THS, HalfSpaceParams as THP
from ipc_tpu_torch.mesh import build_mesh as t_build_mesh
from ipc_tpu_torch.solver import coarse as TCO
from ipc_tpu_torch.solver import pcg as TPCG

RTOL = 1e-12
DHAT = 1e-4


def close(got, ref, rtol=RTOL, floor=1e-13):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * max(1.0, np.abs(ref).max()))


PLANES = {
    # the scene's ground: distances are exact, so a point ON the plane
    # (d = 0, coincident) and ones a hair above it compare tightly
    "ground": (dict(origin=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0), friction=0.1), 1e-6),
    # a tilted plane: n.x + D cancels to ~1e-16 absolute, so heights stay
    # well above that for the 1/dist-sensitive friction multipliers
    "tilted": (dict(origin=(0.1, -0.2, 0.3), normal=(0.2, 1.0, -0.1), friction=0.1), 2e-3),
}


def _surface(plane, seed=0, n=200):
    """Surface points across and beyond the barrier band of a plane."""
    rng = np.random.default_rng(seed)
    params, h_min = PLANES[plane]
    n_hat = np.asarray(params["normal"]) / np.linalg.norm(params["normal"])
    base = rng.normal(size=(n, 3))
    base -= np.outer(base @ n_hat - (np.asarray(params["origin"]) @ n_hat), n_hat)
    if plane == "ground":
        base[:, 1] = 0.0
    h = np.concatenate([rng.uniform(h_min, 1.5 * np.sqrt(DHAT), n - 1), [0.0]])
    x = base + h[:, None] * n_hat
    xt = x - 5e-5 * rng.normal(size=x.shape) * rng.uniform(0, 3, size=(n, 1))
    dbc = rng.uniform(size=n) < 0.1
    p = rng.normal(size=x.shape)
    return params, x, xt, dbc, p


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_halfspace_barrier_terms(plane):
    params, x, _, dbc, p = _surface(plane)
    jh, th = JHS(JHP(**params)), THS(THP(**params))
    xj, xt_ = jnp.asarray(x), torch.as_tensor(x)
    kappa = 3.7e6
    close(th.signed_dist(xt_), jh.signed_dist(xj))
    close(th.energy(xt_, kappa, DHAT), jh.energy(xj, kappa, DHAT))
    close(th.grad_sv(xt_, kappa, DHAT), jh.grad_sv(xj, kappa, DHAT))
    close(th.hess_blocks_sv(xt_, kappa, DHAT), jh.hess_blocks_sv(xj, kappa, DHAT))
    assert torch.equal(th.active_mask(xt_, DHAT),
                       torch.as_tensor(np.array(jh.active_mask(xj, DHAT))))
    for slack in (0.9, 1.0):
        close(th.largest_feasible_step(xt_, torch.as_tensor(p), torch.as_tensor(dbc), slack),
              jh.largest_feasible_step(xj, jnp.asarray(p), jnp.asarray(dbc), slack))
    # nothing moves toward the plane: unbounded
    away = np.tile(np.asarray(params["normal"]), (x.shape[0], 1))
    assert th.largest_feasible_step(xt_, torch.as_tensor(away), torch.as_tensor(dbc)).item() == np.inf


@pytest.mark.parametrize("plane", sorted(PLANES))
def test_halfspace_friction_terms(plane):
    params, x, xt, _, _ = _surface(plane, seed=1)
    if plane == "tilted":
        x, xt = x[:-1], xt[:-1]  # the on-plane point only where d is exact
    jh, th = JHS(JHP(**params)), THS(THP(**params))
    xj, xtj = jnp.asarray(x), jnp.asarray(xt)
    xt_, xtt = torch.as_tensor(x), torch.as_tensor(xt)
    kappa = 3.7e6
    eps2 = (1e-3 * 0.025) ** 2 * 3.0
    lam_j = jh.friction_lambda(xj, jh.active_mask(xj, DHAT), kappa, DHAT)
    lam_t = th.friction_lambda(xt_, th.active_mask(xt_, DHAT), kappa, DHAT)
    close(lam_t, lam_j)
    e2j = jnp.asarray(eps2)
    e2t = torch.tensor(eps2, dtype=torch.float64)
    close(th.friction_energy(xt_, xtt, lam_t, e2t), jh.friction_energy(xj, xtj, lam_j, e2j))
    close(th.friction_grad_sv(xt_, xtt, lam_t, e2t), jh.friction_grad_sv(xj, xtj, lam_j, e2j))
    close(th.friction_hess_blocks_sv(xt_, xtt, lam_t, e2t),
          jh.friction_hess_blocks_sv(xj, xtj, lam_j, e2j))


def _spd_system(seed, n):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(3 * n, 3 * n)) / np.sqrt(3 * n)
    A = M @ M.T + np.diag(rng.uniform(0.1, 10.0, size=3 * n))
    b = rng.normal(size=(n, 3))
    diag = np.stack([A[3 * i:3 * i + 3, 3 * i:3 * i + 3] for i in range(n)])
    return A, b, diag


@pytest.mark.parametrize("warm", [False, True])
def test_pcg_matches(warm):
    n = 40
    A, b, diag = _spd_system(3, n)
    x0 = np.random.default_rng(4).normal(size=(n, 3)) if warm else None
    inv_j = JPCG.block_jacobi_inverse(jnp.asarray(diag))
    inv_t = TPCG.block_jacobi_inverse(torch.as_tensor(diag))
    close(inv_t, inv_j)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    xj, kj, relj = JPCG.pcg(
        lambda v: (Aj @ v.reshape(-1)).reshape(n, 3), jnp.asarray(b),
        lambda r: JPCG.apply_block_precond(inv_j, r),
        x0=None if x0 is None else jnp.asarray(x0), tol=1e-8, maxiter=500)
    xt, kt, relt = TPCG.pcg(
        lambda v: (At @ v.reshape(-1)).reshape(n, 3), torch.as_tensor(b),
        lambda r: TPCG.apply_block_precond(inv_t, r),
        x0=None if x0 is None else torch.as_tensor(x0), tol=1e-8, maxiter=500)
    assert kt == int(kj) and 0 < kt < 500
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), atol=1e-10)
    assert relt.item() <= 1e-8
    # singular blocks fall back to the identity
    inv0 = TPCG.block_jacobi_inverse(torch.zeros((2, 3, 3), dtype=torch.float64))
    assert torch.equal(inv0, torch.eye(3, dtype=torch.float64).expand(2, 3, 3))


def test_coarse_assembler_matches():
    rng = np.random.default_rng(5)
    V, T = box_grid(4, 3, 3)
    dbc = np.zeros(len(V), bool)
    dbc[:7] = True
    jm, _ = j_build_mesh(V, T, dbc_mask=dbc, dtype=np.float64)
    tm, _ = t_build_mesh(V, T, dbc_mask=dbc, dtype=torch.float64, device="cpu")
    agg, C = JCO.build_aggregates(np.asarray(jm.x_rest), size=8)
    agg_t, C_t = TCO.build_aggregates(tm.x_rest.numpy(), size=8)
    np.testing.assert_array_equal(agg, agg_t)
    assert C == C_t
    tets = np.asarray(jm.tets)
    nT, sv = tets.shape[0], np.array(jm.surf_verts, np.int64)
    M = rng.normal(size=(nT, 12, 12))
    tet_H = M @ np.swapaxes(M, 1, 2)
    B = rng.normal(size=(len(sv), 3, 3))
    Hsv = B @ np.swapaxes(B, 1, 2) * 1e3
    Hf = rng.normal(size=(len(sv), 3, 3))
    Hf = Hf @ np.swapaxes(Hf, 1, 2)
    mass = np.array(jm.mass)
    # the JAX package carries friction blocks as (v,0,0,0) stencils that are
    # zero outside the (0,0) block; the port passes the 3x3 blocks on (v,)
    H12 = np.zeros((len(sv), 12, 12))
    H12[:, :3, :3] = Hf
    vids4 = np.stack([sv, 0 * sv, 0 * sv, 0 * sv], axis=1)
    j_asm, j_term = JCO.make_coarse_assembler(agg, C, jm.dbc_mask, jnp.float64, tets=tets)
    t_asm, t_term = TCO.make_coarse_assembler(agg, C, tm.dbc_mask, torch.float64, tets=tets)
    Aj = j_asm(jm.mass, [(jnp.asarray(sv[:, None]), jnp.asarray(Hsv)),
                         (jnp.asarray(vids4), jnp.asarray(H12))], tet_H=jnp.asarray(tet_H))
    svt = torch.as_tensor(sv)[:, None]
    At = t_asm(torch.as_tensor(mass), [(svt, torch.as_tensor(Hsv)), (svt, torch.as_tensor(Hf))],
               tet_H=torch.as_tensor(tet_H))
    close(At, Aj, rtol=1e-9, floor=1e-9)
    r = rng.normal(size=(len(V), 3))
    close(t_term(At, torch.as_tensor(r)), j_term(Aj, jnp.asarray(r)), rtol=1e-9, floor=1e-9)
    assert np.all(t_term(At, torch.as_tensor(r)).numpy()[dbc] == 0.0)
