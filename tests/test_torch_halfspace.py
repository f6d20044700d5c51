"""Port parity of the moving-plane half-space terms, in float64.

A plane of a scripted ACO scene moves: every barrier term takes its
current offset `D` (a 0-d tensor), the friction terms its per-step
displacement `veldt`, and `move_bound_t` clamps its move against the
surface vertices. On seeded points across the barrier band of a plane
shifted away from its static origin, the port's terms match the JAX
package's (rtol 1e-12, the same elementwise formulas; masks and
unbounded steps exactly).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu.contact.halfspace import HalfSpace as JHS, HalfSpaceParams as JHP
from ipc_tpu_torch.contact.halfspace import HalfSpace as THS, HalfSpaceParams as THP

DHAT = 1e-4
KAPPA = 3.7e6
PLANES = {
    "ground": dict(origin=(0.0, 0.0, 0.0), normal=(0.0, 1.0, 0.0), friction=0.1),
    "wall": dict(origin=(-0.3, 0.0, 0.0), normal=(1.0, 0.0, 0.0), friction=0.2),
}


def close(got, ref, rtol=1e-12, floor=1e-13):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * max(1.0, np.abs(ref).max()))


def _moved(name, seed):
    """(params, plane origin moved by `shift`, points within and beyond the
    barrier band of the moved plane, anchors, DBC mask, directions, veldt)."""
    rng = np.random.default_rng(seed)
    params = PLANES[name]
    n_hat = np.asarray(params["normal"], float)
    shift = 0.05 * n_hat + np.array([0.0, 0.0, 0.02])
    origin = np.asarray(params["origin"]) + shift
    n = 160
    base = rng.normal(size=(n, 3))
    base -= np.outer(base @ n_hat - origin @ n_hat, n_hat)  # on the moved plane
    h = np.concatenate([rng.uniform(1e-6, 1.5 * np.sqrt(DHAT), n - 1), [0.0]])
    x = base + h[:, None] * n_hat
    xt = x - 5e-5 * rng.normal(size=x.shape) * rng.uniform(0, 3, size=(n, 1))
    dbc = rng.uniform(size=n) < 0.1
    p = rng.normal(size=x.shape)
    veldt = rng.normal(scale=1e-4, size=3)
    return params, origin, x, xt, dbc, p, veldt


@pytest.mark.parametrize("name", sorted(PLANES))
def test_moving_plane_barrier_terms(name):
    params, origin, x, _, dbc, p, _ = _moved(name, 0)
    jh, th = JHS(JHP(**params)), THS(THP(**params))
    xj, xt_ = jnp.asarray(x), torch.as_tensor(x)
    Dj = jh.D_of_origin(jnp.asarray(origin))
    Dt = th.D_of_origin(torch.as_tensor(origin))
    close(Dt, Dj)
    assert abs(Dt.item() - th._D) > 0.04  # the offset overrides the static plane
    close(th.signed_dist(xt_, D=Dt), jh.signed_dist(xj, D=Dj))
    close(th.dist2(xt_, D=Dt), jh.dist2(xj, D=Dj))
    assert torch.equal(th.active_mask(xt_, DHAT, D=Dt),
                       torch.as_tensor(np.array(jh.active_mask(xj, DHAT, D=Dj))))
    assert bool(th.active_mask(xt_, DHAT, D=Dt).any())
    close(th.energy(xt_, KAPPA, DHAT, D=Dt), jh.energy(xj, KAPPA, DHAT, D=Dj))
    close(th.grad_sv(xt_, KAPPA, DHAT, D=Dt), jh.grad_sv(xj, KAPPA, DHAT, D=Dj))
    close(th.hess_blocks_sv(xt_, KAPPA, DHAT, D=Dt), jh.hess_blocks_sv(xj, KAPPA, DHAT, D=Dj))
    for slack in (0.9, 1.0):
        close(th.largest_feasible_step(xt_, torch.as_tensor(p), torch.as_tensor(dbc), slack,
                                       D=Dt),
              jh.largest_feasible_step(xj, jnp.asarray(p), jnp.asarray(dbc), slack, D=Dj))


@pytest.mark.parametrize("name", sorted(PLANES))
def test_moving_plane_friction_terms(name):
    params, origin, x, xt, _, _, veldt = _moved(name, 1)
    jh, th = JHS(JHP(**params)), THS(THP(**params))
    xj, xtj = jnp.asarray(x), jnp.asarray(xt)
    xt_, xtt = torch.as_tensor(x), torch.as_tensor(xt)
    Dj = jh.D_of_origin(jnp.asarray(origin))
    Dt = th.D_of_origin(torch.as_tensor(origin))
    lam_j = jh.friction_lambda(xj, jh.active_mask(xj, DHAT, D=Dj), KAPPA, DHAT, D=Dj)
    lam_t = th.friction_lambda(xt_, th.active_mask(xt_, DHAT, D=Dt), KAPPA, DHAT, D=Dt)
    close(lam_t, lam_j)
    eps2 = (1e-3 * 0.025) ** 2 * 3.0
    e2j, e2t = jnp.asarray(eps2), torch.tensor(eps2, dtype=torch.float64)
    vj, vt = jnp.asarray(veldt), torch.as_tensor(veldt)
    close(th.friction_energy(xt_, xtt, lam_t, e2t, veldt=vt),
          jh.friction_energy(xj, xtj, lam_j, e2j, veldt=vj))
    close(th.friction_grad_sv(xt_, xtt, lam_t, e2t, veldt=vt),
          jh.friction_grad_sv(xj, xtj, lam_j, e2j, veldt=vj))
    close(th.friction_hess_blocks_sv(xt_, xtt, lam_t, e2t, veldt=vt),
          jh.friction_hess_blocks_sv(xj, xtj, lam_j, e2j, veldt=vj))
    # the plane's own motion changes the terms
    assert abs(th.friction_energy(xt_, xtt, lam_t, e2t, veldt=vt).item()
               - th.friction_energy(xt_, xtt, lam_t, e2t).item()) > 0.0


@pytest.mark.parametrize("name", sorted(PLANES))
def test_move_bound_t(name):
    params, origin, x, _, _, _, _ = _moved(name, 2)
    jh, th = JHS(JHP(**params)), THS(THP(**params))
    n_hat = np.asarray(params["normal"], float)
    xj, xt_ = jnp.asarray(x), torch.as_tensor(x)
    Dj = jh.D_of_origin(jnp.asarray(origin))
    Dt = th.D_of_origin(torch.as_tensor(origin))
    lifted = x + 0.01 * n_hat  # every point 0.01 farther than the band
    moves = {
        "toward, clamped": 0.05 * n_hat,
        "toward, free": 1e-3 * n_hat + np.array([0.0, 0.0, 0.3]),
        "away": -0.05 * n_hat,
        "along": np.cross(n_hat, [0.0, 0.0, 1.0]) * 0.2,
    }
    got = {}
    for what, d in moves.items():
        for pts in (x, lifted):
            want = jh.move_bound_t(jnp.asarray(pts), jnp.asarray(d), Dj, slackness=0.5)
            s = th.move_bound_t(torch.as_tensor(pts), torch.as_tensor(d), Dt, slackness=0.5)
            close(s, want)
            got[what, pts is x] = s.item()
    assert got["away", True] == 1.0 and got["along", True] == 1.0
    assert got["toward, clamped", False] < 1.0
    assert got["toward, free", False] == 1.0
    # the one on-plane point (distance ~1e-16 after rounding) pins an
    # approaching plane
    assert abs(got["toward, clamped", True]) < 1e-12
