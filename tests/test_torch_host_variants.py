"""The host path's moving planes, friction loop, homotopies, damping and
Newmark step against the JAX package's IPCStepper.step, in float64 on the
CPU, held as tests/test_torch_host_step.py holds a step (identical counts,
x within 1e-9 or twice JAX's 1-ulp response):

* aco_squash, aco_shear: moving analytic planes (the host plane move);
  the velocity flips and the friction capture of a shearing plane;
* moving-plane friction drag (the friction terms with a plane velocity);
* fric_iter_amt -1: the refreshed-tangent probe ends the friction loop;
* the dHat and fricDHat homotopies, damping, and the host Newmark step.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu_torch.convert import state_from_numpy
from tests.test_torch_host_step import JAX, PORT, build, hold, pair, run_jax


@pytest.mark.parametrize("name", ["aco_squash", "aco_shear"])
def test_moving_planes_match_jax(name):
    jst, pst = pair(name)
    rows = run_jax(jst, 6)
    out = hold(jst, pst, rows, name)
    # the port's own plane move from the last state equals JAX's
    np.testing.assert_array_equal(pst.hs_origin, jst.hs_origin)
    np.testing.assert_array_equal(pst.script.aco_vel, jst.script.aco_vel)
    x0, x = rows[0]["pre"]["x"], out[-1][0].x.numpy()
    if name == "aco_squash":
        assert pst.hs_origin[0][0] > -0.6 + 0.08 and pst.hs_origin[1][0] < 0.6 - 0.08
        for i, hs in enumerate(pst.halfspaces):  # never through a plane
            assert (x[pst._sv_np] @ hs._n - hs._n @ pst.hs_origin[i]).min() > 0.0
    else:
        np.testing.assert_array_equal(pst.script.aco_vel, [[0.0, 0, 0], [0, 1.0, 0]])
        assert x[:, 1].mean() > x0[:, 1].mean() + 1e-4  # dragged up by friction


def test_aco_velocity_flip_and_shear_capture():
    """test_aco_velocity_flip_and_shear: squash flips both x velocities below
    a 0.1 separation; squashshear turns plane 1 to +y below 0.8 and the
    captured friction carries that plane's displacement."""
    for pkg in (JAX, PORT):
        st = build(pkg, "aco_squash")
        st.hs_origin[0], st.hs_origin[1] = [-0.04, 0, 0], [0.04, 0, 0]
        st._step_aco(np.zeros((1, 3)))
        assert st.script.aco_vel[0][0] == -1.0 and st.script.aco_vel[1][0] == 1.0
        assert not np.any(st.hs_veldt)
    got = {}
    for pkg in (JAX, PORT):
        st = build(pkg, "aco_shear")
        st.hs_origin[0], st.hs_origin[1] = [-0.3, 0, 0], [0.3, 0, 0]
        st._step_aco(np.zeros((1, 3)))
        assert np.all(st.script.aco_vel[0] == 0.0)
        np.testing.assert_allclose(st.hs_veldt[1], [0.0, st.dt, 0.0])
        xr = np.asarray(st.mesh.x_rest)
        x = jnp.asarray(xr) if pkg is JAX else torch.as_tensor(xr)
        fric = st._capture_friction(x, x, st.suggest_kappa(st.dHat), st.dHat, None)
        assert fric["hs_veldt"][0] is None and fric["hs_veldt"][1] is not None
        got[pkg is JAX] = [np.asarray(v) for v in fric["hs"]] + [np.asarray(fric["eps2"])]
    for a, b in zip(got[True], got[False]):
        np.testing.assert_allclose(b, a, rtol=1e-13, atol=0)


def test_moving_plane_friction_drags():
    """test_moving_plane_friction_drags: with the plane sliding at veldt the
    friction gradient pulls the resting block along and following the
    plane costs no more energy; the port's terms equal JAX's."""
    vals = {}
    for pkg in (JAX, PORT):
        st = build(pkg, "resting", gap=0.0001, mu=0.8)
        xr = np.asarray(st.mesh.x_rest)
        conv = jnp.asarray if pkg is JAX else torch.as_tensor
        x = conv(xr)
        fric = st._capture_friction(x, x, st.suggest_kappa(st.dHat), st.dHat, None)
        hs, lam = st.halfspaces[0], fric["hs"][0]
        x_sv = x[st._sv]
        veldt = conv(np.array([0.05, 0.0, 0.0]))
        g0 = hs.friction_grad_sv(x_sv, x_sv, lam, fric["eps2"])
        g1 = hs.friction_grad_sv(x_sv, x_sv, lam, fric["eps2"], veldt=veldt)
        e_stay = hs.friction_energy(x_sv, x_sv, lam, fric["eps2"], veldt=veldt)
        e_follow = hs.friction_energy(x_sv + veldt[None, :], x_sv, lam, fric["eps2"],
                                      veldt=veldt)
        vals[pkg is JAX] = [np.asarray(v) for v in (lam, g0, g1, e_stay, e_follow)]
    lam, g0, g1, e_stay, e_follow = vals[False]
    assert lam.max() > 0.0 and np.abs(g0).max() == 0.0
    assert g1[:, 0].min() < 0.0 and float(e_follow) <= float(e_stay) + 1e-12
    for a, b in zip(vals[True], vals[False]):
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-300)


def test_unbounded_fric_iter_terminates():
    """fric_iter_amt -1: the refreshed-tangent probe ends the friction loop;
    sliding decelerates under mu 0.4 without going through the ground."""
    jst, pst = pair("resting", mu=0.4, fric_iter_amt=-1)
    s = jst.initial_state()
    s = replace(s, v=s.v + jnp.asarray([1.0, 0.0, 0.0]))
    rows = run_jax(jst, 2, start=s)
    hold(jst, pst, rows, "fric_iter_amt -1")
    assert sum(len(r["stats"].pcg_iters) for r in rows) > 4  # several sub-solves
    s = state_from_numpy(rows[0]["pre"], "cpu", torch.float64)
    for _ in range(10):
        s, _ = pst.step(s)
        assert s.x[:, 1].min().item() > 0.0
    assert s.v[:, 0].mean().item() < 0.7


@pytest.mark.parametrize("case", ["dhat", "fric_dhat"])
def test_homotopies_match_jax(case):
    """The dHat homotopy (dhat_rel 4e-3 halving to its 1e-3 target, kappa
    re-initialized each time) and the fricDHat homotopy (fric_dhat0_rel
    4e-3 halving to 1e-3 with friction recaptured), in contact from step 0
    with a sideways velocity."""
    params = dict(dhat_rel=4e-3) if case == "dhat" else dict(fric_dhat0_rel=4e-3)
    jst, pst = pair("resting", gap=0.002, mu=0.4, **params)
    s = jst.initial_state()
    rows = run_jax(jst, 3, start=replace(s, v=s.v + jnp.asarray([0.5, 0.0, 0.0])))
    hold(jst, pst, rows, case)
    # each step ran the homotopy's sub-solves: one per halving, at least
    assert all(len(r["stats"].pcg_iters) >= 3 for r in rows)
    if case == "fric_dhat":
        assert pst.fric_dhat == pst.fric_dhat_target < pst.fric_dhat0


@pytest.mark.parametrize("case", ["damping", "newmark"])
def test_damping_and_newmark_match_jax(case):
    """Lagged Rayleigh damping on the pinned cube, and the host path's
    Newmark step (which runs in the JAX package, unlike its jit step)."""
    if case == "damping":
        jst, pst = pair("damping", damping_stiff=0.05)
    else:
        jst, pst = pair("newmark", time_integration="NM")
    rows = run_jax(jst, 3)
    out = hold(jst, pst, rows, case)
    for (ps, _), r in zip(out, rows):
        np.testing.assert_allclose(ps.v.numpy(), r["post"]["v"], rtol=0, atol=1e-9 / pst.dt)
