"""The host path (ipc_tpu_torch.timestepper.IPCStepper.step) against the JAX
package's IPCStepper.step, in float64 on the CPU: the analogs of
tests/test_sim_halfspace.py.

Each scene is built by both packages from the same numpy arrays. JAX steps
from rest; each compared step is then taken by the port from JAX's state
before it (dx_el included) with the JAX stepper's plane state (origins,
velocities) copied over. Per step the port must give JAX's `iters`,
`pcg_iters` list, `kappa_doublings`, `intersection_backtracks`,
`sweep_clamps`, `al_iters` and `n_constraints`, kappa to 1e-12, and x
within 1e-9, or within twice JAX's own response to a 1-ulp change of its
input x where that is larger (an impact step amplifies rounding
differences). The helpers here (`pair`, `run_jax`, `hold`) serve
tests/test_torch_host_{variants,contact,direct}.py too.

* drop: a cube falling onto a frictional ground (steps 0-1 and the impact,
  11-13), then the port alone over 60 steps: never through the plane,
  settled inside the barrier band, nearly at rest;
* freefall: the backward-Euler closed form; dbc: pinned rows do not move;
* warm_start 1-5: two steps each, so that modes 3-4 read dx_el.
"""

import copy
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu import mesh as JM, scripting as JSCR, timestepper as JT
from ipc_tpu.contact import halfspace as JH, pipeline as JPL
from ipc_tpu.models.primitives import cube
from ipc_tpu_torch import mesh as PM, scripting as PSCR, timestepper as PT
from ipc_tpu_torch.contact import halfspace as PH, pipeline as PPL
from ipc_tpu_torch.convert import state_from_numpy

JAX = (JM, JSCR, JT, JH, JPL)
PORT = (PM, PSCR, PT, PH, PPL)
KEYS = ("iters", "pcg_iters", "kappa_doublings", "intersection_backtracks", "sweep_clamps",
        "al_iters")


def jax_arrays(s):
    """numpy copy of a JAX SimState (dx_el included)."""
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=float(s.t), step=int(s.step),
                dx_el=None if s.dx_el is None else np.asarray(s.dx_el))


def jax_state(template, arrays):
    fields = {k: jnp.asarray(v) for k, v in arrays.items()
              if k not in ("t", "step", "dx_el")}
    dx_el = arrays["dx_el"]
    return replace(template, **fields, t=arrays["t"], step=arrays["step"],
                   dx_el=None if dx_el is None else jnp.asarray(dx_el))


def _planes(st):
    """Snapshot of a stepper's mutable plane and script state."""
    return (st.hs_origin.copy(), copy.deepcopy(st.script))


def _set_planes(st, snap):
    st.hs_origin[:] = snap[0]
    st.script = copy.deepcopy(snap[1])
    if st.hs_moving:
        st._refresh_hs_D()


def run_jax(jst, n_steps, start=None):
    """JAX host steps from `start` (default: rest). Rows: the state before
    each step, the plane state before it, the x after it and its stats."""
    s = jst.initial_state() if start is None else start
    rows = []
    for _ in range(n_steps):
        pre, planes = jax_arrays(s), _planes(jst)
        s, stats = jst.step(s)
        rows.append(dict(pre=pre, planes=planes, post=jax_arrays(s), stats=stats))
    return rows


def port_step(pst, row):
    """The port's step from a JAX row's state and plane state."""
    _set_planes(pst, row["planes"])
    return pst.step(state_from_numpy(row["pre"], "cpu", torch.float64))


def counts(stats):
    return {k: getattr(stats, k) for k in KEYS + ("n_constraints",)}


def ulp_runs(jst, row, seed=0, n=2):
    """JAX's step under 1-ulp changes of x (n random sign patterns), with
    the stepper's plane state restored: [(counts, max change of x)]."""
    rng = np.random.default_rng(seed)
    template = jst.initial_state()
    after = _planes(jst)
    runs = []
    for _ in range(n):
        _set_planes(jst, row["planes"])
        pre = row["pre"]
        pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                    * np.spacing(np.abs(pre["x"])))
        sp, sj = jst.step(jax_state(template, pert))
        runs.append((counts(sj), float(np.abs(np.asarray(sp.x) - row["post"]["x"]).max())))
    _set_planes(jst, after)
    return runs


def hold(jst, pst, rows, tag="", n_ulp=2):
    """Each row's port step against JAX's (module docstring), with n_ulp
    perturbed JAX steps where x differs by more than 1e-9. Returns the
    port's (state, stats) per row.

    A step whose counts JAX itself changes under a 1-ulp change of x (the
    boxes' step 9: its line search and PCG counts flip on rounding) is held
    to that set instead: the port's counts must be JAX's own under one of
    three such changes."""
    out = []
    for i, row in enumerate(rows):
        ps, pstats = port_step(pst, row)
        js = row["stats"]
        jx, px = row["post"]["x"], ps.x.numpy()
        dx = float(np.abs(px - jx).max())
        runs = []
        if counts(pstats) != counts(js):
            runs = ulp_runs(jst, row, seed=i, n=3)
            assert counts(pstats) in [c for c, _ in runs], (tag, i, counts(pstats), counts(js))
        np.testing.assert_allclose(pstats.kappa, js.kappa, rtol=1e-12)
        tol = 1e-9
        if dx > tol:
            runs = runs or ulp_runs(jst, row, seed=i, n=n_ulp)
            tol = max(tol, 2.0 * max(r for _, r in runs))
        assert dx <= tol, (tag, i, dx, tol)
        assert (ps.dx_el is None) == (row["post"]["dx_el"] is None)
        out.append((ps, pstats))
    return out


def build(pkg, name, **params):
    """IPCStepper of scene `name` from one package's modules."""
    M, S, T, H, PL = pkg
    kw = dict(dtype=torch.float64, device="cpu") if M is PM else {}
    ground = [H.HalfSpace(H.HalfSpaceParams(friction=params.pop("mu", 0.1)))]
    if name in ("drop", "newmark"):
        V, Te = cube(1)
        mesh, meta = M.build_mesh(V + np.array([0.0, 0.5, 0.0]), Te, **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(**params), halfspaces=ground)
    if name == "freefall":
        V, Te = cube(1)
        mesh, meta = M.build_mesh(V + np.array([0.0, 10.0, 0.0]), Te, **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(**params))
    if name in ("dbc", "damping"):
        V, Te = cube(1)
        V = V + np.array([0.0, 1.0, 0.0])
        mesh, meta = M.build_mesh(V, Te, dbc_mask=V[:, 1] > 1.9, **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(**params))
    if name == "ws":
        V, Te = cube(2)
        mesh, meta = M.build_mesh(V + np.array([0.0, 0.3, 0.0]), Te, **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(**params),
                            halfspaces=[H.HalfSpace(H.HalfSpaceParams())])
    if name == "resting":
        # just above a frictional ground: contact (and friction) from step 0
        V, Te = cube(1)
        mesh, meta = M.build_mesh(V + np.array([0.0, params.pop("gap", 0.02), 0.0]), Te, **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(**params), halfspaces=ground)
    # two planes closing on a cube (the ACO squash family)
    shear = name == "aco_shear"
    V, Te = cube(1, size=0.5) if shear else cube(2)
    if not shear:
        V = V - 0.5
    script = S.Script(n_verts=len(V), aco_kind="squashshear" if shear else "squash",
                      aco_vel=np.array([[1.0, 0, 0], [-1.0, 0, 0]]))
    lo, hi, mu = (-0.0004, 0.5004, 0.2) if shear else (-0.6, 0.6, 0.0)
    planes = [H.HalfSpaceParams(origin=(lo, 0.0, 0.0), normal=(1.0, 0.0, 0.0), friction=mu),
              H.HalfSpaceParams(origin=(hi, 0.0, 0.0), normal=(-1.0, 0.0, 0.0), friction=mu)]
    mesh, meta = M.build_mesh(V, Te, **(kw if shear else dict(kw, ym=5e4)))
    return T.IPCStepper(mesh, meta, T.SimParams(gravity=(0, 0, 0), **params),
                        halfspaces=[H.HalfSpace(q) for q in planes], script=script)


def pair(name, **params):
    return build(JAX, name, **dict(params)), build(PORT, name, **dict(params))


def test_cube_drop_matches_jax_then_settles():
    jst, pst = pair("drop")
    rows = run_jax(jst, 14)
    hold(jst, pst, rows[:2] + rows[11:], "drop")
    assert sum(len(r["stats"].alphas) for r in rows[11:]) > 3  # the impact's iterations
    # the port alone: the IPC invariants over 60 steps (test_cube_drop_on_ground)
    pst = build(PORT, "drop")
    s = pst.initial_state()
    ymins = []
    for _ in range(60):
        s, _ = pst.step(s)
        ymins.append(s.x[:, 1].min().item())
        assert ymins[-1] > 0.0
    assert ymins[-1] < np.sqrt(pst.dHat)
    assert s.v.abs().max().item() < 0.5 and min(ymins) < 0.45
    assert pst.operator_applications > 0 and pst.host_syncs > 0


def test_freefall_matches_the_closed_form():
    jst, pst = pair("freefall")
    hold(jst, pst, run_jax(jst, 2), "freefall")
    pst = build(PORT, "freefall")
    s = pst.initial_state()
    y, v, h, g = 10.0, 0.0, pst.dt, -9.80665
    for _ in range(20):
        s, _ = pst.step(s)
        v += h * g
        y += h * v
    np.testing.assert_allclose(s.x[:, 1].min().item(), y, atol=30 * pst.target_gres)
    np.testing.assert_allclose(s.v[0, 1].item(), v, atol=20 * 0.01 * 9.81 * h)


def test_dbc_rows_hold():
    jst, pst = pair("dbc")
    hold(jst, pst, run_jax(jst, 2), "dbc")
    pst = build(PORT, "dbc")
    s = pst.initial_state()
    x0 = s.x.numpy().copy()
    top = pst.mesh.dbc_mask.numpy()
    for _ in range(10):
        s, _ = pst.step(s)
    x = s.x.numpy()
    np.testing.assert_allclose(x[top], x0[top], atol=1e-14)
    assert x[~top][:, 1].min() < x0[~top][:, 1].min() - 1e-4


@pytest.mark.parametrize("mode", [1, 2, 3, 4, 5])
def test_warm_start_matches_jax(mode):
    jst, pst = pair("ws", warm_start=mode)
    rows = run_jax(jst, 2)
    assert (rows[1]["pre"]["dx_el"] is not None) == (mode >= 3)
    (s0, _), (s1, _) = hold(jst, pst, rows, f"warm_start {mode}")
    assert (s1.dx_el is not None) == (mode >= 3)
