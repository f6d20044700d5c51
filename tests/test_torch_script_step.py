"""Scripted scenes: the port's make_step against ipc_tpu.jit_step.
make_jit_step, in float64 on the CPU.

Each scene is built by both packages from the same numpy arrays (the
port's modules against the JAX package's). JAX runs its jitted step from
rest (compiled once per scene); each of its steps is then taken by the
port from JAX's state before it, device-script state `aux` included. Per
step: identical Newton, PCG and kappa-doubling counts, script_scale and
AL iterations; x within 1e-9, or within twice JAX's own response to a
1-ulp change of its input x where that is larger (an ill-conditioned
step); the aux tensors (turning-rule signs and flags, plane origins and
velocities) within 1e-12.

* turning: a free cube whose top face is scripted down, with a flip_band
  turning rule that reverses it at step 5 (tests/test_device_script.py);
* nbc: a free cube pulled sideways by a Neumann force whose time gate
  closes after two steps
  (tests/test_jit_step.py::test_nbc_force_jit_matches_host);
* aco_squash: two analytic planes closing on a cube (the ACO squash
  script: plane origins and velocities in aux, clamped plane moves);
* aco_shear: a half-size cube held between two frictional planes, one of
  which slides along y (ACO squashshear: the moving plane's offset in
  every barrier term, its displacement in the friction terms);
* blocked_press: a scripted press blocked by contact, which the moving-DBC
  augmented Lagrangian completes (tests/test_mdbc_al.py). Its projected
  iterations after the AL start PCG with the DBC rows zeroed in the port;
  JAX runs it through tests/jax_al_step.py, which starts them so too.
  That loop without the zeroing is JAX's fused step bit for bit, and the
  port's AL episode (its iterations, script_scale and kappa) is held to
  the unmodified fused step from the same states.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu import mesh as JM, scripting as JSCR, timestepper as JT
from ipc_tpu.contact import halfspace as JH, pipeline as JPL
from ipc_tpu.jit_step import initial_device_aux as j_initial_aux, make_jit_step
from ipc_tpu.models.primitives import cube
from ipc_tpu_torch import mesh as PM, scripting as PSCR, timestepper as PT
from ipc_tpu_torch.contact import halfspace as PH, pipeline as PPL
from ipc_tpu_torch.convert import state_from_numpy
from ipc_tpu_torch.jit_step import make_step
from jax_al_step import jax_al_step

JAX = (JM, JSCR, JT, JH, JPL)
PORT = (PM, PSCR, PT, PH, PPL)
SCENES = {"turning": 8, "nbc": 3, "aco_squash": 6, "aco_shear": 6, "blocked_press": 3}
COUNTS = ("newton_iters", "pcg_iters_total", "kappa_doublings", "al_iters", "pt_count",
          "ee_count", "et_count", "active_pt_max", "active_ee_max")


def build(pkg, name):
    """IPCStepper of scene `name` from one package's modules."""
    M, S, T, H, PL = pkg
    kw = dict(dtype=torch.float64, device="cpu") if M is PM else {}
    if name == "turning":
        V, Te = cube(1)
        top = np.where(V[:, 1] > 0.999)[0]
        tp = int(top[0])
        script = S.Script(n_verts=len(V), dbc_groups=[S.DBCGroup(top, np.array([0.0, -1.0, 0.0]))],
                          turning=[S.TurningRule(vert=tp, axis=1, lo=V[tp, 1] - 0.1,
                                                 hi=V[tp, 1] + 10.0, action="flip_band",
                                                 group_ids=(0,))])
        mesh, meta = M.build_mesh(V, Te, dbc_mask=script.dbc_mask(), **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(gravity=(0, 0, 0)), script=script)
    if name == "nbc":
        V, Te = cube(1)
        V = V + np.array([0.0, 0.5, 0.0])
        top = np.where(V[:, 1] > 0.9 + 0.5 - 1e-6)[0]
        script = S.Script(n_verts=len(V), nbc_groups=[
            S.NBCGroup(top, np.array([4.0, 9.80665, 0.0]), (0.0, 0.04))])
        mesh, meta = M.build_mesh(V, Te, **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(), script=script)
    if name in ("aco_squash", "aco_shear"):
        shear = name == "aco_shear"
        V, Te = cube(1, size=0.5 if shear else 1.0)
        script = S.Script(n_verts=len(V), aco_kind="squashshear" if shear else "squash",
                          aco_vel=np.array([[1.0, 0, 0], [-1.0, 0, 0]]))
        lo, hi, mu = (-0.0004, 0.5004, 0.2) if shear else (-0.3, 1.3, 0.0)
        planes = [H.HalfSpaceParams(origin=(lo, 0.0, 0.0), normal=(1.0, 0.0, 0.0), friction=mu),
                  H.HalfSpaceParams(origin=(hi, 0.0, 0.0), normal=(-1.0, 0.0, 0.0), friction=mu)]
        mesh, meta = M.build_mesh(V, Te, **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(gravity=(0, 0, 0)),
                            halfspaces=[H.HalfSpace(q) for q in planes], script=script)
    # blocked_press: a free soft cube on the ground, a fully scripted cube
    # 4 mm above it moving down 0.05 per step
    V1, T1 = cube(1)
    V2, T2 = cube(1)
    V, Te, comp, ranges = M.merge_meshes([(V1 + np.array([0.0, 0.002, 0.0]), T1),
                                          (V2 + np.array([0.0, 1.006, 0.0]), T2)])
    script = S.Script(n_verts=len(V), dbc_groups=[
        S.DBCGroup(np.arange(len(V1), len(V)), np.array([0.0, -2.0, 0.0]))])
    mesh, meta = M.build_mesh(V, Te, vert_comp=comp, comp_ranges=ranges,
                              dbc_mask=script.dbc_mask(), **kw)
    return T.IPCStepper(mesh, meta, T.SimParams(), halfspaces=[H.HalfSpace(H.HalfSpaceParams())],
                        self_contact=PL.SelfContact(mesh, meta, friction=0.0), script=script)


def _arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=np.asarray(s.t), step=np.asarray(s.step),
                aux=None if s.aux is None else {k: np.asarray(v) for k, v in s.aux.items()})


def _jax_state(template, arrays):
    aux = arrays["aux"]
    fields = {k: jnp.asarray(v) for k, v in arrays.items() if k != "aux"}
    return replace(template, **fields,
                   aux=None if aux is None else {k: jnp.asarray(v) for k, v in aux.items()})


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene_run(request):
    name = request.param
    jst = build(JAX, name)
    jstep = jax_al_step(jst) if name == "blocked_press" else make_jit_step(jst, donate=False)
    template = replace(jst.initial_state(), aux=j_initial_aux(jst))
    s = template
    rows = []
    for _ in range(SCENES[name]):
        pre = _arrays(s)
        s, stats = jstep(s)
        rows.append(dict(pre=pre, post=_arrays(s),
                         stats={k: np.asarray(getattr(stats, k)).item()
                                for k in stats.__dataclass_fields__}))
    pstep = make_step(build(PORT, name))
    out = [pstep(state_from_numpy(r["pre"], "cpu", torch.float64)) for r in rows]
    return name, jstep, template, rows, out


def test_scripted_step_matches_jax_float64(scene_run):
    name, jstep, template, rows, out = scene_run
    for i, (r, (ps, pstats)) in enumerate(zip(rows, out)):
        js = r["stats"]
        assert {k: getattr(pstats, k) for k in COUNTS} == {k: js[k] for k in COUNTS}, (name, i)
        assert pstats.script_scale == pytest.approx(js["script_scale"], rel=1e-12, abs=0)
        np.testing.assert_allclose(pstats.kappa, js["kappa"], rtol=1e-12)
        jx, px = r["post"]["x"], ps.x.numpy()
        dx = np.abs(px - jx).max()
        tol = 1e-9
        if dx > tol:
            pre = r["pre"]
            ulp = np.random.default_rng(i).choice([-1.0, 1.0], size=pre["x"].shape)
            sp, _ = jstep(_jax_state(template, dict(pre, x=pre["x"] + ulp * np.spacing(
                np.abs(pre["x"])))))
            tol = max(tol, 2.0 * float(np.abs(np.asarray(sp.x) - jx).max()))
        assert dx <= tol, (name, i, dx, tol)
        jaux = r["post"]["aux"]
        assert (jaux is None) == (ps.aux is None)
        for k, v in (jaux or {}).items():
            np.testing.assert_allclose(ps.aux[k].double().numpy(), v.astype(float), rtol=0,
                                       atol=1e-12)


def test_scripted_scenes_reach_their_branches(scene_run):
    """Each scene runs the branch it is here for."""
    name, _, _, rows, out = scene_run
    x0 = rows[0]["pre"]["x"]
    x = out[-1][0].x.numpy()
    stats = [o[1] for o in out]
    if name == "turning":
        # the rule flips the face at step 5: back at its start after 8 steps
        tp = int(np.argmax(x0[:, 1] > 0.999))
        assert out[3][0].x[tp, 1].item() < 1.0 - 0.09
        np.testing.assert_allclose(x[tp, 1], 1.0, atol=1e-12)
    elif name == "nbc":
        assert x[:, 0].mean() > x0[:, 0].mean() + 1e-4  # pushed in +x
    elif name == "aco_squash":
        orig = out[-1][0].aux["hs_origin"].numpy()
        assert orig[0, 0] > -0.3 + 0.1 and orig[1, 0] < 1.3 - 0.1
    elif name == "aco_shear":
        vel = out[-1][0].aux["aco_vel"].numpy()
        np.testing.assert_array_equal(vel, [[0.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
        # the sliding plane drags the cube up through friction
        assert x[:, 1].mean() > x0[:, 1].mean() + 1e-4
    else:
        assert all(s.script_scale < 1.0 for s in stats)  # the press is blocked
        assert sum(s.al_iters for s in stats) > 0
        assert x[len(x) // 2:, 1].min() < x0[len(x) // 2:, 1].min() - 0.02


@pytest.mark.parametrize("scene_run", ["blocked_press"], indirect=True)
def test_jax_al_step_is_the_fused_jax_step(scene_run):
    """On the blocked press, tests/jax_al_step.py without its zeroing gives
    make_jit_step's fused result bit for bit (x, v and every count), and
    the port's AL episode from the same states matches that unmodified
    step: AL iterations, script_scale and kappa. Only the projected
    iterations after the AL, which the zeroing changes, are held to the
    patched loop (test_scripted_step_matches_jax_float64)."""
    name, _, template, rows, out = scene_run
    jst = build(JAX, name)
    fused, burst = make_jit_step(jst, donate=False), jax_al_step(jst, zero_dbc=False)
    for i, (r, (_, pstats)) in enumerate(zip(rows, out)):
        s = _jax_state(template, r["pre"])
        fs, fst = fused(s)
        bs, bst = burst(s)
        for k in ("x", "x_prev", "v", "a"):
            np.testing.assert_array_equal(np.asarray(getattr(bs, k)), np.asarray(getattr(fs, k)))
        fstats = {k: np.asarray(getattr(fst, k)).item() for k in fst.__dataclass_fields__}
        for k, v in fstats.items():
            np.testing.assert_array_equal(np.asarray(getattr(bst, k)).item(), v, err_msg=k)
        assert fstats["al_iters"] > 0, i
        assert pstats.al_iters == fstats["al_iters"], i
        assert pstats.script_scale == pytest.approx(fstats["script_scale"], rel=1e-12, abs=0)
        np.testing.assert_allclose(pstats.kappa, fstats["kappa"], rtol=1e-12)
