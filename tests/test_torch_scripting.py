"""The port's scripting module (ipc_tpu_torch.scripting) against the JAX
package's (ipc_tpu.scripting).

* The named registry: for every name of tests/test_scripts_registry.py's
  lists plus the DCO/ACO/MCO families, both `build_script`s on the same
  vertices give the same DBC mask, DBC and NBC groups, handles, turning
  rules, ACO kind and plane velocities, kinematic-object motions, initial
  velocity and x0_transform.
* The device half, in float64 on seeded positions and times:
  `DeviceTurning.update`, `gfac` and `hfac` equal JAX's, and
  `device_closures`' `disp_fn` and `fext_fn` equal JAX's, with the turning
  factors fed through, time gates opening and closing, and a vertex listed
  by two groups. The one inexact part is a rotation's 3x3 product, which
  XLA sums in an order of its own: there disp_fn agrees to 4 ulp.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipc_tpu import scripting as JS
from ipc_tpu.mesh import build_mesh as j_build_mesh
from ipc_tpu.models.primitives import cube, mat
from ipc_tpu_torch import scripting as PS

NAMES_STATIC = [
    "hang", "hang2", "hangtopleft", "hangleft", "stand", "standinv",
    "topbottomfix", "fixlowerhalf", "corner", "stamp", "stampboth",
    "stamptopleft", "stampinv", "fixrightmost1", "swing", "curtain",
]
NAMES_MOVING = [
    "push", "tear", "undstamp", "upndown", "stretch", "squash",
    "stretchnsquash", "stretchnpause", "twist", "bend", "twistnstretch",
    "twistnsns", "twistnsns_old", "dragright", "toggletop",
    "pushrightmost1",
]
NAMES_CUBE = ["rubberbandpull", "fourlegpull", "headtailpull", "dragdown"]
NAMES_NBC = ["nmfixbottomdragleft", "nmfixbottomdragforward", "utopia_comparison"]
NAMES_X0 = ["scalef", "onepoint", "random", "fall", "fallnoshift"]
NAMES_INIT_VEL = ["null", "drop", "lefthitright", "xyrotate"]
NAMES_CO = [
    "dcofix", "dcoballhitwall", "dcosegbedsquash", "dcosqueezeout", "dcosquash",
    "dcosquash6", "dcorotcylinders", "dcoverschoorroller", "dcohammerwalnut", "dcocut",
    "mcosquash", "acosquash", "acosquashshear", "acosquash6", "mcorotsquash",
    "mcorotcylinders",
]
ALL_NAMES = NAMES_STATIC + NAMES_MOVING + NAMES_CUBE + NAMES_NBC + NAMES_X0 \
    + NAMES_INIT_VEL + NAMES_CO


def _vertices(name):
    V, T = cube(3 if name != "dragdown" else 10) if name in NAMES_CUBE else mat(5, size=1.0)
    mesh0, _ = j_build_mesh(V, T)
    surface = np.zeros(len(V), bool)
    surface[np.asarray(mesh0.surf_verts)] = True
    return np.asarray(V), surface


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    return np.array_equal(np.asarray(a), np.asarray(b))


def _fields(obj, names):
    return [getattr(obj, n) for n in names]


@pytest.mark.parametrize("name", ALL_NAMES)
def test_build_script_matches_jax(name):
    V, surface = _vertices(name)
    n = len(V)
    ranges, codim = [(0, n // 2), (n // 2, n)], [3, 2]
    args = (name, V, surface, ranges)
    kw = dict(handle_ratio=0.05, comp_codim=codim)
    j, p = JS.build_script(*args, **kw), PS.build_script(*args, **kw)
    assert _same(j.dbc_mask(), p.dbc_mask())
    group_fields = ("verts", "linear_vel", "angular_vel", "time_range", "rot_center")
    assert len(j.dbc_groups) == len(p.dbc_groups)
    for gj, gp in zip(j.dbc_groups, p.dbc_groups):
        assert all(_same(a, b) for a, b in zip(_fields(gj, group_fields),
                                               _fields(gp, group_fields)))
    assert len(j.nbc_groups) == len(p.nbc_groups)
    for gj, gp in zip(j.nbc_groups, p.nbc_groups):
        assert all(_same(a, b) for a, b in zip(_fields(gj, ("verts", "force", "time_range")),
                                               _fields(gp, ("verts", "force", "time_range"))))
    handle_fields = ("verts", "ang_vel", "axis", "center", "lin_vel")
    assert len(j.handles) == len(p.handles)
    for hj, hp in zip(j.handles, p.handles):
        assert all(_same(a, b) for a, b in zip(_fields(hj, handle_fields),
                                               _fields(hp, handle_fields)))
    rule_fields = ("vert", "axis", "lo", "hi", "action", "group_ids", "handle_ids", "active")
    assert [_fields(r, rule_fields) for r in j.turning] == \
        [_fields(r, rule_fields) for r in p.turning]
    assert j.aco_kind == p.aco_kind and _same(j.aco_vel, p.aco_vel)
    assert len(j.mco_motions) == len(p.mco_motions)
    for mj, mp in zip(j.mco_motions, p.mco_motions):
        assert _same(mj["lin"], mp["lin"]) and _same(mj["ang"], mp["ang"])
    assert j.clear_shape_dbc == p.clear_shape_dbc
    assert (j.dbc_time_range, j.nbc_time_range) == (p.dbc_time_range, p.nbc_time_range)
    assert _same(j.initial_velocity(V.copy()), p.initial_velocity(V.copy()))
    assert (j.x0_transform is None) == (p.x0_transform is None)
    if j.x0_transform is not None:
        assert _same(j.x0_transform(V.copy()), p.x0_transform(V.copy()))
    assert j.has_motion() == p.has_motion() and j.host_only() == p.host_only()


def _mixed(S, V):
    n = len(V)
    left = np.nonzero(V[:, 0] < 0.2)[0]
    right = np.nonzero(V[:, 0] > 0.8)[0]
    middle = np.nonzero((V[:, 0] > 0.1) & (V[:, 0] < 0.5))[0]  # overlaps `left`
    return S.Script(
        n_verts=n,
        dbc_groups=[
            S.DBCGroup(left, np.array([0.1, -0.2, 0.0]), np.array([0.3, -0.5, 0.7]),
                       (0.0, 0.1)),
            S.DBCGroup(right, None, np.array([0.0, 0.0, 1.1])),
            S.DBCGroup(middle, np.array([0.0, 0.0, 0.4]), None, (0.05, math.inf)),
            S.DBCGroup(right[:2]),  # static: no motion, skipped
        ],
        nbc_groups=[S.NBCGroup(left, np.array([1.0, 2.0, -3.0]), (0.0, 0.08)),
                    S.NBCGroup(middle, np.array([0.5, 0.0, 0.25]))],
        turning=[S.TurningRule(vert=int(left[0]), axis=1, lo=-0.01, hi=0.02,
                               action="flip_band", group_ids=(0, 2))],
        dbc_time_range=(0.0, 0.12),
        nbc_time_range=(0.01, math.inf),
    )


def _pair(name):
    V = np.asarray(mat(6, size=1.0)[0])
    surface = np.ones(len(V), bool)
    if name == "mixed":
        return V, _mixed(JS, V), _mixed(PS, V)
    args = (name, V, surface, [(0, len(V))])
    return V, JS.build_script(*args, handle_ratio=0.1), PS.build_script(*args, handle_ratio=0.1)


@pytest.mark.parametrize("name", ["twistnsns", "upndown", "push", "tear", "mixed"])
def test_device_closures_match_jax(name):
    V, js, ps = _pair(name)
    dt = 0.025
    jd, jf, jt = JS.device_closures(js, jnp.float64, dt)
    pd, pf, pt = PS.device_closures(ps, torch.float64, dt, "cpu")
    assert (jd is None) == (pd is None) and (jf is None) == (pf is None)
    assert (jt is None) == (pt is None)
    rng = np.random.default_rng(sum(map(ord, name)))
    # exact, but for the 3x3 rotation products, which XLA's dot sums in an
    # order of its own (the port sums k = 0, 1, 2): a few ulp there
    rotates = js.handles or any(g.angular_vel is not None for g in js.dbc_groups)
    rot_tol = 4 * np.finfo(np.float64).eps if rotates else 0.0
    sign_j = sign_p = act_j = act_p = None
    fired = False
    if jt is not None:
        sign_j, act_j = jt.init(jnp.float64)
        sign_p, act_p = pt.init(torch.float64)
    for k in range(12):
        t = 0.01 * k + (0.005 if k % 3 else 0.0)  # steps across every gate
        # small noise, then whole-mesh shifts of -4.5 ... 4.5 that cross
        # every rule's bound
        x = V + rng.normal(scale=0.3, size=V.shape) + (k >= 6) * 3.0 * (k % 4 - 1.5)
        gj = hj = gp = hp = None
        if jt is not None:
            sign_j, act_j = jt.update(jnp.asarray(x), sign_j, act_j)
            sign_p, act_p = pt.update(torch.as_tensor(x), sign_p, act_p)
            assert np.array_equal(np.asarray(sign_j), sign_p.numpy())
            assert np.array_equal(np.asarray(act_j), act_p.numpy())
            fired |= bool((sign_p != 1.0).any() or (~act_p).any())
            gj, hj, gp, hp = jt.gfac(sign_j), jt.hfac(sign_j), pt.gfac(sign_p), pt.hfac(sign_p)
            assert (gj is None) == (gp is None) and (hj is None) == (hp is None)
            for a, b in ((gj, gp), (hj, hp)):
                if a is not None:
                    assert np.array_equal(np.asarray(a), b.numpy())
        if jd is not None:
            want = np.asarray(jd(jnp.asarray(x), jnp.asarray(t), gj, hj))
            got = pd(torch.as_tensor(x), t, gp, hp).numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=rot_tol * np.abs(x).max())
        if jf is not None:
            assert np.array_equal(pf(t).numpy(), np.asarray(jf(jnp.asarray(t))))
    # the rules fired on these positions
    assert fired == (jt is not None)


def test_mesh_sequence_frames_need_the_host_path():
    with pytest.raises(NotImplementedError):
        PS._load_seq_frame("frames", 1, ".obj")
    script = PS.Script(n_verts=4, mesh_seqs=[PS.MeshSeqMotion(
        verts=np.arange(4), folder="frames", transform=None, n_frames=2, ext=".obj")])
    assert script.host_only()
    assert PS.device_closures(script, torch.float64, 0.025, "cpu")[0] is None
