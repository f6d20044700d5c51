"""The QP/SQP stepper (ipc_tpu_torch.qp.stepper.QPStepper.step) against the
JAX package's, in float64 on the CPU: the analogs of tests/test_qp.py,
started next to contact so that a few steps reach every branch.

Each scene is built by both packages from the same numpy arrays. JAX steps
from rest; the port takes each step from JAX's state before it. Per step
the port must give JAX's outer iteration count, its list of ADMM
iterations and its list of active-set sizes, x within 1e-9 (or twice JAX's
own response to a 1-ulp change of x where that is larger) and the KKT
gradient norms within 1e-9 relative or 1e-12.

* drop: one cube 0.004 above the ground, SQP with graphics constraints;
  its contact steps run ADMM into its 200-iteration cap;
* verschoor, volume: a cube resting on the ground and a second 0.004
  above it, with self-contact, SQP / Verschoor and QP / volume; the
  pair rows join from the second step;
* the float32 Fischer-Burmeister overflow of the reference: a valid row
  holding the 1e28 sentinel (a Verschoor row whose toi is outside [0, 1])
  squares to inf in float32, so the FB residual is inf and SQP runs to
  `max_outer`, in JAX's stepper and in the port's alike; in float64, and
  in float32 without the row, the same step stops earlier;
* a scene file with `constraintSolver SQP` (tests/test_qp.py:148-166, its
  cube written from models/primitives.py): JAX's run_scene against the
  port's CLI with --device cpu, equal iterStats.txt and status x.
"""

import os
import textwrap

import numpy as np
import pytest
import torch

from ipc_tpu import mesh as JM, timestepper as JT
from ipc_tpu.contact import halfspace as JH, pipeline as JPL
from ipc_tpu.models.primitives import cube
from ipc_tpu.qp.stepper import QPStepper as JQ
from ipc_tpu_torch import mesh as PM, timestepper as PT
from ipc_tpu_torch.contact import halfspace as PH, pipeline as PPL
from ipc_tpu_torch.convert import state_from_numpy
from ipc_tpu_torch.qp.stepper import QPStepper as PQ

JAX = (JM, JT, JH, JPL, JQ)
PORT = (PM, PT, PH, PPL, PQ)

# name: (mode, constraint type, two cubes, height of the (lower) cube)
SCENES = {
    "drop": ("SQP", "graphics", False, 0.004),
    "verschoor": ("SQP", "verschoor", True, 0.001),
    "volume": ("QP", "volume", True, 0.001),
}


def build(pkg, mode, ctype, two, y, dtype=np.float64, **kw):
    M, T, H, PL, Q = pkg
    parts = [(cube(1)[0] + np.array([0.0, y, 0.0]), cube(1)[1])]
    if two:  # 0.004 above the lower cube
        parts.append((cube(1)[0] + np.array([0.0, y + 1.004, 0.0]), cube(1)[1]))
    V, Te, comp, ranges = JM.merge_meshes(parts)
    dev = dict(dtype=torch.float64 if dtype == np.float64 else torch.float32, device="cpu")
    mesh, meta = M.build_mesh(V, Te, vert_comp=comp, comp_ranges=ranges,
                              **(dev if M is PM else dict(dtype=dtype)))
    sc = PL.SelfContact(mesh, meta) if two else None
    return Q(mesh, meta, T.SimParams(), halfspaces=[H.HalfSpace(H.HalfSpaceParams())],
             self_contact=sc, mode=mode, constraint_type=ctype, **kw)


def arrays(s):
    return dict(x=np.asarray(s.x), x_prev=np.asarray(s.x_prev), v=np.asarray(s.v),
                a=np.asarray(s.a), t=float(s.t), step=int(s.step))


def counts(stats):
    return stats.iters, list(stats.pcg_iters), list(stats.n_constraints)


def jax_step(jst, pre):
    import jax.numpy as jnp
    from dataclasses import replace

    template = jst.initial_state()
    s = replace(template, **{k: jnp.asarray(pre[k]) for k in ("x", "x_prev", "v", "a")},
                t=pre["t"], step=pre["step"])
    return jst.step(s)


def hold(jst, pst, n_steps, tag):
    """JAX's n_steps from rest, each taken by the port from JAX's state
    before it (module docstring). Returns the JAX stats per step."""
    s = jst.initial_state()
    out = []
    for i in range(n_steps):
        pre = arrays(s)
        s, js = jst.step(s)
        ps, pstats = pst.step(state_from_numpy(pre, "cpu", torch.float64))
        assert counts(pstats) == counts(js), (tag, i, counts(pstats), counts(js))
        np.testing.assert_allclose(pstats.grad_inf, js.grad_inf, rtol=1e-9, atol=1e-12)
        dx = float(np.abs(ps.x.numpy() - np.asarray(s.x)).max())
        tol = 1e-9
        if dx > tol:  # an ill-conditioned step: JAX's own 1-ulp response
            rng = np.random.default_rng(i)
            for _ in range(2):
                pert = dict(pre, x=pre["x"] + rng.choice([-1.0, 1.0], size=pre["x"].shape)
                            * np.spacing(np.abs(pre["x"])))
                sp, _ = jax_step(jst, pert)
                tol = max(tol, 2.0 * float(np.abs(np.asarray(sp.x) - np.asarray(s.x)).max()))
        assert dx <= tol, (tag, i, dx, tol)
        np.testing.assert_allclose(ps.v.numpy(), np.asarray(s.v), rtol=0, atol=tol / pst.dt)
        out.append(js)
    return out


@pytest.mark.parametrize("name", list(SCENES))
def test_qp_step_matches_jax(name):
    jst, pst = build(JAX, *SCENES[name]), build(PORT, *SCENES[name])
    stats = hold(jst, pst, 3, name)
    # the QP's objective, its gradient and the operator's tet blocks at a
    # deformed state
    s = jst.initial_state()
    x = np.asarray(s.x) + 0.01 * np.random.default_rng(1).standard_normal(s.x.shape)
    xt = np.asarray(jst.compute_x_tilde(s))
    px, pxt = torch.tensor(x), torch.tensor(xt)
    np.testing.assert_allclose(float(pst._qp_energy(px, pxt)),
                               float(jst._qp_energy(x, xt)), rtol=1e-12)
    np.testing.assert_allclose(pst._qp_grad(px, pxt).numpy(), np.asarray(jst._qp_grad(x, xt)),
                               rtol=0, atol=1e-10)
    np.testing.assert_allclose(pst._qp_hess_blocks(px).numpy(),
                               np.asarray(jst._qp_hess_blocks(x)), rtol=0, atol=1e-8)
    if name == "drop":
        assert any(200 in s.pcg_iters for s in stats[1:])  # ADMM's cap on contact
        assert all(n == 4 for s in stats for n in s.n_constraints)  # the ground rows
    else:
        assert max(stats[-1].n_constraints) > 4  # pair rows beside the ground's
    assert pst.operator_applications > 0 and pst.pcg_iterations > 0 and pst.host_syncs > 0


def _with_sentinel_row(st):
    """Wrap st._update_active_set to also add a PT row (a surface vertex
    against a surface triangle without it) with toi 2: outside [0, 1], so
    the Verschoor family gives it c = 1e28 and a zero gradient (a valid,
    inert QP row)."""
    tri = np.asarray(st.mesh.surf_tris)[0]
    p = next(int(v) for v in np.asarray(st.mesh.surf_verts) if v not in tri)
    vids = np.array([p, *tri])
    update = st._update_active_set

    def with_row(aset, x_start, x_target):
        added = update(aset, x_start, x_target)
        key = (False,) + tuple(int(v) for v in vids)
        if key not in aset:
            aset[key] = (vids.copy(), False, 2.0)
            added = True
        return added

    st._update_active_set = with_row
    return st


def test_float32_fb_overflow_of_the_reference_is_mirrored(capsys):
    max_outer = 4
    scene = ("SQP", "verschoor", False, 0.004)
    jst = _with_sentinel_row(build(JAX, *scene, dtype=np.float32, max_outer=max_outer))
    pst = _with_sentinel_row(build(PORT, *scene, dtype=np.float32, max_outer=max_outer))
    s0 = jst.initial_state()
    _, js = jst.step(s0, verbose=True)
    jax_out = capsys.readouterr().out
    _, ps = pst.step(state_from_numpy(arrays(s0), "cpu", torch.float32), verbose=True)
    port_out = capsys.readouterr().out
    # from the second iteration on the sentinel row is in the QP: fb = inf
    for out in (jax_out, port_out):
        assert out.count("fb=inf") == max_outer - 1, out
    assert js.iters == ps.iters == max_outer
    assert js.n_constraints == ps.n_constraints == [5] * max_outer
    # the same step stops earlier in float64, and in float32 without the row
    s64 = _with_sentinel_row(build(PORT, *scene, max_outer=max_outer))
    _, p64 = s64.step(state_from_numpy(arrays(s0), "cpu", torch.float64))
    s32 = build(PORT, *scene, dtype=np.float32, max_outer=max_outer)
    _, p32 = s32.step(state_from_numpy(arrays(s0), "cpu", torch.float32))
    assert p64.iters < max_outer and p32.iters < max_outer


SCENE = """
shapes input 1
{msh} 0 0.004 0  0 0 0  1 1 1
time 0.2 0.025
density 1000
stiffness 1e5 0.4
halfSpace  0 0 0  0 1 0  0  0
constraintSolver SQP
constraintType graphics
"""


def test_scene_file_sqp_matches_jax(tmp_path):
    from ipc_tpu.sim import run_scene as jax_run_scene
    from ipc_tpu_torch.__main__ import main
    from ipc_tpu_torch.io_mesh import write_msh

    msh = tmp_path / "cube.msh"
    write_msh(str(msh), *cube(1))
    scene = tmp_path / "qp_scene.txt"
    scene.write_text(textwrap.dedent(SCENE.format(msh=msh)))
    jax_run_scene(str(scene), out_dir=str(tmp_path / "jax"), n_steps=3)
    assert main([str(scene), "-o", str(tmp_path / "port"), "-n", "3", "--device", "cpu"]) == 0
    rows = {}
    for who in ("jax", "port"):
        with open(os.path.join(tmp_path, who, "iterStats.txt")) as f:
            rows[who] = [line.split() for line in f if line.strip()]
    assert len(rows["port"]) == len(rows["jax"]) > 3
    for p, j in zip(rows["port"], rows["jax"]):
        assert p[:3] == j[:3]
        np.testing.assert_allclose(float(p[3]), float(j[3]), rtol=1e-5)
    jx = np.load(tmp_path / "jax" / "status3.npz")["x"]
    px = np.load(tmp_path / "port" / "status3.npz")["x"]
    np.testing.assert_allclose(px, jx, rtol=0, atol=1e-9)
    assert max(int(r[2]) for r in rows["port"]) > 0  # the ground's rows were active
