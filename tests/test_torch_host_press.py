"""The host path's scripted press against the JAX package's IPCStepper.step,
in float64 on the CPU (held as tests/test_torch_host_step.py holds a
step; the analogs of tests/test_mdbc_al.py):

* blocked press: a scripted press blocked by contact runs the moving-DBC
  augmented Lagrangian, a sub-solve with every Dirichlet vertex free. Its
  first step (32 AL iterations; the second runs into the 100-iteration cap
  and takes a minute per package). The AL step is ill-conditioned: the
  packages agree to ~4e-7, within twice JAX's own 1-ulp response, with
  the same counts;
* free press: the scripted move completes and no AL runs.
"""

import numpy as np
import torch

from ipc_tpu_torch import mesh as PM
from ipc_tpu_torch.models.primitives import cube
from tests.test_torch_host_step import JAX, PORT, hold, run_jax


def _press(pkg, blocked=True):
    """test_mdbc_al's press: a soft cube on the ground and a fully scripted
    cube above it moving down 0.05 per step (blocked: 4 mm above it, with
    self-contact; free: alone, 2 above the ground)."""
    M, S, T, H, PL = pkg
    kw = dict(dtype=torch.float64, device="cpu") if M is PM else {}
    V2, T2 = cube(1)
    if not blocked:
        V2 = V2 + np.array([0.0, 2.0, 0.0])
        script = S.Script(n_verts=len(V2), dbc_groups=[
            S.DBCGroup(np.arange(len(V2)), np.array([0.0, -0.5, 0.0]))])
        mesh, meta = M.build_mesh(V2, T2, dbc_mask=script.dbc_mask(), **kw)
        return T.IPCStepper(mesh, meta, T.SimParams(), script=script)
    V1, T1 = cube(1)
    V, Te, comp, ranges = M.merge_meshes([(V1 + np.array([0.0, 0.002, 0.0]), T1),
                                          (V2 + np.array([0.0, 1.006, 0.0]), T2)])
    script = S.Script(n_verts=len(V), dbc_groups=[
        S.DBCGroup(np.arange(len(V1), len(V)), np.array([0.0, -2.0, 0.0]))])
    mesh, meta = M.build_mesh(V, Te, vert_comp=comp, comp_ranges=ranges,
                              dbc_mask=script.dbc_mask(), **kw)
    return T.IPCStepper(mesh, meta, T.SimParams(), halfspaces=[H.HalfSpace(H.HalfSpaceParams())],
                        self_contact=PL.SelfContact(mesh, meta, friction=0.0), script=script)


def test_blocked_press_runs_the_al_as_jax():
    jst, pst = _press(JAX), _press(PORT)
    rows = run_jax(jst, 1)
    out = hold(jst, pst, rows, "blocked press", n_ulp=1)
    assert all(r["stats"].al_iters > 0 for r in rows)
    x = out[-1][0].x.numpy()
    n1 = 8
    assert x[n1:, 1].min() < rows[0]["pre"]["x"][n1:, 1].min() - 0.01  # pressed down
    assert np.isfinite(x).all() and x[:, 1].min() > 0.0
    assert not bool(pst.sc.has_intersection(out[-1][0].x)[0])
    # projection restored: the all-free terms served the episode only
    assert set(pst._terms) == {False, True} and bool(pst.mesh.dbc_mask.any())


def test_free_press_skips_the_al():
    jst, pst = _press(JAX, blocked=False), _press(PORT, blocked=False)
    out = hold(jst, pst, run_jax(jst, 2), "free press")
    assert all(s.al_iters == 0 for _, s in out) and set(pst._terms) == {False}
    x, x0 = out[-1][0].x.numpy(), cube(1)[0][:, 1] + 2.0
    np.testing.assert_allclose(x[:, 1], x0 + 2 * 0.025 * -0.5, atol=1e-10)
