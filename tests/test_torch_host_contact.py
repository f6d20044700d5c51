"""The host path with self-contact against the JAX package's IPCStepper.step,
in float64 on the CPU (held as tests/test_torch_host_step.py holds it:
identical per-step counts, x within 1e-9 or twice JAX's 1-ulp response).

* boxes: the bench scene at n_cells=2 (two box_grid boxes on a frictional
  ground, self-contact with friction 0.1). JAX runs 10 host steps from
  rest; the upper box lands in step 8, and steps 8-9 are taken by the port
  from JAX's states: a fresh broad phase every Newton iteration, the
  global intersection safeguard, kappa doubling over the candidate
  distances, self-friction. Step 9 is ill-conditioned: JAX's own counts
  change under a 1-ulp change of x (its PCG counts flip at the tolerance
  and the line search follows), and the port's counts must be one such
  outcome of JAX's (test_torch_host_step.hold);
* cube on plate: a box_grid(3) cube sliding on a two-triangle kinematic
  plate (tet-less DBC vertices, plate mu 0.2, selfFric 0); 2 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ipc_tpu import mesh as JM
from ipc_tpu.contact.pipeline import SelfContact as JSelfContact
from ipc_tpu.timestepper import IPCStepper as JStepper
from ipc_tpu.timestepper import SimParams as JParams
from ipc_tpu_torch import mesh as PM
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.models.primitives import box_grid
from ipc_tpu_torch.scenes import build_scene
from ipc_tpu_torch.timestepper import IPCStepper, SimParams
from tests.test_torch_host_step import hold, run_jax

PLATE_V = np.array([[-2.0, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]]) + np.array([0.5, 0, 0.5])
PLATE_F = np.array([[0, 2, 1], [0, 3, 2]])


@pytest.fixture(scope="module")
def boxes():
    jst = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=True)
    return jst, run_jax(jst, 10)


@pytest.mark.parametrize("i", [8, 9])
def test_boxes_impact_matches_jax(boxes, i):
    jst, rows = boxes
    pst = build_scene(2, torch.float64, "cpu", with_contact=True)
    (ps, stats), = hold(jst, pst, [rows[i]], f"boxes step {i}")
    assert max(stats.n_constraints) > 0  # the boxes touch
    assert ps.x[:, 1].min().item() > 0.0
    assert not bool(pst.sc.has_intersection(ps.x)[0])
    if i == 9:
        assert stats.iters > 1 and pst.host_syncs > 0 and pst.operator_applications > 0


def test_cube_on_meshco_plate_matches_jax():
    V, T = box_grid(3, 3, 3)
    V = V + np.array([0.0, 0.001, 0.0])
    steppers = []
    for M, SC, St, Pa in ((JM, JSelfContact, JStepper, JParams),
                          (PM, SelfContact, IPCStepper, SimParams)):
        kw = dict(dtype=torch.float64, device="cpu") if M is PM else {}
        m, meta = M.build_mesh(V, T, **kw)
        m, meta, (p0, p1) = M.append_kinematic_surface(m, meta, PLATE_V, tris=PLATE_F)
        vert_mu = np.where(np.arange(p1) >= p0, 0.2, 0.0)
        sc = SC(m, meta, friction=0.0, vert_mu=jnp.asarray(vert_mu) if M is JM else vert_mu)
        steppers.append(St(m, meta, Pa(), self_contact=sc))
    jst, pst = steppers
    assert pst.sc.broadphase == "dense" and pst._solve_fric
    v0 = np.zeros((p1, 3))
    v0[:p0, 0] = 0.5  # the cube slides along the plate
    rows = run_jax(jst, 2, start=jst.initial_state(v0=v0))
    out = hold(jst, pst, rows, "cube on plate")
    for ps, _ in out:
        assert torch.equal(ps.x[p0:p1], pst.mesh.x_rest[p0:p1])
        assert ps.x[:p0, 1].min().item() > 0.0
    assert 0.0 < out[-1][0].v[:p0, 0].mean().item() < 0.5  # the plate's friction
