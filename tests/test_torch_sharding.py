"""The port's sharding plan (ipc_tpu_torch/parallel/sharding.py) against
ipc_tpu.parallel.sharding, and the sums over ranks of the Newton terms.

* for 2, 4 and 8 ranks, on cube(1) and on the two-box scene, the port's
  padded mesh and state equal the JAX package's `shard_mesh_data` /
  `shard_state` (over the conftest's virtual CPU devices) bit for bit, and
  the JAX arrays carried over as numpy (`convert.mesh_from_numpy`) equal
  them too;
* elasticity over the padded mesh equals the unpadded value (rtol 1e-12,
  as tests/test_multichip.py holds the JAX padding);
* the gradient, the energy and one Newton-operator application of the
  two-box scene in contact (step 8's state), split over 2 gloo ranks on
  the CPU and summed, equal the unsharded values within 1e-12 relative;
* the padded mesh changes the unsharded step only through its coarse
  aggregates.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from ipc_tpu.mesh import build_mesh as jax_build_mesh
from ipc_tpu.models.primitives import cube
from ipc_tpu.parallel.sharding import make_mesh
from ipc_tpu.parallel.sharding import shard_mesh_data as jax_shard_mesh_data
from ipc_tpu.parallel.sharding import shard_state as jax_shard_state
from ipc_tpu_torch.convert import mesh_from_numpy, state_from_numpy, state_to_numpy
from ipc_tpu_torch.energy import elasticity as EL
from ipc_tpu_torch.jit_step import make_step
from ipc_tpu_torch.mesh import MESH_FIELDS, build_mesh
from ipc_tpu_torch.parallel.launch import launch
from ipc_tpu_torch.parallel.sharding import shard_mesh_data, shard_state, shard_stepper
from ipc_tpu_torch.scenes import build_scene

from torch_rank_jobs import terms_job, terms_values


def _jax_numpy(obj, names):
    return {k: np.asarray(getattr(obj, k)) for k in names}


def _meshes(which):
    """(JAX MeshData, port MeshData, JAX SimState, port SimState) of the
    same scene, float64 on the CPU, the states moved off rest."""
    if which == "cube":
        V, T = cube(1)
        jm, _ = jax_build_mesh(V, T)
        pm, _ = build_mesh(V, T, dtype=torch.float64, device="cpu")
        from ipc_tpu.timestepper import SimState as JaxSimState
        from ipc_tpu_torch.timestepper import SimState

        rng = np.random.default_rng(1)
        x = np.asarray(jm.x_rest) + rng.uniform(-0.05, 0.05, np.asarray(jm.x_rest).shape)
        v = rng.normal(size=x.shape)
        js = JaxSimState(x=jnp.asarray(x), x_prev=jnp.asarray(x), v=jnp.asarray(v),
                         a=jnp.asarray(v * 0.5))
        ps = SimState(x=torch.as_tensor(x), x_prev=torch.as_tensor(x), v=torch.as_tensor(v),
                      a=torch.as_tensor(v * 0.5))
        return jm, pm, js, ps
    jst = ge._build_scene(n_cells=2, dtype=np.float64, with_contact=True)
    pst = build_scene(2, torch.float64, "cpu", with_contact=True)
    js = jst.initial_state()
    js = dataclasses.replace(js, v=js.v + 0.25, a=js.a - 0.5)
    ps = state_from_numpy(dict(x=np.asarray(js.x), x_prev=np.asarray(js.x_prev),
                               v=np.asarray(js.v), a=np.asarray(js.a)), "cpu", torch.float64)
    return jst.mesh, pst.mesh, js, ps


@pytest.mark.parametrize("which", ["cube", "boxes"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_padding_matches_jax_bitwise(which, n):
    jm, pm, js, ps = _meshes(which)
    jpad = jax_shard_mesh_data(jm, make_mesh(n))
    ppad, rows = shard_mesh_data(pm, n, rank=n - 1)
    want = _jax_numpy(jpad, MESH_FIELDS)
    carried = mesh_from_numpy(want, "cpu", torch.float64)
    for k in MESH_FIELDS:
        got = getattr(ppad, k).numpy()
        assert got.shape == want[k].shape, k
        assert got.shape[0] % n == 0, k
        np.testing.assert_array_equal(got, want[k].astype(got.dtype), err_msg=k)
        assert torch.equal(getattr(carried, k), getattr(ppad, k)), k
    assert int(ppad.x_rest.shape[0]) - int(pm.x_rest.shape[0]) >= 1
    for k, (a, b) in rows.items():
        N = int(getattr(ppad, k).shape[0])
        assert (a, b) == (N * (n - 1) // n, N), k
    jstate = jax_shard_state(js, make_mesh(n), jpad)
    pstate = shard_state(ps, ppad)
    for k in ("x", "x_prev", "v", "a"):
        np.testing.assert_array_equal(getattr(pstate, k).numpy(), np.asarray(getattr(jstate, k)),
                                      err_msg=k)


@pytest.mark.parametrize("n", [2, 8])
def test_padded_elasticity_equals_unpadded(n):
    V, T = cube(1)
    mesh, _ = build_mesh(V, T, dtype=torch.float64, device="cpu")
    padded, _ = shard_mesh_data(mesh, n)
    assert float(padded.vol[6:].sum()) == 0.0
    rng = np.random.default_rng(0)
    x = mesh.x_rest + torch.as_tensor(rng.uniform(-0.05, 0.05, (len(V), 3)))
    xp = torch.cat([x, padded.x_rest[len(V):]])
    for model in ("NH", "FCR"):
        e0 = EL.elasticity_energy_per_elem(x, mesh, model).sum().item()
        e1 = EL.elasticity_energy_per_elem(xp, padded, model).sum().item()
        np.testing.assert_allclose(e1, e0, rtol=1e-12)
        step = EL.filter_step_size(xp, torch.zeros_like(xp).index_fill_(0, torch.arange(len(V)),
                                                                        0.01), padded, model)
        assert bool(torch.isfinite(step) | torch.isinf(step))


@pytest.fixture(scope="module")
def contact_state():
    """The two-box scene's state before step 8 (the port, float64, CPU),
    padded for 2 ranks, and a seeded vector."""
    st = build_scene(2, torch.float64, "cpu", with_contact=True)
    step = make_step(st)
    s = st.initial_state()
    for _ in range(8):
        s, _ = step(s)
    padded, _ = shard_mesh_data(st.mesh, 2)
    arrays = state_to_numpy(shard_state(s, padded))
    v = np.random.default_rng(3).normal(size=arrays["x"].shape)
    return arrays, v


def test_sharded_terms_sum_to_the_unsharded(contact_state):
    arrays, v = contact_state
    spec = dict(n_cells=2, dtype="float64", with_contact=True, state=arrays, v=v)
    ref = terms_values(shard_stepper(build_scene(2, torch.float64, "cpu", with_contact=True), 2),
                       arrays, v)
    outs = launch(terms_job, 2, "gloo", "cpu", (spec,), timeout=300)
    assert np.abs(ref["g"]).max() > 0 and np.abs(ref["Av"]).max() > 0
    for o in outs:
        for k in ("g", "Av"):
            err = np.abs(o[k] - ref[k]).max() / np.abs(ref[k]).max()
            assert err <= 1e-12, (k, err)
        np.testing.assert_allclose(o["E"], ref["E"], rtol=1e-12)
    # the ranks hold the same bits
    for k in ("g", "Av"):
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def test_the_padding_moves_the_step_through_its_aggregates(contact_state, monkeypatch):
    """The mesh padded for 2 ranks changes the unsharded step 8 only through
    its coarse aggregates: the sentinel at bbox_max + 4 max(diag, 1)
    stretches build_aggregates' Morton grid, so the real vertices fall into
    other aggregates. Given the unpadded mesh's aggregates (the sentinels
    in the last one), the padded step takes the unpadded step's Newton and
    PCG counts, and its x lies within max(1e-12, twice the unpadded step's
    response to a 1-ulp change of x); with its own it takes another Newton
    path. Prints each variant's counts and distance from the unpadded x."""
    from ipc_tpu_torch import step_terms
    from ipc_tpu_torch.solver.coarse import build_aggregates

    pre = contact_state[0]
    plain = build_scene(2, torch.float64, "cpu", with_contact=True)
    V0 = int(plain.mesh.x_rest.shape[0])
    own_agg, _ = build_aggregates(np.concatenate([plain.mesh.x_rest.numpy(),
                                                  pre["x"][V0:]]))
    unpadded_agg, C = build_aggregates(plain.mesh.x_rest.numpy())
    assert not np.array_equal(own_agg[:V0], unpadded_agg)

    def unpadded_aggregates(x_rest):
        return np.concatenate([unpadded_agg, np.full(len(x_rest) - V0, C - 1, np.int32)]), C

    def run(st, rows, patterns=0):
        step = make_step(st)
        arrays = {k: pre[k][:rows] for k in ("x", "x_prev", "v", "a")}
        arrays.update(t=pre["t"], step=pre["step"])
        s, stats = step(state_from_numpy(arrays, "cpu", torch.float64))
        rng = np.random.default_rng(8)
        resp = 0.0
        for _ in range(patterns):
            x = arrays["x"] + rng.choice([-1.0, 1.0], arrays["x"].shape) * np.spacing(
                np.abs(arrays["x"]))
            sp, _ = step(state_from_numpy(dict(arrays, x=x), "cpu", torch.float64))
            resp = max(resp, float(np.abs(sp.x.numpy() - s.x.numpy())[:V0].max()))
        return s.x.numpy()[:V0], (stats.newton_iters, stats.pcg_iters_total), resp

    x0, counts0, resp0 = run(plain, V0, patterns=2)
    x1, counts1, _ = run(shard_stepper(build_scene(2, torch.float64, "cpu",
                                                       with_contact=True), 2), len(pre["x"]))
    monkeypatch.setattr(step_terms, "build_aggregates", unpadded_aggregates)
    x2, counts2, _ = run(shard_stepper(build_scene(2, torch.float64, "cpu",
                                                       with_contact=True), 2), len(pre["x"]))
    print(f"step 8 newton/pcg: unpadded {counts0} (1-ulp response {resp0:.3e}); padded "
          f"{counts1} (|dx| {np.abs(x1 - x0).max():.3e}); padded with the unpadded "
          f"aggregates {counts2} (|dx| {np.abs(x2 - x0).max():.3e})")
    assert counts2 == counts0
    np.testing.assert_allclose(x2, x0, rtol=0, atol=max(1e-12, 2.0 * resp0))
    assert counts1 != counts0
