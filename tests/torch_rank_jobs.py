"""Rank jobs of the port's sharded tests (tests/test_torch_shard*.py,
tests/test_torch_spmd_broadphase.py), run by ipc_tpu_torch.parallel.launch
in spawned processes. This module imports neither jax nor the JAX package,
so a rank process loads neither; the spawned ranks find it on the caller's
sys.path.

  step_job    one step from each of spec["starts"] (numpy states, padded or
              not) on the rank's shard: rank_info plus the steps' records;
  pairs_job   the rank's share of broad phases on one padded mesh;
  terms_job   terms_values on the rank's shard (summed over the ranks);
  terms_values  the Newton gradient, energy and one operator application.
"""

import math

import numpy as np
import torch

from ipc_tpu_torch.parallel import jobs


def _state(st, arrays):
    """SimState of numpy arrays, padded to the stepper's mesh."""
    from ipc_tpu_torch.convert import state_from_numpy
    from ipc_tpu_torch.parallel.sharding import shard_state

    return shard_state(state_from_numpy(arrays, st.device, st.dtype), st.mesh)


def step_job(rank, world, device, spec):
    """spec: the scene's keys (jobs.rank_step), `starts`, `pad` (the rank
    count the mesh is padded for, default the group's)."""
    from ipc_tpu_torch.parallel.sharding import replicate

    st, step = jobs.rank_step(rank, world, device, spec, spec.get("pad"))
    rows = []
    for arrays in spec["starts"]:
        rows += jobs.steps(st, step, replicate(_state(st, arrays)), 1)[1]
    return dict(jobs.rank_info(st, rank), rows=rows)


def pairs_job(rank, world, device, spec):
    """The rank's share of broad phases on one padded mesh: spec has `mesh`
    (numpy arrays of a padded MeshData), `broadphase` ("grid" or "dense")
    and `cases`, a list of dict(x, disp (or None), gap). Returns, per case,
    dict(pt, ee, et) of (n,2) numpy primitive pairs."""
    from ipc_tpu_torch.contact.pipeline import SelfContact
    from ipc_tpu_torch.convert import mesh_from_numpy

    mesh = mesh_from_numpy(spec["mesh"], device, torch.float64)
    sc = SelfContact(mesh, None, broadphase=spec["broadphase"])

    def conv(a):
        return None if a is None else torch.as_tensor(np.asarray(a, np.float64), device=device)

    out = []
    for case in spec["cases"]:
        fams = sc.candidate_pairs(conv(case["x"]), conv(case.get("disp")), case["gap"],
                                  with_et=True)
        out.append(dict(zip(("pt", "ee", "et"), (p.cpu().numpy() for p, _ in fams))))
    return out


def terms_values(st, arrays, v_np):
    """dict(g, E, Av) at the state `arrays` (numpy, padded): the Newton
    gradient, energy and the operator applied to v_np (V,3) over the
    candidates at x, with friction and kappa as the step's first iteration
    sets them up."""
    from ipc_tpu_torch.step_terms import build_terms

    s = _state(st, arrays)
    T = build_terms(st)
    x, dHat = s.x, st.dHat
    x_tilde = st.compute_x_tilde(s)
    cand = st.sc.build_candidates(x, None, math.sqrt(dHat), with_et=False)
    kappa = torch.tensor(st.suggest_kappa(dHat), dtype=st.dtype, device=st.device)
    fric = T.capture_friction(x, s.x_prev, kappa, dHat, cand, None, None,
                              st.fric_dhat_target)
    act = st.sc.active_set(x, cand, dHat)
    g = T.gradient(x, x_tilde, kappa, dHat, fric, None, None, act, None, None, T.dbc)
    E = T.e_float(T.energy(x, x_tilde, kappa, dHat, fric, act=act))
    op = T.newton_system(x, kappa, dHat, act, fric, None, None, None, T.dbc)[0]
    Av = op(torch.as_tensor(v_np, device=st.device).to(st.dtype))
    return dict(g=g.cpu().numpy(), E=E, Av=Av.cpu().numpy())


def terms_job(rank, world, device, spec):
    """terms_values of spec's scene at spec["state"] with spec["v"], on
    rank's shard (summed over the ranks)."""
    from ipc_tpu_torch.parallel.sharding import shard_stepper
    from ipc_tpu_torch.scenes import build_scene

    st = build_scene(spec["n_cells"], spec["dtype"], device, with_contact=True)
    return terms_values(shard_stepper(st, world, rank), spec["state"], spec["v"])
