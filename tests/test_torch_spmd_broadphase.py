"""The sharded broad phase (SelfContact.candidate_pairs under an active
group: spatial_hash.fused_candidates with shard=, or the rank's share of the
whole set) against the JAX package's single-device fused_candidates, on
gloo ranks on the CPU.

On 2 and 4 ranks, over the JAX package's padded mesh and x:
* the union of the ranks' PT / EE / ET primitive-pair sets equals
  ipc_tpu.contact.spatial_hash.fused_candidates' set;
* no pair is on two ranks, and no pair touches a sentinel vertex;
* the scene of tests/test_spmd_broadphase.py (two overlapping box_grid(3)
  boxes, a quarter of the first pinned) through the grid's query shards
  and through the dense path's shares, unswept and swept;
* a box_grid(3) cube over a two-triangle meshCO plate, whose oversized
  primitives take the whole set on every rank and keep 1/n of it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ipc_tpu import mesh as JM
from ipc_tpu.contact import spatial_hash as JSH
from ipc_tpu.contact.pipeline import SelfContact as JSelfContact
from ipc_tpu.mesh import build_mesh, merge_meshes
from ipc_tpu.models.primitives import box_grid
from ipc_tpu.parallel.sharding import make_mesh, shard_mesh_data
from ipc_tpu_torch.mesh import MESH_FIELDS
from ipc_tpu_torch.parallel.launch import launch

from torch_rank_jobs import pairs_job

CAP = 8192
K = 64
PLATE_V = np.array([[-2.0, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]]) + np.array([0.5, 0, 0.5])
PLATE_F = np.array([[0, 2, 1], [0, 3, 2]])


def _boxes():
    """tests/test_spmd_broadphase.py's scene."""
    V1, T1 = box_grid(3, 3, 3)
    V2, T2 = box_grid(3, 3, 3)
    V2 = V2 + np.array([0.55, 0.1, 0.07])
    V, T, comp, ranges = merge_meshes([(V1, T1), (V2, T2)])
    mesh, _ = build_mesh(V, T, vert_comp=comp, comp_ranges=ranges)
    dbc = np.asarray(mesh.dbc_mask).copy()
    dbc[: len(V1) // 4] = True
    return dataclasses.replace(mesh, dbc_mask=jnp.asarray(dbc)), None


def _plate():
    V, T = box_grid(3, 3, 3)
    jm, jmeta = JM.build_mesh(V + np.array([0.0, 0.005, 0.0]), T)
    jm, jmeta, _ = JM.append_kinematic_surface(jm, jmeta, PLATE_V, tris=PLATE_F)
    return jm, jmeta


def _set(pairs, unordered=False):
    p = np.asarray(pairs)
    p = p[p[:, 0] >= 0]
    return [frozenset(r) if unordered else tuple(r) for r in p.tolist()]


@pytest.fixture(scope="module")
def jax_fused():
    return jax.jit(JSH.fused_candidates,
                   static_argnames=("cap_pt", "cap_ee", "cap_et", "K", "with_et"))


def _cases(padded, n_real):
    x = np.asarray(padded.x_rest)
    disp = np.random.default_rng(5).normal(scale=0.02, size=x.shape)
    disp[n_real:] = 0.0
    return [dict(x=x, disp=None, gap=0.05), dict(x=x, disp=disp, gap=0.01)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("scene,broadphase", [("boxes", "grid"), ("boxes", "dense"),
                                              ("plate", "grid")])
def test_rank_sets_partition_the_single_device_set(jax_fused, n, scene, broadphase):
    jm, jmeta = _boxes() if scene == "boxes" else _plate()
    V0 = int(jm.x_rest.shape[0])
    padded = shard_mesh_data(jm, make_mesh(n))
    padded = type(padded)(**{k: jnp.asarray(np.asarray(getattr(padded, k)))
                             for k in MESH_FIELDS})
    big = None
    if scene == "plate":
        jsc = JSelfContact(padded, jmeta, broadphase="grid")
        big = jsc.big
        assert big is not None and big["tri_ids"] is not None
    arrays = {k: np.asarray(getattr(padded, k)) for k in MESH_FIELDS}
    cases = _cases(padded, V0)
    spec = dict(mesh=arrays, broadphase=broadphase, cases=cases)
    outs = launch(pairs_job, n, "gloo", "cpu", (spec,), timeout=300)
    sv, se, st = arrays["surf_verts"], arrays["surf_edges"], arrays["surf_tris"]
    for c, case in enumerate(cases):
        d = None if case["disp"] is None else jnp.asarray(case["disp"])
        ref = jax_fused(padded.x_rest, padded.surf_verts, padded.surf_edges, padded.surf_tris,
                        padded.dbc_mask, cap_pt=CAP, cap_ee=CAP, cap_et=CAP, disp=d,
                        gap=case["gap"], K=K, with_et=True, big=big)
        assert int(ref["overflow"]) <= K
        for fam in ("pt", "ee", "et"):
            unordered = fam == "ee"
            want = _set(ref[fam][0], unordered)
            assert 0 < len(want) < CAP, fam
            per_rank = [_set(o[c][fam], unordered) for o in outs]
            union = [p for r in per_rank for p in r]
            assert len(union) == len(set(union)), f"{fam}: a pair on two ranks"
            assert set(union) == set(want), fam
            assert all(len(r) < len(want) for r in per_rank), f"{fam}: one rank holds all"
            pairs = np.concatenate([o[c][fam] for o in outs])
            if fam == "pt":
                verts = np.concatenate([sv[pairs[:, 0]][:, None], st[pairs[:, 1]]], axis=1)
            elif fam == "ee":
                verts = np.concatenate([se[pairs[:, 0]], se[pairs[:, 1]]], axis=1)
            else:
                verts = np.concatenate([se[pairs[:, 0]], st[pairs[:, 1]]], axis=1)
            assert verts.max() < V0, f"{fam}: a pair touches a sentinel"
