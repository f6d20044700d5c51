"""Self-contact pipeline: broad phase -> candidates -> barrier, friction, CCD
and the intersection check, in the shape the production step consumes.

Port of ipc_tpu/contact/pipeline.py. Candidate and active sets are
exact-size tensors: the JAX package's fixed capacities, -1 padding, valid
masks and `ensure_*` regrow are TPU devices and are not ported; the true
counts stay, so a step's stats compare with the JAX package's.

Every value read back to the host (set sizes) goes through
utils/observability's `host_read`, which counts it. The layers are spans
there: `broadphase` (build_candidates, has_intersection's query),
`active_set`, `pairs` (the active pairs' energy, gradient and blocks, the
friction capture) and `ccd` with `accd_pt` / `accd_ee` (or `ti_pt` /
`ti_ee`) inside. The active pairs' energy, gradient and blocks go through
contact/pair_terms.py: one kernel launch per family on the card, the plain
per-pair functions of contact/selfcollision.py elsewhere.

`ccd_method` picks ACCD ("accd") or, with "ti", the per-pair maximum of
the interval CCD and ACCD (both conservative, so their maximum is too).

Kinematic collision objects: `vert_mu` (V,) holds each object vertex's
friction coefficient (0 on deformable vertices); a friction pair touching
one takes the largest such mu of its stencil instead of `friction`. On the
grid path, primitives far larger than the deformable ones (an obstacle's
plane triangles) are swept densely (`big`, spatial_hash.py).

The host path's energy runs over a whole candidate set: `candidate_set`
views one as an ActiveSet (no compaction, no host read), so
`energy_active` evaluates every candidate pair, as the JAX package's
`energy`/`energy_df` do. Its moving-DBC episode frees every Dirichlet
vertex, which the JAX package does by rebinding the pipeline to an
all-False mask: `build_candidates` and `has_intersection` take
`dbc_free=True` for that, with the oversized primitives classified against
the same mask.

Sharded (under parallel/spmd's active group; `rebind_mesh` points the
pipeline at a padded mesh): each rank's candidate sets are its share of
the pairs, disjoint across ranks, their union the unsharded set. The grid
shards its queries (spatial_hash.fused_candidates with shard=); a scene with
oversized primitives, like the dense path, computes the whole set on every
rank and keeps the rank's contiguous 1/n of it (the JAX package takes its
replicated broad phase there). The active set, the barrier terms and the
friction capture then run over the rank's pairs, and the set sizes stay
the rank's own (the step sums them for its stats). `ccd_alpha` takes the
minimum over ranks, `intersects_pairs` and `has_intersection` an "any":
every rank must call them.

Not ported: the full-candidate `gradient/hessian_blocks/n_active/et_pairs`
helpers (the active set gives the same values: the barrier and its
derivatives vanish beyond dHat).
"""

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from ipc_tpu_torch.contact import broadphase as BP
from ipc_tpu_torch.contact import pair_terms as PAIRS
from ipc_tpu_torch.contact import selfcollision as SC
from ipc_tpu_torch.contact import spatial_hash as SH
from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt, ti_ee, ti_pt
from ipc_tpu_torch.contact.intersection import any_edge_tri_intersection
from ipc_tpu_torch.ops.compensated import df_add, df_scale, df_sum
from ipc_tpu_torch.ops.distance import edge_edge_dist2, eps_x_ee, point_triangle_dist2
from ipc_tpu_torch.ops.scatter import make_dynamic_gather_sum
from ipc_tpu_torch.parallel import spmd
from ipc_tpu_torch.parallel.sharding import row_range
from ipc_tpu_torch.utils.observability import host_read, span

__all__ = ["Candidates", "ActiveSet", "SelfContact", "compact"]


def compact(*masks):
    """Ascending indices of the True entries of each 1-D mask (what
    `torch.nonzero` gives), with one host read for all of them: the counts,
    then a stable sort per mask. Returns (list of index tensors, counts)."""
    counts = host_read("compact", torch.stack([m.sum() for m in masks]))
    idx = [torch.sort((~m).to(torch.uint8), stable=True).indices[:n]
           for m, n in zip(masks, counts)]
    return idx, counts


@dataclass(frozen=True)
class Candidates:
    """One broad phase's candidate stencils (exact size)."""

    pt_vids: torch.Tensor  # (Npt,4) int64 stencils (p, t0, t1, t2)
    ee_vids: torch.Tensor  # (Nee,4) int64 stencils (a0, a1, b0, b1)
    ee_eps_x: torch.Tensor  # (Nee,) mollifier thresholds (rest shape)
    et_pairs: torch.Tensor  # (Net,2) int64 (surface edge, surface triangle)
    pt_count: int
    ee_count: int
    et_count: int


@dataclass
class ActiveSet:
    """The candidates that can contribute a nonzero barrier term (exact
    size); `vert_sum` is the gather-sum over cat(vids_p, vids_e), built on
    first use (SelfContact.vert_sum)."""

    vids_p: torch.Tensor
    vids_e: torch.Tensor
    eps_e: torch.Tensor
    cnt_pt: int
    cnt_ee: int
    vert_sum: object = None


class SelfContact:
    """Per-scene self-contact handler."""

    # above this many primitives per side the spatial hash replaces the
    # dense all-pairs mask (ipc_tpu/contact/pipeline.py:103)
    DENSE_LIMIT = 512
    BIG_FACTOR = 8.0  # oversized past this x the deformable median extent
    BIG_MAX = 512  # dense-sweep budget; only the largest qualify

    def __init__(self, mesh, meta, friction=0.0, vert_mu=None, broadphase=None,
                 ccd_method="accd"):
        if ccd_method not in ("accd", "ti"):
            raise ValueError(f"ccd_method={ccd_method!r}: 'accd' or 'ti'")
        self.mesh = mesh
        self.meta = meta
        self.friction = friction
        self.ccd_method = ccd_method
        if vert_mu is not None:
            vert_mu = torch.as_tensor(vert_mu, device=mesh.device).to(mesh.dtype)
            if vert_mu.shape != mesh.x_rest.shape[:1]:
                raise ValueError(f"vert_mu {tuple(vert_mu.shape)}: one value per vertex "
                                 f"({mesh.x_rest.shape[0]})")
        self.vert_mu = vert_mu
        nS = int(mesh.surf_tris.shape[0])
        nE = int(mesh.surf_edges.shape[0])
        nV = int(mesh.surf_verts.shape[0])
        if broadphase is None:
            broadphase = "grid" if max(nS, nE, nV) > self.DENSE_LIMIT else "dense"
        self.broadphase = broadphase
        self.big = self._classify_big(mesh) if broadphase == "grid" else None
        self.tab = SC.SlotTables(mesh.x_rest.device, mesh.x_rest.dtype)
        self._free = None  # (all-False mask, its big classification), built on use

    def rebind_mesh(self, mesh):
        """Point the pipeline at a reshaped mesh (parallel.sharding's padded
        one): the oversized primitives are classified again against its
        rows, and `vert_mu` gets 0 on the padding vertices."""
        if self.vert_mu is not None and self.vert_mu.shape[0] < mesh.x_rest.shape[0]:
            pad = mesh.x_rest.shape[0] - self.vert_mu.shape[0]
            self.vert_mu = torch.cat([self.vert_mu, self.vert_mu.new_zeros(pad)])
        self.mesh = mesh
        self.big = self._classify_big(mesh) if self.broadphase == "grid" else None
        self._free = None

    def _classify_big(self, mesh, dbc=None):
        """Oversized primitives from the rest shape: extent above BIG_FACTOR x
        the median extent of the primitives that are not all-DBC (obstacle
        primitives must not set the median they are measured against); the
        BIG_MAX largest when more qualify, with a warning. dict(tri_ids,
        tri_mask, edge_ids, edge_mask) on the mesh's device (None entries
        for a family without any), or None when no primitive qualifies.
        `dbc` (numpy bool) overrides the mesh's mask."""
        xr = mesh.x_rest.detach().cpu().numpy()
        dbc = mesh.dbc_mask.cpu().numpy() if dbc is None else dbc
        out = {}
        for name, prims in (("tri", mesh.surf_tris.cpu().numpy()),
                            ("edge", mesh.surf_edges.cpu().numpy())):
            ids = mask = None
            if prims.shape[0]:
                P = xr[prims]
                ext = (P.max(axis=1) - P.min(axis=1)).max(axis=1)
                free = ~dbc[prims].all(axis=1)
                ref_ext = ext[free] if free.any() else ext
                thr = self.BIG_FACTOR * max(float(np.median(ref_ext)), 1e-30)
                sel = np.nonzero(ext > thr)[0]
                if sel.size > self.BIG_MAX:
                    warnings.warn(
                        f"big-prim dense sweep: {name} truncated to the largest "
                        f"{self.BIG_MAX} of {sel.size} qualifying prims "
                        f"({sel.size - self.BIG_MAX} oversized prims stay in the hash grid "
                        f"and may still inflate the shared cell)")
                    sel = sel[np.argsort(ext[sel])[-self.BIG_MAX:]]
                if sel.size:
                    m = np.zeros(prims.shape[0], bool)
                    m[sel] = True
                    ids = torch.as_tensor(np.sort(sel), device=mesh.device)
                    mask = torch.as_tensor(m, device=mesh.device)
            out[name + "_ids"] = ids
            out[name + "_mask"] = mask
        return out if any(v is not None for v in out.values()) else None

    def _mask_and_big(self, dbc_free):
        """(Dirichlet mask, oversized primitives) of the broad phase: the
        mesh's, or with dbc_free an all-False mask and its classification."""
        if not dbc_free:
            return self.mesh.dbc_mask, self.big
        if self._free is None:
            mask = torch.zeros_like(self.mesh.dbc_mask)
            big = (self._classify_big(self.mesh, mask.cpu().numpy())
                   if self.broadphase == "grid" else None)
            self._free = (mask, big)
        return self._free

    # -- candidate construction ---------------------------------------------

    def _comoving(self, disp):
        """Subtract the mean surface-vertex displacement: pairwise swept
        proximity depends only on relative motion."""
        if disp is None:
            return None
        return disp - disp[self.mesh.surf_verts].mean(dim=0)

    @staticmethod
    def _rank_share(pairs):
        """The active group's rank's contiguous 1/n of a whole pair set."""
        a, b = row_range(int(pairs.shape[0]), spmd.rank(), spmd.world())
        return pairs[a:b], b - a

    def candidate_pairs(self, x, disp=None, gap=0.0, with_et=True, dbc_free=False):
        """One broad phase's surface-primitive pairs: ((pt (n,2), n), (ee,
        n), (et, n)) of (vertex, triangle), (edge, edge) and (edge,
        triangle) ids; under an active group the rank's share (module
        docstring). Arguments as build_candidates'."""
        mesh = self.mesh
        dbc, big = self._mask_and_big(dbc_free)
        disp = self._comoving(disp)
        sharded = spmd.active_group() is not None
        if self.broadphase == "grid":
            shard = (spmd.rank(), spmd.world()) if sharded and big is None else None
            fused = SH.fused_candidates(x, mesh.surf_verts, mesh.surf_edges, mesh.surf_tris,
                                        dbc, disp, gap, with_et=with_et, big=big, shard=shard)
            sharded = sharded and shard is None  # else already the rank's share
            out = [fused["pt"], fused["ee"], fused["et"]]
        else:
            pt, pt_n = BP.pt_candidates(x, mesh.surf_verts, mesh.surf_tris, dbc, disp, gap)
            ee, ee_n = BP.ee_candidates(x, mesh.surf_edges, dbc, disp, gap)
            if with_et:
                et, et_n = BP.et_candidates(x, mesh.surf_edges, mesh.surf_tris, disp, gap, dbc)
            else:
                et = torch.zeros((0, 2), dtype=torch.int64, device=x.device)
                et_n = 0
            out = [(pt, pt_n), (ee, ee_n), (et, et_n)]
        if sharded:
            out = [self._rank_share(p) for p, _ in out]
        return out

    def build_candidates(self, x, disp=None, gap=0.0, with_et=True, dbc_free=False):
        """One broad phase: PT and EE barrier/CCD stencils plus the swept
        edge-triangle pairs of the intersection check, swept along `disp`
        in the co-moving frame and inflated by `gap`. dbc_free: as if no
        vertex were Dirichlet (module docstring)."""
        mesh = self.mesh
        with span("broadphase"):
            (pt, pt_n), (ee, ee_n), (et, et_n) = self.candidate_pairs(x, disp, gap, with_et,
                                                                      dbc_free)
            pt_vids = torch.cat([mesh.surf_verts[pt[:, 0]][:, None],
                                 mesh.surf_tris[pt[:, 1]]], dim=1)
            ee_vids = torch.cat([mesh.surf_edges[ee[:, 0]], mesh.surf_edges[ee[:, 1]]], dim=1)
            xr = mesh.x_rest
            ee_eps_x = eps_x_ee(xr[ee_vids[:, 0]], xr[ee_vids[:, 1]], xr[ee_vids[:, 2]],
                                xr[ee_vids[:, 3]])
        return Candidates(pt_vids=pt_vids, ee_vids=ee_vids, ee_eps_x=ee_eps_x,
                          et_pairs=et, pt_count=pt_n, ee_count=ee_n, et_count=et_n)

    # -- active-set compaction ------------------------------------------------

    def active_set(self, x, cand, dHat, disp=None):
        """The candidates with d^2 < dHat at x or, given `disp`, possibly
        anywhere on [x, x + disp] (per-pair travel bound in the co-moving
        frame)."""
        with span("active_set"):
            return self._active_set(x, cand, dHat, disp)

    def _active_set(self, x, cand, dHat, disp):
        disp = self._comoving(disp)
        d_pt, d_ee = SC.active_dist2(x, cand.pt_vids, cand.ee_vids, self.tab)
        if disp is None:
            act_pt = d_pt < dHat
            act_ee = d_ee < dHat
        else:
            dn = torch.sqrt((disp * disp).sum(dim=1))
            tp = dn[cand.pt_vids]
            travel_pt = tp[:, 0] + tp[:, 1:].amax(dim=1)
            te = dn[cand.ee_vids]
            travel_ee = te[:, :2].amax(dim=1) + te[:, 2:].amax(dim=1)
            lim_pt = math.sqrt(dHat) + travel_pt
            lim_ee = math.sqrt(dHat) + travel_ee
            act_pt = d_pt < lim_pt * lim_pt
            act_ee = d_ee < lim_ee * lim_ee
        (sp, se), (n_pt, n_ee) = compact(act_pt, act_ee)
        return ActiveSet(vids_p=cand.pt_vids[sp], vids_e=cand.ee_vids[se],
                         eps_e=cand.ee_eps_x[se], cnt_pt=n_pt, cnt_ee=n_ee)

    def candidate_set(self, cand):
        """Every candidate pair of `cand` as an ActiveSet (no compaction)."""
        return ActiveSet(vids_p=cand.pt_vids, vids_e=cand.ee_vids, eps_e=cand.ee_eps_x,
                         cnt_pt=cand.pt_count, cnt_ee=cand.ee_count)

    def vert_sum(self, act):
        """The active set's vertex gather-sum (built once, then cached)."""
        if act.vert_sum is None:
            ids = torch.cat([act.vids_p, act.vids_e]).reshape(-1)
            act.vert_sum = make_dynamic_gather_sum(ids, int(self.mesh.x_rest.shape[0]))
        return act.vert_sum

    def energy_active(self, x, act, kappa, dHat, df=False):
        """Barrier energy of an active set; df=True gives a compensated
        (hi, lo) pair (ops/compensated.py)."""
        with span("pairs"):
            e_pt, e_ee = PAIRS.energies(x, act, dHat, self.tab)
            if df:
                return df_scale(df_add(df_sum(e_pt), df_sum(e_ee)), kappa)
            return kappa * (e_pt.sum() + e_ee.sum())

    def gradient_active(self, x, act, kappa, dHat):
        """(V,3) barrier gradient of an active set."""
        with span("pairs"):
            return self.vert_sum(act)(PAIRS.gradient_rows(x, act, kappa, dHat, self.tab))

    def hessian_blocks_from_active(self, x, act, kappa, dHat, project=True):
        """SPD 12x12 blocks of an active set: (vids (Ca,4), H (Ca,12,12),
        (cnt_pt, cnt_ee))."""
        with span("pairs"):
            H = PAIRS.blocks(x, act, kappa, dHat, self.tab, project)
            vids = torch.cat([act.vids_p, act.vids_e])
            return vids, H, (act.cnt_pt, act.cnt_ee)

    def hessian_blocks_active(self, x, cand, kappa, dHat, project=True):
        act = self.active_set(x, cand, dHat)
        return self.hessian_blocks_from_active(x, act, kappa, dHat, project)

    def capture_friction(self, x, cand, kappa, dHat):
        """Lagged friction state compacted to the pairs with lam > 0, with
        the vertex gather-sum over their stencils (`vert_sum`) and the
        true count."""
        with span("pairs"):
            fr = SC.capture_friction(x, cand.pt_vids, cand.ee_vids, cand.ee_eps_x, kappa,
                                     dHat, self.tab, self_mu=self.friction,
                                     vert_mu=self.vert_mu)
            (sel,), (cnt,) = compact(fr["lam"] > 0.0)
            out = {k: v[sel] for k, v in fr.items()}
            out["count"] = cnt
            out["vert_sum"] = make_dynamic_gather_sum(out["vids"].reshape(-1),
                                                      int(self.mesh.x_rest.shape[0]))
            return out

    # -- CCD and the intersection check --------------------------------------

    def ccd_alpha(self, x, dx, cand, gap_frac=0.2, max_iter=64):
        """Least safe step over the candidates (0-d, at most 1); the
        candidates' sweep must cover dx. With ccd_method "ti" each pair's
        step is the larger of the interval CCD's (minimum separation
        gap_frac * d0) and ACCD's."""
        with span("ccd"):
            a = torch.ones((), dtype=x.dtype, device=x.device)
            for vids, accd, ti, dist2 in (
                    (cand.pt_vids, accd_pt, ti_pt, point_triangle_dist2),
                    (cand.ee_vids, accd_ee, ti_ee, edge_edge_dist2)):
                if not vids.shape[0]:
                    continue
                x4, p4 = x[vids], dx[vids]
                with span(accd.__name__):
                    t = accd(x4, p4, gap_frac, max_iter)
                if self.ccd_method == "ti":
                    with span(ti.__name__):
                        d0 = torch.sqrt(torch.clamp(
                            dist2(x4[:, 0], x4[:, 1], x4[:, 2], x4[:, 3]), min=0.0))
                        t = torch.maximum(ti(x4, p4, 1.0, gap_frac * d0, max_iter), t)
                a = torch.minimum(a, t.amin())
            return spmd.all_min(a)

    def intersects_pairs(self, x, pairs):
        """0-d bool: any of the (edge, tri) pairs properly intersects (on
        any rank)."""
        return spmd.all_any(any_edge_tri_intersection(x, self.mesh.surf_edges,
                                                      self.mesh.surf_tris, pairs))

    def has_intersection(self, x, dbc_free=False):
        """(0-d bool, pair count): any surface edge through any surface
        triangle at x (a fresh unswept broad phase at gap 0); dbc_free as in
        build_candidates. Under an active group the test covers every
        rank's share and the count is this rank's."""
        mesh = self.mesh
        dbc, big = self._mask_and_big(dbc_free)
        sharded = spmd.active_group() is not None
        with span("broadphase"):
            if self.broadphase == "grid":
                shard = (spmd.rank(), spmd.world()) if sharded and big is None else None
                pairs, n = SH.et_candidates(x, mesh.surf_edges, mesh.surf_tris, dbc_mask=dbc,
                                            big=big, shard=shard)
                sharded = sharded and shard is None
            else:
                pairs, n = BP.et_candidates(x, mesh.surf_edges, mesh.surf_tris, dbc_mask=dbc)
            if sharded:
                pairs, n = self._rank_share(pairs)
        return self.intersects_pairs(x, pairs), n
