"""Self-contact pipeline: broad phase -> candidates -> barrier, friction, CCD
and the intersection check, in the shape the production step consumes.

Port of ipc_tpu/contact/pipeline.py. Candidate and active sets are
exact-size tensors: the JAX package's fixed capacities, -1 padding, valid
masks and `ensure_*` regrow are TPU devices and are not ported; the true
counts stay, so a step's stats compare with the JAX package's.

Every value read back to the host (set sizes) adds to `host_syncs`.

`ccd_method` picks ACCD ("accd") or, with "ti", the per-pair maximum of
the interval CCD and ACCD (both conservative, so their maximum is too).

Not ported yet: per-vertex friction coefficients of kinematic collision
objects (`vert_mu`), the dense sweep of oversized primitives on the grid
path (`_classify_big` finding any), the SPMD broad phase, and the
full-candidate `energy/gradient/hessian_blocks/n_active/et_pairs` helpers,
which the production step does not call. The constructor raises
NotImplementedError for the first two.
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from ipc_tpu_torch.contact import broadphase as BP
from ipc_tpu_torch.contact import selfcollision as SC
from ipc_tpu_torch.contact import spatial_hash as SH
from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt, ti_ee, ti_pt
from ipc_tpu_torch.contact.intersection import any_edge_tri_intersection
from ipc_tpu_torch.ops.compensated import df_add, df_scale, df_sum
from ipc_tpu_torch.ops.distance import edge_edge_dist2, eps_x_ee, point_triangle_dist2
from ipc_tpu_torch.ops.scatter import make_dynamic_gather_sum
from ipc_tpu_torch.ops.spd import make_psd

__all__ = ["Candidates", "ActiveSet", "SelfContact", "compact"]


def compact(*masks):
    """Ascending indices of the True entries of each 1-D mask (what
    `torch.nonzero` gives), with one host read for all of them: the counts,
    then a stable sort per mask. Returns (list of index tensors, counts)."""
    counts = torch.stack([m.sum() for m in masks]).tolist()
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
    BIG_FACTOR = 8.0  # oversized past this x the median primitive extent

    def __init__(self, mesh, meta, friction=0.0, vert_mu=None, broadphase=None,
                 ccd_method="accd"):
        if ccd_method not in ("accd", "ti"):
            raise ValueError(f"ccd_method={ccd_method!r}: 'accd' or 'ti'")
        if vert_mu is not None:
            raise NotImplementedError(
                "vert_mu (kinematic collision objects) is not ported yet")
        self.mesh = mesh
        self.meta = meta
        self.friction = friction
        self.ccd_method = ccd_method
        nS = int(mesh.surf_tris.shape[0])
        nE = int(mesh.surf_edges.shape[0])
        nV = int(mesh.surf_verts.shape[0])
        if broadphase is None:
            broadphase = "grid" if max(nS, nE, nV) > self.DENSE_LIMIT else "dense"
        self.broadphase = broadphase
        if broadphase == "grid" and self._has_big(mesh):
            raise NotImplementedError(
                "oversized primitives need the dense big-prim sweep of the grid "
                "broad phase, which is not ported yet")
        self.tab = SC.SlotTables(mesh.x_rest.device, mesh.x_rest.dtype)
        self.host_syncs = 0

    def _has_big(self, mesh):
        """Whether the JAX package's `_classify_big` would find oversized
        primitives (rest-shape extent > BIG_FACTOR x the deformable median)."""
        xr = mesh.x_rest.detach().cpu().numpy()
        dbc = mesh.dbc_mask.cpu().numpy()
        for prims in (mesh.surf_tris.cpu().numpy(), mesh.surf_edges.cpu().numpy()):
            if not prims.shape[0]:
                continue
            P = xr[prims]
            ext = (P.max(axis=1) - P.min(axis=1)).max(axis=1)
            free = ~dbc[prims].all(axis=1)
            ref_ext = ext[free] if free.any() else ext
            if (ext > self.BIG_FACTOR * max(float(np.median(ref_ext)), 1e-30)).any():
                return True
        return False

    # -- candidate construction ---------------------------------------------

    def _comoving(self, disp):
        """Subtract the mean surface-vertex displacement: pairwise swept
        proximity depends only on relative motion."""
        if disp is None:
            return None
        return disp - disp[self.mesh.surf_verts].mean(dim=0)

    def build_candidates(self, x, disp=None, gap=0.0, with_et=True):
        """One broad phase: PT and EE barrier/CCD stencils plus the swept
        edge-triangle pairs of the intersection check, swept along `disp`
        in the co-moving frame and inflated by `gap`."""
        mesh = self.mesh
        disp = self._comoving(disp)
        if self.broadphase == "grid":
            fused = SH.fused_candidates(x, mesh.surf_verts, mesh.surf_edges, mesh.surf_tris,
                                        mesh.dbc_mask, disp, gap, with_et=with_et)
            (pt, pt_n), (ee, ee_n), (et, et_n) = fused["pt"], fused["ee"], fused["et"]
            self.host_syncs += fused["host_syncs"]
        else:
            pt, pt_n = BP.pt_candidates(x, mesh.surf_verts, mesh.surf_tris, mesh.dbc_mask,
                                        disp, gap)
            ee, ee_n = BP.ee_candidates(x, mesh.surf_edges, mesh.dbc_mask, disp, gap)
            if with_et:
                et, et_n = BP.et_candidates(x, mesh.surf_edges, mesh.surf_tris, disp, gap,
                                            mesh.dbc_mask)
            else:
                et = torch.zeros((0, 2), dtype=torch.int64, device=x.device)
                et_n = 0
            self.host_syncs += 3 if with_et else 2
        pt_vids = torch.cat([mesh.surf_verts[pt[:, 0]][:, None], mesh.surf_tris[pt[:, 1]]],
                            dim=1)
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
        self.host_syncs += 1
        return ActiveSet(vids_p=cand.pt_vids[sp], vids_e=cand.ee_vids[se],
                         eps_e=cand.ee_eps_x[se], cnt_pt=n_pt, cnt_ee=n_ee)

    def vert_sum(self, act):
        """The active set's vertex gather-sum (built once, then cached)."""
        if act.vert_sum is None:
            ids = torch.cat([act.vids_p, act.vids_e]).reshape(-1)
            act.vert_sum = make_dynamic_gather_sum(ids, int(self.mesh.x_rest.shape[0]))
            self.host_syncs += act.vert_sum.host_syncs
        return act.vert_sum

    def energy_active(self, x, act, kappa, dHat, df=False):
        """Barrier energy of an active set; df=True gives a compensated
        (hi, lo) pair (ops/compensated.py)."""
        e_pt = SC.pt_pair_energy(x[act.vids_p], dHat, self.tab)
        e_ee = SC.ee_pair_energy(x[act.vids_e], act.eps_e, dHat, self.tab)
        if df:
            return df_scale(df_add(df_sum(e_pt), df_sum(e_ee)), kappa)
        return kappa * (e_pt.sum() + e_ee.sum())

    def gradient_active(self, x, act, kappa, dHat):
        """(V,3) barrier gradient of an active set."""
        g_pt = SC.pt_pair_grad(x[act.vids_p], dHat, self.tab)
        g_ee = SC.ee_pair_grad(x[act.vids_e], act.eps_e, dHat, self.tab)
        rows = torch.cat([kappa * g_pt.reshape(-1, 3), kappa * g_ee.reshape(-1, 3)])
        return self.vert_sum(act)(rows)

    def hessian_blocks_from_active(self, x, act, kappa, dHat, project=True):
        """SPD 12x12 blocks of an active set: (vids (Ca,4), H (Ca,12,12),
        (cnt_pt, cnt_ee))."""
        H = torch.cat([SC.pt_pair_hess(x[act.vids_p], dHat, self.tab),
                       SC.ee_pair_hess(x[act.vids_e], act.eps_e, dHat, self.tab)])
        if project and H.shape[0]:
            H = make_psd(H)
        vids = torch.cat([act.vids_p, act.vids_e])
        return vids, kappa * H, (act.cnt_pt, act.cnt_ee)

    def hessian_blocks_active(self, x, cand, kappa, dHat, project=True):
        act = self.active_set(x, cand, dHat)
        return self.hessian_blocks_from_active(x, act, kappa, dHat, project)

    def capture_friction(self, x, cand, kappa, dHat):
        """Lagged friction state compacted to the pairs with lam > 0, with
        the vertex gather-sum over their stencils (`vert_sum`) and the
        true count."""
        fr = SC.capture_friction(x, cand.pt_vids, cand.ee_vids, cand.ee_eps_x, kappa, dHat,
                                 self.tab, self_mu=self.friction)
        (sel,), (cnt,) = compact(fr["lam"] > 0.0)
        self.host_syncs += 1
        out = {k: v[sel] for k, v in fr.items()}
        out["count"] = cnt
        out["vert_sum"] = make_dynamic_gather_sum(out["vids"].reshape(-1),
                                                  int(self.mesh.x_rest.shape[0]))
        self.host_syncs += out["vert_sum"].host_syncs
        return out

    # -- CCD and the intersection check --------------------------------------

    def ccd_alpha(self, x, dx, cand, gap_frac=0.2, max_iter=64):
        """Least safe step over the candidates (0-d, at most 1); the
        candidates' sweep must cover dx. With ccd_method "ti" each pair's
        step is the larger of the interval CCD's (minimum separation
        gap_frac * d0) and ACCD's."""
        a = torch.ones((), dtype=x.dtype, device=x.device)
        for count, vids, accd, ti, dist2 in (
                (cand.pt_count, cand.pt_vids, accd_pt, ti_pt, point_triangle_dist2),
                (cand.ee_count, cand.ee_vids, accd_ee, ti_ee, edge_edge_dist2)):
            if not count:
                continue
            x4, p4 = x[vids], dx[vids]
            t = accd(x4, p4, gap_frac, max_iter)
            if self.ccd_method == "ti":
                d0 = torch.sqrt(torch.clamp(
                    dist2(x4[:, 0], x4[:, 1], x4[:, 2], x4[:, 3]), min=0.0))
                t = torch.maximum(ti(x4, p4, 1.0, gap_frac * d0, max_iter), t)
            a = torch.minimum(a, t.amin())
        return a

    def intersects_pairs(self, x, pairs):
        """0-d bool: any of the (edge, tri) pairs properly intersects."""
        return any_edge_tri_intersection(x, self.mesh.surf_edges, self.mesh.surf_tris, pairs)

    def has_intersection(self, x):
        """(0-d bool, pair count): any surface edge through any surface
        triangle at x (a fresh unswept broad phase at gap 0)."""
        mesh = self.mesh
        if self.broadphase == "grid":
            pairs, n, syncs = SH.et_candidates(x, mesh.surf_edges, mesh.surf_tris,
                                               dbc_mask=mesh.dbc_mask)
            self.host_syncs += syncs
        else:
            pairs, n = BP.et_candidates(x, mesh.surf_edges, mesh.surf_tris,
                                        dbc_mask=mesh.dbc_mask)
            self.host_syncs += 1
        return self.intersects_pairs(x, pairs), n
