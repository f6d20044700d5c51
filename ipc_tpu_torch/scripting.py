"""Scripted boundary conditions and kinematic motion.

The port's own copy of ipc_tpu/scripting.py (reference AnimScripter):
declarative Dirichlet/Neumann boundary conditions with time-range-gated
linear and angular scripted motion, velocity turning points, and the
registry of named scenario scripts (`build_script`). The host half is the
same numpy code (:39-230, 418-941), copied, not imported.

The device half is ported to torch with an explicit device and dtype:

* `DeviceTurning` (:232-298): the turning rules as two tensors, sign (R,)
  and active (R,), carried in SimState.aux; groups' and handles' linear
  velocities are scaled by the product of the signs of the rules listing
  them;
* `device_closures` (:301-402): `disp_fn(x, t, gfac, hfac)`, the (V,3)
  scripted displacement over [t, t + dt], and `fext_fn(t)`, the (V,3)
  per-mass Neumann force field. Each group adds its rows with one
  `index_add` over its own (unique) vertex ids, group after group, so a
  vertex in two groups gets its sums in a fixed order, never from colliding
  atomics.

Time gates: the port's SimState keeps `t` as a host float, so the gates
`lo <= t < hi` are compared in float64 on the host and an inactive group
adds nothing (the JAX package adds 0 * d, which gives the same sums). The
JAX step compares a traced `t` in the working dtype: a float32 JAX run
gates on a float32 `t`.

Mesh-sequence scripts read mesh files every step and run only on the host
path, which is not ported: `_load_seq_frame` raises NotImplementedError,
and jit_step.make_step refuses such scripts with the JAX package's
ValueError.
"""

import math
import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["DBCGroup", "NBCGroup", "HandleMotion", "TurningRule", "MeshSeqMotion",
           "Script", "build_script", "device_closures", "DeviceTurning"]

@dataclass
class DBCGroup:
    verts: np.ndarray  # int indices
    linear_vel: np.ndarray = None  # (3,)
    angular_vel: np.ndarray = None  # (3,) rad/s, XYZ Euler rates
    time_range: tuple = (0.0, math.inf)
    rot_center: str = "group_bbox"  # or fixed (3,) array


@dataclass
class NBCGroup:
    verts: np.ndarray
    force: np.ndarray  # (3,) per-mass force (acceleration units)
    time_range: tuple = (0.0, math.inf)


@dataclass
class HandleMotion:
    """Per-vertex angular motion about a fixed center (twist/bend family)."""

    verts: np.ndarray
    ang_vel: float  # rad/s (signed)
    axis: np.ndarray  # (3,)
    center: np.ndarray  # (3,)
    lin_vel: np.ndarray = None


@dataclass
class TurningRule:
    """Velocity turning point (reference velocityTurningPoints +
    per-script handling in stepAnimScript, AnimScripter.cpp:1556-1808):
    watches one vertex's coordinate and mutates the listed groups'/handles'
    linear velocities when it crosses a bound.

    action: 'stop' zeroes them once; 'flip_once' negates them once;
    'flip_band' negates them every step spent outside [lo, hi]."""

    vert: int
    axis: int
    lo: float = -math.inf
    hi: float = math.inf
    action: str = "stop"
    group_ids: tuple = ()
    handle_ids: tuple = ()
    active: bool = True


@dataclass
class MeshSeqMotion:
    """A kinematic component following a mesh-file sequence
    (reference AST_MESHSEQ_FROMFILE + per-shape meshSeq,
    AnimScripter.cpp stepAnimScript mesh-sequence branch)."""

    verts: np.ndarray  # component vertex ids
    folder: str
    transform: object  # V0 -> world positions (shape transform)
    n_frames: int
    ext: str


@dataclass
class Script:
    """Bound script: DBC/NBC groups + handle motions for one scene."""

    n_verts: int
    dbc_groups: list = field(default_factory=list)
    nbc_groups: list = field(default_factory=list)
    handles: list = field(default_factory=list)
    mesh_seqs: list = field(default_factory=list)
    turning: list = field(default_factory=list)  # TurningRule list
    mco_motions: list = field(default_factory=list)  # per-MeshCO lin/ang vel
    # moving analytic half-spaces (reference ACO* scripts): family name +
    # mutable per-plane velocity table (units/s), consumed by the host
    # stepper's per-step plane move (timestepper._step_aco)
    aco_kind: str = None  # "squash" | "squash6" | "squashshear"
    aco_vel: object = None  # (n_planes, 3) float array, mutated by flips
    init_velocity_fn: object = None  # (V,3) -> (V,3)
    x0_transform: object = None  # rest V -> initial positions (scaleF etc.)
    # AST_FALL / AST_FALL_NOSHIFT call resetDBCVertices (reference
    # AnimScripter.cpp:779-788): the scene's per-shape DBC selections are
    # cleared so the object actually falls (codim kinematic verts stay)
    clear_shape_dbc: bool = False
    dbc_time_range: tuple = (0.0, math.inf)
    nbc_time_range: tuple = (0.0, math.inf)

    def dbc_mask(self):
        m = np.zeros(self.n_verts, dtype=bool)
        for g in self.dbc_groups:
            m[g.verts] = True
        for h in self.handles:
            m[h.verts] = True
        for ms in self.mesh_seqs:
            m[ms.verts] = True
        return m

    def initial_velocity(self, V):
        v = np.zeros_like(V)
        if self.init_velocity_fn is not None:
            v = self.init_velocity_fn(np.asarray(V))
        return v

    def has_motion(self):
        if self.handles or self.mesh_seqs:
            return True
        return any(
            (g.linear_vel is not None and np.any(g.linear_vel != 0))
            or (g.angular_vel is not None and np.any(g.angular_vel != 0))
            for g in self.dbc_groups
        )

    def host_only(self):
        """True when the script needs per-step host FILE IO (mesh-sequence
        motions) and cannot run inside the jitted step. Turning rules and
        moving analytic planes are traced into the device step (their state
        lives in SimState.aux; see jit_step + DeviceTurning below)."""
        return bool(self.mesh_seqs)

    def _apply_turning(self, x):
        """Mutate group/handle velocities per the active turning rules
        (reference stepAnimScript's velocityTurningPoints handling)."""
        for tr in self.turning:
            if not tr.active:
                continue
            c = x[tr.vert, tr.axis]
            outside = c <= tr.lo or c >= tr.hi
            if not outside:
                continue
            for gi in tr.group_ids:
                g = self.dbc_groups[gi]
                if g.linear_vel is not None:
                    if tr.action == "stop":
                        g.linear_vel = np.zeros(3)
                    else:
                        g.linear_vel = -np.asarray(g.linear_vel)
            for hi_ in tr.handle_ids:
                h = self.handles[hi_]
                if h.lin_vel is not None:
                    if tr.action == "stop":
                        h.lin_vel = np.zeros(3)
                    else:
                        h.lin_vel = -np.asarray(h.lin_vel)
            if tr.action in ("stop", "flip_once"):
                tr.active = False

    def step_displacement(self, x, t, dt):
        """(V,3) scripted displacement over [t, t+dt] (zero off-DBC).

        Mirrors stepAnimScript's searchDir construction: per DBC group a
        rigid motion R(x-c)+c + v dt - x gated by its time range
        (AnimScripter.cpp:1440-1470); per handle an axis-angle rotation
        about a fixed center (:1674-1684).
        """
        disp = np.zeros_like(x)
        if self.turning:
            self._apply_turning(x)
        lo, hi = self.dbc_time_range
        in_global = (t >= lo) and (t < hi)
        for g in self.dbc_groups:
            if not (in_global and g.time_range[0] <= t < g.time_range[1]):
                continue
            idx = g.verts
            d = np.zeros((len(idx), 3))
            if g.angular_vel is not None and np.any(g.angular_vel != 0):
                R = _euler_xyz(g.angular_vel * dt)
                c = 0.5 * (x[idx].min(axis=0) + x[idx].max(axis=0))
                d += (x[idx] - c) @ R.T + c - x[idx]
            if g.linear_vel is not None:
                d += g.linear_vel[None, :] * dt
            disp[idx] += d
        for h in self.handles:
            R = _axis_angle(h.axis, h.ang_vel * dt)
            d = (x[h.verts] - h.center) @ R.T + h.center - x[h.verts]
            if h.lin_vel is not None:
                d += h.lin_vel[None, :] * dt
            disp[h.verts] += d
        for ms in self.mesh_seqs:
            frame = min(int(round(t / dt)) + 1, ms.n_frames - 1)
            target = ms.transform(_load_seq_frame(ms.folder, frame, ms.ext))
            disp[ms.verts] += target - x[ms.verts]
        return disp

    def nbc_force(self, t, n_verts):
        """(V,3) per-mass Neumann force field active at time t."""
        f = np.zeros((n_verts, 3))
        lo, hi = self.nbc_time_range
        if not (lo <= t < hi):
            return f
        for g in self.nbc_groups:
            if g.time_range[0] <= t < g.time_range[1]:
                f[g.verts] += g.force[None, :]
        return f


class DeviceTurning:
    """Velocity turning points as tensors (reference velocityTurningPoints).
    Rule state is sign (R,) in {+1, 0, -1} and active (R,) bool, carried in
    SimState.aux; a group's or handle's linear velocity is multiplied by
    the product of the signs of the rules that list it (the fixed-shape
    mirror of Script._apply_turning)."""

    def __init__(self, rules, n_groups, n_handles, device):
        self.n_rules = len(rules)
        self.device = device
        self.verts = torch.as_tensor([r.vert for r in rules], dtype=torch.int64, device=device)
        self.axes = torch.as_tensor([r.axis for r in rules], dtype=torch.int64, device=device)
        self.los = np.asarray([r.lo for r in rules], np.float64)
        self.his = np.asarray([r.hi for r in rules], np.float64)
        self.is_stop = torch.as_tensor([r.action == "stop" for r in rules], device=device)
        self.one_shot = torch.as_tensor([r.action in ("stop", "flip_once") for r in rules],
                                        device=device)
        G = np.zeros((self.n_rules, n_groups), bool)
        Hm = np.zeros((self.n_rules, n_handles), bool)
        for ri, r in enumerate(rules):
            for gi in r.group_ids:
                G[ri, gi] = True
            for hi in r.handle_ids:
                Hm[ri, hi] = True
        self.G = torch.as_tensor(G, device=device)
        self.Hm = torch.as_tensor(Hm, device=device)

    def init(self, dtype):
        return (torch.ones(self.n_rules, dtype=dtype, device=self.device),
                torch.ones(self.n_rules, dtype=torch.bool, device=self.device))

    def update(self, x, sign, active):
        """One per-step rule evaluation at the positions x: (sign, active)."""
        c = x[self.verts, self.axes]
        lo = torch.as_tensor(self.los, device=x.device).to(x.dtype)
        hi = torch.as_tensor(self.his, device=x.device).to(x.dtype)
        trig = active & ((c <= lo) | (c >= hi))
        new_sign = torch.where(trig, torch.where(self.is_stop, torch.zeros_like(sign), -sign),
                               sign)
        new_active = active & ~(trig & self.one_shot)
        return new_sign, new_active

    def _fac(self, sign, M):
        if M.shape[1] == 0:
            return None
        # factor_j = prod over the rules r with M[r, j] of sign_r
        return torch.where(M, sign[:, None], torch.ones_like(sign)[:, None]).prod(dim=0)

    def gfac(self, sign):
        return self._fac(sign, self.G)

    def hfac(self, sign):
        return self._fac(sign, self.Hm)


def _rotate(xg, Rt):
    """xg (N,3) @ Rt (3,3), summed over k in order 0, 1, 2."""
    return xg[:, 0:1] * Rt[0] + xg[:, 1:2] * Rt[1] + xg[:, 2:3] * Rt[2]


def device_closures(script, dtype, dt, device):
    """(disp_fn, fext_fn, turn) for the device step, on `device` in `dtype`.

    disp_fn(x, t, gfac, hfac) -> (V,3) scripted displacement over [t, t+dt];
    fext_fn(t) -> (V,3) per-mass Neumann force field (the device mirrors of
    Script.step_displacement / Script.nbc_force). Rotation matrices are
    fixed (dt is fixed); `t` is the host float of SimState. `turn` is a
    DeviceTurning or None; its state gives the gfac/hfac velocity factors.
    Mesh-sequence motions are not handled here (host path only). Absent
    parts are None."""

    def tens(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    def ids(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    turn = None
    if script is not None and script.turning:
        turn = DeviceTurning(script.turning, len(script.dbc_groups), len(script.handles),
                             device)

    disp_fn = None
    if script is not None and script.has_motion() and not script.mesh_seqs:
        dbc_specs = []
        glo, ghi = script.dbc_time_range
        for ogi, g in enumerate(script.dbc_groups):
            lin = g.linear_vel if g.linear_vel is not None else np.zeros(3)
            has_ang = g.angular_vel is not None and np.any(g.angular_vel != 0)
            if not has_ang and not np.any(lin):
                continue
            Rt = tens(_euler_xyz(np.asarray(g.angular_vel) * dt).T) if has_ang else None
            dbc_specs.append((ids(g.verts), tens(np.asarray(lin, np.float64) * dt), Rt,
                              max(glo, g.time_range[0]), min(ghi, g.time_range[1]), ogi))
        handle_specs = []
        for ohi, h in enumerate(script.handles):
            Rt = tens(_axis_angle(h.axis, h.ang_vel * dt).T)
            lin = tens(h.lin_vel * dt) if h.lin_vel is not None else None
            handle_specs.append((ids(h.verts), Rt, tens(h.center), lin, ohi))

        if dbc_specs or handle_specs:

            def disp_fn(x, t, gfac=None, hfac=None):
                out = torch.zeros_like(x)
                for idx, lin_dt, Rt, lo, hi, ogi in dbc_specs:
                    if not (lo <= t < hi):
                        continue
                    xg = x[idx]
                    d = torch.zeros_like(xg)
                    if Rt is not None:
                        c = 0.5 * (xg.amin(dim=0) + xg.amax(dim=0))
                        d = d + _rotate(xg - c, Rt) + c - xg
                    lin_term = lin_dt[None, :]
                    if gfac is not None:
                        lin_term = gfac[ogi] * lin_term
                    out = out.index_add(0, idx, d + lin_term)
                for idx, Rt, c, lin_dt, ohi in handle_specs:
                    xg = x[idx]
                    d = _rotate(xg - c, Rt) + c - xg
                    if lin_dt is not None:
                        lin_term = lin_dt[None, :]
                        if hfac is not None:
                            lin_term = hfac[ohi] * lin_term
                        d = d + lin_term
                    out = out.index_add(0, idx, d)
                return out

    fext_fn = None
    if script is not None and script.nbc_groups:
        nlo, nhi = script.nbc_time_range
        nbc_specs = [(ids(g.verts), tens(g.force), max(nlo, g.time_range[0]),
                      min(nhi, g.time_range[1])) for g in script.nbc_groups]
        n_verts = script.n_verts

        def fext_fn(t):
            f = torch.zeros((n_verts, 3), dtype=dtype, device=device)
            for idx, force, lo, hi in nbc_specs:
                if lo <= t < hi:
                    f = f.index_add(0, idx, force[None, :].expand(idx.shape[0], 3))
            return f

    return disp_fn, fext_fn, turn


def _load_seq_frame(folder, frame, ext):
    raise NotImplementedError(
        "mesh-sequence scripts read mesh files every step and need the host-path "
        "stepper, which the port does not have yet")


def _euler_xyz(rad):
    def rot(axis, a):
        c, s = math.cos(a), math.sin(a)
        if axis == 0:
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == 1:
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    return rot(0, rad[0]) @ rot(1, rad[1]) @ rot(2, rad[2])


def _axis_angle(axis, a):
    axis = np.asarray(axis, dtype=float)
    axis = axis / np.linalg.norm(axis)
    K = np.array(
        [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
    )
    return np.eye(3) + math.sin(a) * K + (1 - math.cos(a)) * (K @ K)


def _border_verts(V, ratio):
    """Two x-extreme handles (reference IglUtils::findBorderVerts)."""
    lo, hi = V.min(axis=0), V.max(axis=0)
    rng = hi - lo
    left = np.nonzero(V[:, 0] < lo[0] + rng[0] * ratio)[0]
    right = np.nonzero(V[:, 0] > hi[0] - rng[0] * ratio)[0]
    return left, right


def build_script(name, V, surface_mask, comp_ranges, params=(), handle_ratio=0.01,
                 shape_specs=None, dbc_time_range=(0.0, math.inf),
                 nbc_time_range=(0.0, math.inf), comp_codim=None):
    """Construct a Script for scene vertices V.

    shape_specs: parsed config.ShapeSpec list — their DBC/NBC/velocity
    entries are bound here (vertex selection on boundary nodes inside the
    RELATIVE bbox of each shape, reference IglUtils::Init_Dirichlet +
    main.cpp:1045-1070).
    """
    V = np.asarray(V)
    n = len(V)
    sc = Script(n_verts=n, dbc_time_range=dbc_time_range, nbc_time_range=nbc_time_range)
    bbox_center = 0.5 * (V.min(axis=0) + V.max(axis=0))

    # --- declarative shape DBC/NBC/initVel ------------------------------
    if shape_specs is not None:
        for ci, sp in enumerate(shape_specs):
            s0, s1 = comp_ranges[ci]
            Vc = V[s0:s1]
            lo, hi = Vc.min(axis=0), Vc.max(axis=0)
            rng = np.where(hi > lo, hi - lo, 1.0)
            bmask = surface_mask[s0:s1]
            for d in sp.dbc:
                rmin = lo + rng * d.bbox_min
                rmax = lo + rng * d.bbox_max
                sel = np.nonzero(
                    bmask & np.all(Vc >= rmin - 1e-12, axis=1) & np.all(Vc <= rmax + 1e-12, axis=1)
                )[0]
                if len(sel):
                    sc.dbc_groups.append(
                        DBCGroup(sel + s0, d.linear_vel, d.angular_vel, d.time_range)
                    )
            for nb in sp.nbc:
                rmin = lo + rng * nb.bbox_min
                rmax = lo + rng * nb.bbox_max
                sel = np.nonzero(
                    bmask & np.all(Vc >= rmin - 1e-12, axis=1) & np.all(Vc <= rmax + 1e-12, axis=1)
                )[0]
                if len(sel):
                    sc.nbc_groups.append(NBCGroup(sel + s0, nb.force, nb.time_range))
            # mesh-sequence-driven kinematic component
            if sp.mesh_seq:
                import glob as _glob
                import os as _os

                files = sorted(
                    _glob.glob(_os.path.join(sp.mesh_seq, "*.seg"))
                    + _glob.glob(_os.path.join(sp.mesh_seq, "*.obj"))
                )
                if files:
                    ext = _os.path.splitext(files[0])[1]
                    n_frames = len(files)
                    rot, scale, trans = sp.rotate, sp.scale, sp.translate

                    def xf(V0, rot=rot, scale=scale, trans=trans):
                        return (rot @ (V0 * scale[None, :]).T).T + trans[None, :]

                    sc.mesh_seqs.append(
                        MeshSeqMotion(
                            verts=np.arange(s0, s1),
                            folder=sp.mesh_seq,
                            transform=xf,
                            n_frames=n_frames,
                            ext=ext,
                        )
                    )
            # whole-component scripted velocity -> moving DBC of the component
            if sp.linear_vel is not None or sp.angular_vel is not None:
                sc.dbc_groups.append(
                    DBCGroup(
                        np.arange(s0, s1),
                        sp.linear_vel if sp.linear_vel is not None else np.zeros(3),
                        sp.angular_vel if sp.angular_vel is not None else np.zeros(3),
                    )
                )

        # initial velocities (component rigid fields)
        def init_vel(Vx):
            v = np.zeros_like(Vx)
            for ci, sp in enumerate(shape_specs):
                if sp.init_lvel is None:
                    continue
                s0, s1 = comp_ranges[ci]
                c = 0.5 * (Vx[s0:s1].min(axis=0) + Vx[s0:s1].max(axis=0))
                v[s0:s1] = sp.init_lvel[None, :] + np.cross(
                    np.broadcast_to(sp.init_avel, (s1 - s0, 3)), Vx[s0:s1] - c
                )
            return v

        sc.init_velocity_fn = init_vel

    # --- named scripts ----------------------------------------------------
    lo, hi = V.min(axis=0), V.max(axis=0)
    rng = np.where(hi > lo, hi - lo, 1.0)

    def sel(pred):
        return np.nonzero(pred)[0]

    name_l = (name or "null").lower()
    if name_l == "null":
        pass
    elif name_l == "drop":
        prev = sc.init_velocity_fn

        def f(Vx):
            v = prev(Vx) if prev else np.zeros_like(Vx)
            v[:, 1] = -1.0
            return v

        sc.init_velocity_fn = f
    elif name_l == "lefthitright":
        def f(Vx):
            v = np.zeros_like(Vx)
            v[Vx[:, 0] < lo[0] + rng[0] / 2, 0] = 1.0
            return v

        sc.init_velocity_fn = f
    elif name_l == "xyrotate":
        def f(Vx):
            v = np.zeros_like(Vx)
            v[Vx[:, 1] < lo[1] + rng[1] * 0.01, 0] = 1.0
            v[Vx[:, 1] > hi[1] - rng[1] * 0.01, 0] = -1.0
            return v

        sc.init_velocity_fn = f
    elif name_l == "stand":
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] < lo[1] + rng[1] * 0.01)))
    elif name_l == "topbottomfix":
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] > hi[1] - rng[1] * 0.02)))
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] < lo[1] + rng[1] * 0.02)))
    elif name_l == "fixlowerhalf":
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] < lo[1] + rng[1] * 0.5)))
    elif name_l == "hang":
        # fix one vertex per border ring (reference AST_HANG fixes
        # borderVerts_primitive[i].back(); we pick each ring's top vertex)
        for ring in _border_verts(V, handle_ratio):
            if len(ring):
                sc.dbc_groups.append(DBCGroup(ring[np.argmax(V[ring, 1])][None]))
    elif name_l == "hang2":
        top = sel(V[:, 1] > hi[1] - rng[1] * 0.01)
        sc.dbc_groups.append(DBCGroup(top))
    elif name_l == "hangtopleft":
        ring = _border_verts(V, handle_ratio)[0]
        m = (V[ring, 1] > hi[1] - rng[1] * 0.01) & (
            (V[ring, 2] > hi[2] - rng[2] * 0.01) | (V[ring, 2] < lo[2] + rng[2] * 0.01)
        )
        sc.dbc_groups.append(DBCGroup(ring[m]))
    elif name_l == "hangleft":
        sc.dbc_groups.append(DBCGroup(_border_verts(V, handle_ratio)[0]))
    elif name_l == "swing":
        shift = np.array([0.0, 1.3 * rng[1], 0.0])
        sc.x0_transform = lambda Vx: Vx + shift[None, :]
        sc.dbc_groups.append(DBCGroup(sel(V[:, 0] < lo[0] + rng[0] * 0.05)))
    elif name_l == "scalef":
        sc.x0_transform = lambda Vx: 1.5 * Vx
    elif name_l == "onepoint":
        c = bbox_center + np.array([0.0, 0.5 * rng[1], 0.0])
        sc.x0_transform = lambda Vx: np.broadcast_to(c, Vx.shape).copy()
    elif name_l == "random":
        def f(Vx):
            r = np.random.default_rng(0).uniform(-0.5, 0.5, Vx.shape)
            off = bbox_center + np.array([0.0, 0.5 * rng[1], 0.0]) - r[0]
            return r + off[None, :]

        sc.x0_transform = f
    elif name_l in ("stamp", "stampboth"):
        rings = _border_verts(V, handle_ratio)
        sc.dbc_groups.append(DBCGroup(rings[0]))
        if name_l == "stampboth":
            sc.dbc_groups.append(DBCGroup(rings[1]))
    elif name_l == "stamptopleft":
        ring = _border_verts(V, handle_ratio)[0]
        sc.dbc_groups.append(DBCGroup(ring[V[ring, 1] > hi[1] - rng[1] * 0.01]))
    elif name_l == "stampinv":
        fixed = sel(V[:, 0] < lo[0] + rng[0] * 0.01)
        sc.dbc_groups.append(DBCGroup(fixed))
        x_off = 1.1 * V[fixed[0], 0] if len(fixed) else 0.0

        def f(Vx, x_off=x_off):
            out = Vx.copy()
            out[:, 0] = -0.1 * Vx[:, 0] + x_off
            return out

        sc.x0_transform = f
    elif name_l == "standinv":
        fixed = sel(V[:, 1] < lo[1] + rng[1] * 0.01)
        sc.dbc_groups.append(DBCGroup(fixed))
        y_off = 1.1 * V[fixed[0], 1] if len(fixed) else 0.0

        def f(Vx, y_off=y_off):
            out = Vx.copy()
            out[:, 1] = -0.1 * Vx[:, 1] + y_off
            return out

        sc.x0_transform = f
    elif name_l == "corner":
        m = (
            (V[:, 0] < lo[0] + rng[0] * 0.01)
            | (V[:, 1] < lo[1] + rng[1] * 0.01)
            | (V[:, 2] < lo[2] + rng[2] * 0.01)
        )
        sc.dbc_groups.append(DBCGroup(sel(m)))
    elif name_l == "push":
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] < lo[1] + rng[1] * 0.01)))
        top = sel(V[:, 1] > hi[1] - rng[1] * 0.01)
        sc.dbc_groups.append(DBCGroup(top, np.array([0.0, -1.0, 0.0])))
        sc.turning.append(
            TurningRule(vert=int(top[0]), axis=1, lo=V[top[0], 1] - 0.5,
                        action="stop", group_ids=(1,))
        )
    elif name_l == "tear":
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] < lo[1] + rng[1] * 0.01)))
        top = sel(V[:, 1] > hi[1] - rng[1] * 0.01)
        sc.dbc_groups.append(DBCGroup(top, np.array([-5.0, 0.0, 0.0])))
        sc.turning.append(
            TurningRule(vert=int(top[0]), axis=0, lo=V[top[0], 0] - 4.0,
                        action="flip_once", group_ids=(1,))
        )
    elif name_l in ("undstamp", "upndown"):
        rings = _border_verts(V, handle_ratio)
        n_rings = 1 if name_l == "undstamp" else 2
        gids = []
        for bI in range(n_rings):
            gids.append(len(sc.dbc_groups))
            sc.dbc_groups.append(
                DBCGroup(rings[bI], np.array([0.0, (-1.0) ** bI * 1.8, 0.0]))
            )
        tp = int(rings[0][0])
        sc.turning.append(
            TurningRule(vert=tp, axis=1, lo=V[tp, 1] - 0.6, hi=V[tp, 1] + 0.6,
                        action="flip_band", group_ids=tuple(gids))
        )
    elif name_l in ("stretch", "squash", "stretchnsquash"):
        speed = {"stretch": -0.1, "squash": 0.03, "stretchnsquash": -0.9}[name_l]
        rings = _border_verts(V, handle_ratio)
        for bI, verts in enumerate(rings):
            sc.dbc_groups.append(
                DBCGroup(verts, np.array([(-1.0) ** bI * speed, 0.0, 0.0]))
            )
        if name_l == "stretchnsquash":
            tp = int(rings[0][0])
            sc.turning.append(
                TurningRule(vert=tp, axis=0, lo=V[tp, 0] - 0.8, hi=V[tp, 0] + 0.4,
                            action="flip_band", group_ids=(0, 1))
            )
    elif name_l in ("stretchnpause", "stretchandpause"):
        # the reference's config string for AST_STRETCHNPAUSE is
        # "stretchAndPause" (AnimScripter.cpp:37) — accept both spellings
        left = sel(V[:, 0] < lo[0] + rng[0] * 0.01)
        right = sel(V[:, 0] > hi[0] - rng[0] * 0.01)
        sc.dbc_groups.append(DBCGroup(left, np.array([-1.0, 0.0, 0.0])))
        sc.dbc_groups.append(DBCGroup(right, np.array([1.0, 0.0, 0.0])))
        sc.turning.append(
            TurningRule(vert=int(left[0]), axis=0, lo=-0.28, action="stop",
                        group_ids=(0, 1))
        )
    elif name_l in ("twist", "bend", "twistnstretch", "twistnsns", "twistnsns_old"):
        rings = _border_verts(V, handle_ratio)
        rates = {
            "twist": -0.4 * math.pi,
            "bend": -0.05 * math.pi,
            "twistnstretch": -0.1 * math.pi,
            "twistnsns": -0.4 * math.pi,
            "twistnsns_old": -0.4 * math.pi,
        }
        lin_speed = {"twistnstretch": -0.1, "twistnsns": -1.2, "twistnsns_old": -0.9}
        axis = np.array([0.0, 0.0, 1.0]) if name_l == "bend" else np.array([1.0, 0.0, 0.0])
        hids = []
        for bI, verts in enumerate(rings):
            lin = None
            if name_l in lin_speed:
                lin = np.array([(-1.0) ** bI * lin_speed[name_l], 0.0, 0.0])
            hids.append(len(sc.handles))
            sc.handles.append(
                HandleMotion(
                    verts=verts,
                    ang_vel=(-1.0) ** bI * rates[name_l],
                    axis=axis,
                    center=bbox_center.copy(),
                    lin_vel=lin,
                )
            )
        if name_l in ("twistnsns", "twistnsns_old"):
            back = 1.2 if name_l == "twistnsns" else 0.8
            tp = int(rings[0][0])
            sc.turning.append(
                TurningRule(vert=tp, axis=0, lo=V[tp, 0] - back, hi=V[tp, 0] + 0.4,
                            action="flip_band", handle_ids=tuple(hids))
            )
    elif name_l == "rubberbandpull":
        top = sel(V[:, 1] > hi[1] - rng[1] * 0.02)
        bot = sel(V[:, 1] < lo[1] + rng[1] * 0.02)
        waist = sel(
            (V[:, 1] < hi[1] - rng[1] * 0.48) & (V[:, 1] > lo[1] + rng[1] * 0.48)
        )
        sc.dbc_groups.append(DBCGroup(top, np.array([0.0, 0.2, 0.0])))
        sc.dbc_groups.append(DBCGroup(bot, np.array([0.0, -0.2, 0.0])))
        sc.dbc_groups.append(DBCGroup(waist, np.array([-2.5, 0.0, 0.0])))
        tp = waist if len(waist) else top
        if len(tp):
            sc.turning.append(
                TurningRule(vert=int(tp[0]), axis=0, lo=V[tp[0], 0] - 5.0,
                            action="stop", group_ids=(0, 1, 2))
            )
    elif name_l == "fourlegpull":
        lt = sel((V[:, 1] > hi[1] - rng[1] * 0.129) & (V[:, 0] < lo[0] + rng[0] * 0.16))
        rt = sel((V[:, 1] > hi[1] - rng[1] * 0.16) & (V[:, 0] > hi[0] - rng[0] * 0.16))
        br = sel((V[:, 1] < lo[1] + rng[1] * 0.02) & (V[:, 0] > hi[0] - rng[0] * 0.25))
        bl = sel((V[:, 1] < lo[1] + rng[1] * 0.02) & (V[:, 0] < lo[0] + rng[0] * 0.25))
        sc.dbc_groups.append(DBCGroup(lt))
        sc.dbc_groups.append(DBCGroup(rt, np.array([2.5, 0.0, 0.0])))
        sc.dbc_groups.append(DBCGroup(br, np.array([2.5, -3.5, 0.0])))
        sc.dbc_groups.append(DBCGroup(bl, np.array([0.0, -3.5, 0.0])))
        if len(bl):
            sc.turning.append(
                TurningRule(vert=int(bl[0]), axis=1, lo=V[bl[0], 1] - 5.0,
                            action="stop", group_ids=(1, 2, 3))
            )
    elif name_l == "headtailpull":
        head = sel(V[:, 2] < lo[2] + rng[2] * 0.02)
        tail = sel(V[:, 2] > hi[2] - rng[2] * 0.02)
        mid = sel(
            (V[:, 2] > lo[2] + rng[2] * 0.46) & (V[:, 2] < lo[2] + rng[2] * 0.54)
        )
        sc.dbc_groups.append(DBCGroup(head, np.array([3.5, 0.0, 0.0])))
        sc.dbc_groups.append(DBCGroup(tail, np.array([3.5, 0.0, 0.0])))
        sc.dbc_groups.append(DBCGroup(mid))
        if len(head):
            sc.turning.append(
                TurningRule(vert=int(head[0]), axis=0, hi=V[head[0], 0] + 4.5,
                            action="stop", group_ids=(0, 1))
            )
    elif name_l in ("dragdown", "dragright"):
        # reference AST_DRAGDOWN/RIGHT (AnimScripter.cpp:790-826): lift by
        # half the bbox diagonal, resetDBCVertices, then grab the handle.
        # The shift applies to result.V only — never to meshCO geometry
        # (sim.initial_state restricts x0_transform to script-owned verts)
        shift = np.array([0.0, 0.5 * float(np.linalg.norm(rng)), 0.0])
        sc.x0_transform = lambda Vx: Vx + shift[None, :]
        sc.clear_shape_dbc = True
        if name_l == "dragdown":
            grab = sel(
                (V[:, 1] < lo[1] + rng[1] * 0.1)
                & (V[:, 0] < lo[0] + rng[0] * 0.52)
                & (V[:, 0] > lo[0] + rng[0] * 0.42)
            )
            sc.dbc_groups.append(DBCGroup(grab, np.array([0.0, -1.5, 0.0])))
        else:
            grab = sel(V[:, 0] > hi[0] - rng[0] * 0.04)
            sc.dbc_groups.append(DBCGroup(grab, np.array([0.5, 0.0, 0.0])))
    elif name_l == "toggletop":
        top = sel(V[:, 1] > hi[1] - rng[1] * 0.02)
        sc.dbc_groups.append(DBCGroup(top, np.array([-0.5, 0.0, 0.0])))
        sc.turning.append(
            TurningRule(vert=int(top[0]), axis=0, lo=V[top[0], 0] - 0.1,
                        action="stop", group_ids=(0,))
        )
    elif name_l == "curtain":
        for pin in range(8):
            cx = lo[0] + rng[0] / 7.0 * pin
            m = (
                (V[:, 0] > cx - rng[0] * 0.0025)
                & (V[:, 0] < cx + rng[0] * 0.0025)
                & (V[:, 1] > hi[1] - rng[1] * 0.005)
            )
            pins = sel(m)
            if len(pins):
                sc.dbc_groups.append(
                    DBCGroup(pins, np.array([0.04 * (7.0 - pin) / 7.0, 0.0, 0.0]))
                )
    elif name_l in ("fixrightmost1", "pushrightmost1"):
        cand_ = sel(V[:, 0] > hi[0] - 1e-3 * rng[0])
        one = cand_[:1]
        vel = np.array([-0.15, 0.0, 0.0]) if name_l == "pushrightmost1" else None
        sc.dbc_groups.append(DBCGroup(one, vel))
    elif name_l in ("nmfixbottomdragleft", "nmfixbottomdragforward"):
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] < lo[1] + rng[1] * 0.05)))
        s = -600.0 if name_l == "nmfixbottomdragleft" else 600.0
        sc.nbc_groups.append(
            NBCGroup(sel(V[:, 1] > hi[1] - rng[1] * 0.05), np.array([s, 0.0, 0.0]))
        )
    elif name_l in ("fall", "fallnoshift"):
        # AST_FALL lifts by half the bbox diagonal; both variants clear the
        # scene's shape DBC (reference AnimScripter.cpp:779-788)
        if name_l == "fall":
            shift = np.array([0.0, 0.5 * float(np.linalg.norm(rng)), 0.0])
            sc.x0_transform = lambda Vx: Vx + shift[None, :]
        sc.clear_shape_dbc = True
    elif name_l in ("utopia_comparison", "utopiacomparison"):
        # note: the reference gates BOTH selections on range[0] (the
        # x-extent) — ported verbatim (AnimScripter.cpp:1285-1300)
        sc.dbc_groups.append(DBCGroup(sel(V[:, 1] < lo[1] + rng[0] * 1e-4)))
        sc.nbc_groups.append(
            NBCGroup(sel(V[:, 1] > hi[1] - rng[0] * 1e-4), np.array([0.0, -1.5, 0.0]))
        )
    elif name_l in ("dcofix", "dcoballhitwall", "meshseq_fromfile",
                    "meshseqfromfile"):
        # fix every codimensional component (reference AST_DCOFIX /
        # AST_DCOBALLHITWALL / AST_MESHSEQ_FROMFILE share the selection)
        for ci, (s0, s1) in enumerate(comp_ranges):
            if comp_codim is not None and comp_codim[ci] < 3:
                sc.dbc_groups.append(DBCGroup(np.arange(s0, s1)))
    elif name_l in ("dcosegbedsquash", "dcosqueezeout"):
        n_comp = len(comp_ranges)
        for ci, (s0, s1) in enumerate(comp_ranges):
            if comp_codim is not None and comp_codim[ci] < 3:
                vel = None
                if name_l == "dcosegbedsquash" and ci >= (n_comp + 1) // 2:
                    vel = np.array([0.0, -1.0, 0.0])
                if name_l == "dcosqueezeout" and ci == 0:
                    vel = np.array([0.0, -0.3, 0.0])
                sc.dbc_groups.append(DBCGroup(np.arange(s0, s1), vel))
    elif name_l in ("dcosquash", "dcosquash6"):
        n_move = 2 if name_l == "dcosquash" else 6
        vels = [
            np.array([1.0, 0, 0]), np.array([-1.0, 0, 0]),
            np.array([0, 1.0, 0]), np.array([0, -1.0, 0]),
            np.array([0, 0, 1.0]), np.array([0, 0, -1.0]),
        ]
        for ci, (s0, s1) in enumerate(comp_ranges):
            if comp_codim is not None and comp_codim[ci] < 3:
                vel = vels[ci] if ci < n_move else None
                sc.dbc_groups.append(DBCGroup(np.arange(s0, s1), vel))
    elif name_l in ("dcorotcylinders", "dcoverschoorroller"):
        # the first N scene components rotate rigidly about their own bbox
        # centers at fixed rates (reference AST_DCOROTCYLINDERS
        # AnimScripter.cpp:1060-1086 / AST_DCOVERSCHOORROLLER :1088-1120)
        if name_l == "dcorotcylinders":
            rates = [
                (np.array([1.0, 0, 0]), math.pi / 2),
                (np.array([1.0, 0, 0]), -math.pi / 2),
                (np.array([0, 0, 1.0]), -math.pi / 2),
                (np.array([0, 0, 1.0]), math.pi / 2),
            ]
        else:
            rates = [
                (np.array([0, 0, 1.0]), -4.0),
                (np.array([0, 0, 1.0]), -2.0),
                (np.array([0, 0, 1.0]), 2.0),
                (np.array([0, 0, 1.0]), 4.0),
                (np.array([1.0, 0, 0]), 2.0),
                (np.array([1.0, 0, 0]), -2.0),
            ]
        for ci, (axis, w) in enumerate(rates):
            if ci >= len(comp_ranges):
                break
            s0, s1 = comp_ranges[ci]
            center = 0.5 * (V[s0:s1].min(axis=0) + V[s0:s1].max(axis=0))
            sc.handles.append(
                HandleMotion(
                    verts=np.arange(s0, s1), ang_vel=w, axis=axis, center=center
                )
            )
        # remaining codim components stay fixed
        for ci in range(len(rates), len(comp_ranges)):
            if comp_codim is not None and comp_codim[ci] < 3:
                s0, s1 = comp_ranges[ci]
                sc.dbc_groups.append(DBCGroup(np.arange(s0, s1)))
    elif name_l in ("dcohammerwalnut", "dcocut"):
        for ci, (s0, s1) in enumerate(comp_ranges):
            if comp_codim is not None and comp_codim[ci] < 3:
                sc.dbc_groups.append(DBCGroup(np.arange(s0, s1)))
        # the moving tool is the first MeshCO (reference MCOVelocity)
        sc.mco_motions.append(
            dict(lin=np.array([0.0, -1.0, -1.0]) if name_l == "dcocut"
                 else np.array([0.0, -1.0, 0.0]), ang=None)
        )
    elif name_l in ("mcosquash", "acosquash", "acosquashshear"):
        # two collision objects squashing along x (reference MCO/ACOVelocity,
        # AnimScripter.cpp:956-993). ACO variants drive analytic half-spaces
        # when the scene declares them (sim.py binding); mco_motions stay as
        # the fallback for meshCO-only scenes.
        sc.mco_motions.append(dict(lin=np.array([1.0, 0.0, 0.0]), ang=None))
        sc.mco_motions.append(dict(lin=np.array([-1.0, 0.0, 0.0]), ang=None))
        if name_l != "mcosquash":
            sc.aco_kind = "squashshear" if name_l.endswith("shear") else "squash"
            sc.aco_vel = np.array([[1.0, 0, 0], [-1.0, 0, 0]])
    elif name_l == "acosquash6":
        vels = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
        for v in vels:
            sc.mco_motions.append(dict(lin=np.array(v, float), ang=None))
        sc.aco_kind = "squash6"
        sc.aco_vel = np.array(vels, float)
    elif name_l == "mcorotsquash":
        sc.mco_motions.append(dict(lin=None, ang=np.array([0.0, 0.0, math.pi])))
        sc.mco_motions.append(dict(lin=None, ang=np.array([0.0, 0.0, math.pi])))
    elif name_l == "mcorotcylinders":
        for a in ([math.pi / 2, 0, 0], [-math.pi / 2, 0, 0],
                  [0, 0, -math.pi / 2], [0, 0, math.pi / 2]):
            sc.mco_motions.append(dict(lin=None, ang=np.array(a, float)))
    else:
        warnings.warn(f"script '{name}' not implemented; treating as null")
    return sc
