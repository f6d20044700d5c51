"""Scene assembly and the offline simulation driver.

Port of ipc_tpu/sim.py: build one merged mesh from a scene file's shapes,
bind its boundary conditions and collision objects, construct the stepper,
and run with artifact output (utils/observability.py). The assembly order
is the JAX package's, step for step:

  1. load and transform every shape in scene order;
  2. merge the volumetric shapes;
  3. `rotateModel` about the half-extent vector, then `size`, applied to
     volumetric and codimensional shapes alike;
  4. the `fall` shift;
  5. build_mesh;
  6. append the codimensional shapes (.obj, .seg, .pt) as kinematic
     surfaces;
  7. build_script;
  8. fold the script's DBC selection into the mesh;

then `Simulation` appends the `meshCO` obstacles (centred on their vertex
centroid, rotated, scaled to `scale`, moved to their origin, bound to their
scripted motion) with their own friction (`vert_mu`), and self-contact runs
when the scene asks for it or has an obstacle.

The mesh and every tensor live on the device given (the card when None).
`Simulation.run` steps with the host path (`IPCStepper.step`, the JAX
package's default) or, with use_jit_step=True, the device step
(jit_step.make_step); mesh-sequence scripts run only on the host path
(ValueError on the device step, as in the JAX package). info.txt also
records each step's stats, and the stepper's operator applications and
host syncs.

`constraintSolver QP|SQP` builds the QP/SQP stepper (qp/stepper.py) in
place of IPCStepper, as the JAX package does; it runs on the host path
only (the device step raises ValueError for it: the JAX package's jit
step would run the IP solve instead).

Not ported: the capacity regrow of the JAX jit path (`_regrow_and_redo`,
`grow_caps`, `_check_capacity_budget`: the port's candidate sets are
exact-size).
"""

import dataclasses
import os
import time

import numpy as np
import torch

from ipc_tpu_torch import io_mesh
from ipc_tpu_torch.config import Config, load_config, save_config
from ipc_tpu_torch.contact.halfspace import HalfSpace, HalfSpaceParams
from ipc_tpu_torch.contact.pipeline import SelfContact
from ipc_tpu_torch.device import as_dtype, resolve_device
from ipc_tpu_torch.mesh import _boundary_faces, append_kinematic_surface, build_mesh
from ipc_tpu_torch.scripting import DBCGroup, HandleMotion, _axis_angle, build_script
from ipc_tpu_torch.timestepper import IPCStepper, SimParams
from ipc_tpu_torch.utils.observability import (
    RunLogger,
    load_status,
    load_status_text,
    save_status,
)

__all__ = ["Simulation", "assemble", "run_scene"]


def _load_shape(path):
    """(kind, V, prim) of one shape: kind 'vol' (tets), 'surf' (triangles),
    'seg' (edges) or 'pts'; codimensional shapes are kinematic."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".msh":
        return ("vol",) + io_mesh.read_msh(path)
    if ext in (".ele", ".node"):
        return ("vol",) + io_mesh.read_node_ele(os.path.splitext(path)[0])
    if ext == ".obj":
        return ("surf",) + io_mesh.read_obj(path)
    if ext == ".seg":
        if os.path.exists(path):
            return ("seg",) + io_mesh.read_seg(path)
        # a missing .seg falls back to the same-stem .obj's edges
        obj = os.path.splitext(path)[0] + ".obj"
        V, F = io_mesh.read_obj(obj)
        e = np.concatenate([F[:, [0, 1]], F[:, [1, 2]], F[:, [2, 0]]], axis=0)
        e = np.unique(np.sort(e, axis=1), axis=0)
        return ("seg", V, e)
    if ext == ".pt":
        # a point cloud: the .pt path read as .obj, else the same-stem .obj
        obj = path if os.path.exists(path) else os.path.splitext(path)[0] + ".obj"
        V, _ = io_mesh.read_obj(obj)
        return ("pts", V, np.zeros((0, 2), np.int64))
    raise ValueError(f"unsupported shape format: {path}")


def _material(value, default):
    return default if value is None or not np.isfinite(value or np.nan) else value


def assemble(cfg: Config, dtype=torch.float64, device=None):
    """Config -> (MeshData on `device` (the card when None), MeshMeta,
    Script), in the JAX package's order (module docstring)."""
    dtype, device = as_dtype(dtype), resolve_device(device)
    entries = []
    for spec in cfg.shapes:
        kind, V0, prim = _load_shape(spec.path)
        V = (spec.rotate @ (V0 * spec.scale[None, :]).T).T + spec.translate[None, :]
        entries.append(dict(kind=kind, V=V, V0=V0, prim=np.asarray(prim), spec=spec))

    # volumetric shapes merge into the deformable mesh, vertex-major
    Vs, Ts, vol_ranges, vert_comp = [], [], [], []
    tet_ym, tet_pr, tet_rho, boundary_masks = [], [], [], []
    off = 0
    for e in entries:
        if e["kind"] != "vol":
            continue
        V0, T0, spec = e["V0"], e["prim"], e["spec"]
        nV, nT = len(V0), len(T0)
        bmask = np.zeros(nV, dtype=bool)
        bmask[np.unique(_boundary_faces(np.asarray(T0, np.int64)).reshape(-1))] = True
        boundary_masks.append(bmask)
        rho, ym, pr = spec.material
        tet_rho.append(np.full(nT, _material(rho, cfg.rho)))
        tet_ym.append(np.full(nT, _material(ym, cfg.ym)))
        tet_pr.append(np.full(nT, _material(pr, cfg.pr)))
        Vs.append(e["V"])
        Ts.append(np.asarray(T0) + off)
        e["range"] = (off, off + nV)
        vol_ranges.append(e["range"])
        vert_comp.append(np.full(nV, len(vol_ranges) - 1, dtype=np.int32))
        off += nV
    if not Vs:
        raise ValueError("scene has no volumetric shapes")
    V = np.concatenate(Vs, axis=0)
    T = np.concatenate(Ts, axis=0)
    vert_comp = np.concatenate(vert_comp)
    surface_mask = np.concatenate(boundary_masks)

    # rotateModel and `size` apply to the whole scene, codimensional shapes
    # included (they join the reference's vertex array before that block);
    # meshCO obstacles and half-spaces stay in world units
    codim = [e for e in entries if e["kind"] != "vol"]

    def scene_pts():
        return np.concatenate([V] + [e["V"] for e in codim], axis=0)

    if cfg.rotate_model is not None:
        axis, deg = cfg.rotate_model
        R = _axis_angle(axis, np.radians(deg))
        # about the half-extent vector (max - min) / 2, as the reference
        P = scene_pts()
        c = 0.5 * (P.max(axis=0) - P.min(axis=0))
        V = (V - c) @ R.T + c
        for e in codim:
            e["V"] = (e["V"] - c) @ R.T + c
    if cfg.size > 0.0:
        # max extent to cfg.size, then the min corner to the origin
        P = scene_pts()
        s = cfg.size / float((P.max(axis=0) - P.min(axis=0)).max())
        V = V * s
        for e in codim:
            e["V"] = e["V"] * s
        lo = np.minimum(V.min(axis=0),
                        np.min([e["V"].min(axis=0) for e in codim], axis=0)
                        if codim else V.min(axis=0))
        V = V - lo
        for e in codim:
            e["V"] = e["V"] - lo

    # `fall` lifts the scene by half its bbox diagonal, after rotate/size
    script_name = cfg.script
    if script_name and script_name.lower() in ("fall", "fall_noshift"):
        if script_name.lower() == "fall":
            ext = V.max(axis=0) - V.min(axis=0)
            shift = np.array([0.0, 0.5 * float(np.linalg.norm(ext)), 0.0])
            V = V + shift
            for e in codim:
                e["V"] = e["V"] + shift
        script_name = "null"

    mesh, meta = build_mesh(
        V, T, density=np.concatenate(tet_rho), ym=np.concatenate(tet_ym),
        pr=np.concatenate(tet_pr), vert_comp=vert_comp, comp_ranges=vol_ranges,
        dtype=dtype, device=device,
    )
    for e in codim:
        tris = e["prim"] if e["kind"] == "surf" else None
        edges = e["prim"] if e["kind"] == "seg" else None
        mesh, meta, e["range"] = append_kinematic_surface(mesh, meta, e["V"], tris=tris,
                                                          edges=edges)

    # scene-order component tables for the scripts
    comp_ranges_scene = [e["range"] for e in entries]
    codims = {"vol": 3, "surf": 2, "seg": 1, "pts": 0}
    comp_codim = [codims[e["kind"]] for e in entries]
    V_all = mesh.x_rest.detach().cpu().numpy().astype(np.float64)
    surface_mask_all = np.concatenate(
        [surface_mask, np.ones(meta.n_verts - len(surface_mask), bool)])
    script = build_script(
        script_name, V_all, surface_mask_all, comp_ranges_scene,
        params=cfg.script_params, handle_ratio=cfg.handle_ratio,
        shape_specs=[e["spec"] for e in entries], dbc_time_range=cfg.dbc_time_range,
        nbc_time_range=cfg.nbc_time_range, comp_codim=comp_codim,
    )
    # fold the script's DBC selection into the mesh (codim verts already DBC)
    dbc_mesh = mesh.dbc_mask.cpu().numpy()
    if script.clear_shape_dbc:
        # the fall family drops the shapes' DBC selections but keeps the
        # codimensional kinematic components pinned
        keep = np.zeros_like(dbc_mesh)
        for ci, (s0, s1) in enumerate(comp_ranges_scene):
            if comp_codim[ci] < 3:
                keep[s0:s1] = True
        dbc_mesh = dbc_mesh & keep
    dbc = dbc_mesh | script.dbc_mask()
    mesh = dataclasses.replace(mesh, dbc_mask=torch.as_tensor(dbc, device=device))
    return mesh, meta, script


def _ccd_method(name):
    """The reference's CCDMethod names onto the two CCD methods: interval /
    inclusion-based -> "ti", everything else -> "accd"."""
    up = name.upper()
    return "ti" if "INCLUSION" in up.replace("_", "") or up in ("TI", "TIGHTINCLUSION") \
        else "accd"


class Simulation:
    """End-to-end simulation bound to one scene config, on one device."""

    def __init__(self, cfg: Config, dtype=torch.float64, overrides=None, device=None):
        self.cfg = cfg
        mesh, meta, script = assemble(cfg, dtype, device)
        self.mesh, self.meta, self.script = mesh, meta, script

        halfspaces = [
            HalfSpace(HalfSpaceParams(origin=h.origin, normal=h.normal, friction=h.friction))
            for h in cfg.halfspaces
        ]
        # ACO scripts move the scene's analytic planes when it has any; the
        # meshCO binding below is for plane-less scenes
        if getattr(script, "aco_kind", None) and halfspaces:
            script.mco_motions = []
        vert_mu = None
        self.mesh_co_ranges = []
        # the script owns the deformable and codimensional vertices; meshCO
        # vertices appended below stay out of its initial transforms
        self.n_script_verts = meta.n_verts
        if cfg.mesh_cos:
            mu_parts = [np.zeros(meta.n_verts)]
            for co in cfg.mesh_cos:
                Vc, Fc = io_mesh.read_obj(co.path)
                # centre on the vertex centroid, rotate, max extent to
                # `scale`, move to the origin (reference MeshCO ctor)
                centroid = Vc.mean(axis=0)
                cur_scale = float((Vc.max(axis=0) - Vc.min(axis=0)).max())
                Vc = (co.rotate @ (Vc - centroid[None, :]).T).T * (
                    co.scale / cur_scale) + co.origin[None, :]
                mesh, meta, rng = append_kinematic_surface(mesh, meta, Vc, Fc)
                mu_parts.append(np.full(rng[1] - rng[0], co.friction))
                self.mesh_co_ranges.append(rng)
            vert_mu = np.concatenate(mu_parts)
            self.mesh, self.meta = mesh, meta
            script.n_verts = meta.n_verts
            # scripted obstacle motion: each motion drives its obstacle's
            # vertices; rotations spin about the obstacle's origin
            for mi, motion in enumerate(script.mco_motions):
                if mi >= len(self.mesh_co_ranges):
                    break
                s0, s1 = self.mesh_co_ranges[mi]
                verts = np.arange(s0, s1)
                ang = motion.get("ang")
                if ang is not None and np.any(ang):
                    ang = np.asarray(ang, float)
                    w = float(np.linalg.norm(ang))
                    script.handles.append(HandleMotion(
                        verts=verts, ang_vel=w, axis=ang / w,
                        center=np.asarray(cfg.mesh_cos[mi].origin, float),
                        lin_vel=motion.get("lin")))
                else:
                    script.dbc_groups.append(DBCGroup(verts, motion.get("lin")))
            if script.mco_motions:
                dbc2 = mesh.dbc_mask.cpu().numpy() | script.dbc_mask()
                mesh = dataclasses.replace(mesh, dbc_mask=torch.as_tensor(dbc2,
                                                                          device=mesh.device))
                self.mesh = mesh
            self.script = script

        sc = None
        if (cfg.self_collision or cfg.mesh_cos) and len(mesh.surf_tris) > 0:
            sc = SelfContact(mesh, meta, friction=cfg.self_fric, vert_mu=vert_mu,
                             ccd_method=_ccd_method(cfg.ccd_method))

        p = dict(
            dt=cfg.dt,
            gravity=(0.0, -9.80665, 0.0) if cfg.with_gravity else (0.0, 0.0, 0.0),
            model=cfg.energy,
            fric_iter_amt=cfg.fric_iter_amt,
            kappa_min_mult=cfg.kappa_min_mult,
            time_integration=cfg.time_integration,
            nm_beta=cfg.nm_beta,
            nm_gamma=cfg.nm_gamma,
            damping_stiff=cfg.damping_stiff,
            warm_start=cfg.warm_start,
        )
        if cfg.tuning:
            # [kappa, dHatEps, dHatTarget, dTolRel, fricDHat0, fricDHatTarget]
            keys = ("kappa", "dhat_rel", "dhat_target_rel", "dtol_rel", "fric_dhat0_rel",
                    "fric_dhat_target_rel")
            p.update(zip(keys, cfg.tuning))
        if cfg.dhat is not None:
            # sqrt units; absolute with useAbsParameters
            p["dhat_rel"] = (cfg.dhat / np.sqrt(meta.bbox_diag2) if cfg.use_abs_parameters
                             else cfg.dhat)
        if cfg.epsv is not None:
            p["epsv_rel"] = (cfg.epsv / np.sqrt(meta.bbox_diag2) if cfg.use_abs_parameters
                             else cfg.epsv)
        if cfg.tol:
            p["rel_gl2_tol"] = cfg.tol[0] ** 2
        if overrides:
            p.update(overrides)
        self.params = SimParams(**p)

        if cfg.constraint_solver in ("QP", "SQP"):
            from ipc_tpu_torch.qp.stepper import QPStepper

            self.stepper = QPStepper(mesh, meta, self.params, halfspaces=halfspaces,
                                     self_contact=sc, script=script,
                                     mode=cfg.constraint_solver,
                                     constraint_type=cfg.constraint_type,
                                     constraint_offset=cfg.constraint_offset)
        else:
            self.stepper = IPCStepper(mesh, meta, self.params, halfspaces=halfspaces,
                                      self_contact=sc, script=script)
        self.step_fn = None

    def initial_state(self):
        if self.cfg.restart_path:
            if self.cfg.restart_path.endswith(".npz"):
                return load_status(self.cfg.restart_path, self.stepper)
            return load_status_text(self.cfg.restart_path, self.stepper)
        x_rest = self.mesh.x_rest.detach().cpu().numpy()
        v0 = self.script.initial_velocity(x_rest)
        x0 = None
        if self.script.x0_transform is not None:
            # scripts that start from a transformed configuration move only
            # the script-owned vertices; obstacles stay where placed
            x0 = x_rest.copy()
            x0[:self.n_script_verts] = self.script.x0_transform(x0[:self.n_script_verts])
        return self.stepper.initial_state(x0=x0, v0=v0)

    def _check_initial_feasibility(self, state):
        """Abort on an inverted or self-intersected start state."""
        x0 = state.x.detach().cpu().numpy()
        tets = self.mesh.tets.cpu().numpy()
        if len(tets):
            D = x0[tets[:, 1:]] - x0[tets[:, :1]]
            if np.any(np.linalg.det(D) <= 0.0):
                raise RuntimeError("initial state has inverted elements — check scene "
                                   "transforms / initial-configuration script")
        sc = self.stepper.sc
        if sc is not None and bool(sc.has_intersection(state.x)[0]):
            raise RuntimeError("initial state is self-intersected — check scene shape "
                               "placement")

    def run(self, out_dir, n_steps=None, save_every=1, use_jit_step=False, verbose=False,
            gif=False):
        """Offline loop: step (the host path, or the device step with
        use_jit_step), write status checkpoints, surface meshes and logs into
        out_dir. `verbose` prints the host path's Newton iterations."""
        if use_jit_step and self.cfg.constraint_solver in ("QP", "SQP"):
            raise ValueError(f"use_jit_step runs the IP solve; constraintSolver "
                             f"{self.cfg.constraint_solver} runs on the host path only")
        if use_jit_step and self.script is not None and self.script.host_only():
            raise ValueError("use_jit_step does not support mesh-sequence scripts "
                             "(per-frame file IO); run the host path for those scenes")
        from ipc_tpu_torch.jit_step import initial_device_aux, make_step

        os.makedirs(out_dir, exist_ok=True)
        save_config(self.cfg, os.path.join(out_dir, "config.txt"))
        logger = RunLogger(out_dir)
        state = self.initial_state()
        self._check_initial_feasibility(state)
        self._recorder = None
        self._surf_faces_local = None
        if gif:
            from ipc_tpu_torch.utils.render import RunRecorder

            x_np = state.x.detach().cpu().numpy()
            self._recorder = RunRecorder(x_np, self.mesh.surf_tris.cpu().numpy())
            self._recorder.add(x_np)
        total = n_steps if n_steps is not None else int(round(self.cfg.duration / self.cfg.dt))
        if use_jit_step:
            state = dataclasses.replace(state, aux=initial_device_aux(self.stepper))
            self.step_fn = make_step(self.stepper)
            counts = self.step_fn
        else:
            self.step_fn = None
            counts = self.stepper
        ops0, syncs0 = counts.operator_applications, counts.host_syncs
        self.step_stats = []
        t0 = time.perf_counter()
        try:
            self._run_loop(state, int(state.step), total, logger, out_dir, save_every, verbose)
        except RuntimeError:
            save_status(os.path.join(out_dir, "status_failed.npz"), self._last_state, -1,
                        self.stepper)
            raise
        finally:
            wall = time.perf_counter() - t0
            logger.write_results_stats(wall)
            logger.write_info(dict(
                step_stats=[dataclasses.asdict(s) for s in self.step_stats],
                operator_applications=counts.operator_applications - ops0,
                host_syncs=counts.host_syncs - syncs0,
            ))
            logger.close()
            if self._recorder is not None and self._recorder.frames:
                self._recorder.save(os.path.join(out_dir, "anim.gif"))
        return self._last_state

    def _run_loop(self, state, start, total, logger, out_dir, save_every, verbose):
        self._last_state = state
        for k in range(start, total):
            with logger.timers.section("step"):
                if self.step_fn is None:
                    state, stats = self.stepper.step(state, verbose=verbose)
                else:
                    state, js = self.step_fn(state)
                    # the logger's view of a device step: one record per
                    # step with the active (d < dHat) constraint count
                    stats = _LogStats(
                        iters=js.newton_iters, alphas=[js.last_alpha],
                        n_constraints=[js.active_pt_max + js.active_ee_max],
                        grad_inf=[js.dist_to_opt])
            self.step_stats.append(stats if self.step_fn is None else js)
            self._last_state = state
            logger.log_step(k, stats)
            logger.log_system(self.mesh, self.meta, state, self.stepper.gravity, self.cfg.dt,
                              model=self.cfg.energy)
            if save_every and (k + 1) % save_every == 0:
                if self._recorder is not None:
                    self._recorder.add(state.x.detach().cpu().numpy())
                with logger.timers.section("io"):
                    save_status(os.path.join(out_dir, f"status{k + 1}.npz"), state, k + 1,
                                self.stepper)
                    # the triangulated surface in surface-local indices
                    sv = self.mesh.surf_verts.cpu().numpy()
                    if self._surf_faces_local is None:
                        inv = np.full(self.meta.n_verts, -1, np.int64)
                        inv[sv] = np.arange(len(sv))
                        self._surf_faces_local = inv[self.mesh.surf_tris.cpu().numpy()]
                    io_mesh.write_obj(os.path.join(out_dir, f"surf{k + 1}.obj"),
                                      state.x.detach().cpu().numpy()[sv],
                                      self._surf_faces_local)


@dataclasses.dataclass
class _LogStats:
    iters: int
    alphas: list
    n_constraints: list
    grad_inf: list


def run_scene(config_path, out_dir=None, n_steps=None, dtype=torch.float64, device=None, **kw):
    """Load a scene file and run it (Simulation.run's keywords); out_dir
    defaults to output/<scene name>. Returns the last state."""
    cfg = load_config(config_path)
    sim = Simulation(cfg, dtype=dtype, device=device)
    if out_dir is None:
        base = os.path.splitext(os.path.basename(config_path))[0]
        out_dir = os.path.join("output", base)
    return sim.run(out_dir, n_steps=n_steps, **kw)
