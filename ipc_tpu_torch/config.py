"""Scene-script DSL parser — reference-compatible config files.

The port's own copy of ipc_tpu/config.py (numpy only; the port imports
nothing of the JAX package). tests/test_torch_io_config.py holds it equal
to the original on the scene texts of the JAX tests and on scenes/*.txt.

Parses the same `.txt` scene scripts the reference consumes
(reference: src/Config.cpp:97-624, keyword semantics; src/Config.hpp:23-146
defaults), so reference scenes under input/ run unmodified. Rendering/viewer
keywords (view/zoom/cameraTracking/playBackSpeed) are parsed and stored but
unused. The `section` block mechanism (per-constraint-solver overrides,
Config.cpp:572-624) applies the block matching the active constraint solver.

Shape lines (after `shapes input N`):
  path  tx ty tz  rx ry rz  sx sy sz  [material rho E nu]
  [linearVelocity vx vy vz] [angularVelocity wx wy wz(deg/s)]
  [DBC minx miny minz maxx maxy maxz vx vy vz wx wy wz [t0 t1]]
  [NBC minx miny minz maxx maxy maxz fx fy fz [t0 t1]]
  [initVel vx vy vz wx wy wz] [meshSeq folder] [\\ line continuation]
Rotations are XYZ Euler angles in degrees (Config.cpp:216-222).
"""

import math
import os
from dataclasses import dataclass, field

import numpy as np

__all__ = ["ShapeSpec", "DBCSpec", "NBCSpec", "HalfSpaceSpec", "MeshCOSpec", "Config"]


def _euler_xyz_deg(rx, ry, rz):
    """Rotation matrix from XYZ Euler angles in degrees (matches the
    reference's AngleAxis composition order, Config.cpp:216-222)."""

    def rot(axis, deg):
        a = math.radians(deg)
        c, s = math.cos(a), math.sin(a)
        if axis == 0:
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == 1:
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    return rot(0, rx) @ rot(1, ry) @ rot(2, rz)


@dataclass
class DBCSpec:
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    linear_vel: np.ndarray
    angular_vel: np.ndarray  # rad/s
    time_range: tuple = (0.0, math.inf)


@dataclass
class NBCSpec:
    bbox_min: np.ndarray
    bbox_max: np.ndarray
    force: np.ndarray
    time_range: tuple = (0.0, math.inf)


@dataclass
class ShapeSpec:
    path: str
    translate: np.ndarray = None
    rotate: np.ndarray = None  # 3x3
    scale: np.ndarray = None
    material: tuple = (None, None, None)  # rho, E, nu
    linear_vel: np.ndarray = None
    angular_vel: np.ndarray = None  # rad/s
    init_lvel: np.ndarray = None
    init_avel: np.ndarray = None  # rad/s
    dbc: list = field(default_factory=list)
    nbc: list = field(default_factory=list)
    mesh_seq: str = None


@dataclass
class HalfSpaceSpec:
    origin: tuple
    normal: tuple
    friction: float


@dataclass
class MeshCOSpec:
    path: str
    origin: np.ndarray
    rotate: np.ndarray
    scale: float
    friction: float


@dataclass
class Config:
    """Parsed scene (defaults mirror src/Config.hpp:85-146)."""

    energy: str = "NH"
    time_integration: str = "BE"
    nm_beta: float = 0.25
    nm_gamma: float = 0.5
    lin_sys_solver: str = "PCG"  # reference default CHOLMOD -> our PCG
    duration: float = 5.0
    dt: float = 0.025
    rho: float = 1000.0
    ym: float = 1e5
    pr: float = 0.4
    with_gravity: bool = True
    damping_stiff: float = 0.0
    damping_ratio: float = 0.0
    script: str = "null"
    script_params: list = field(default_factory=list)
    mesh_seq_folder: str = None
    dbc_time_range: tuple = (0.0, math.inf)
    nbc_time_range: tuple = (0.0, math.inf)
    shapes: list = field(default_factory=list)
    halfspaces: list = field(default_factory=list)
    mesh_cos: list = field(default_factory=list)
    self_collision: bool = True
    self_fric: float = 0.0
    constraint_solver: str = "IP"
    constraint_type: str = "volume"  # reference default (Config.hpp:148)
    qp_solver: str = "OSQP"
    ccd_method: str = "ACCD"
    ccd_tolerance: float = 1e-6
    tol: list = field(default_factory=list)
    warm_start: int = 0
    handle_ratio: float = 0.01
    rotate_model: tuple = None  # (axis (3,), deg)
    dhat: float = None  # absolute sqrt-units override (keyword `dHat`)
    epsv: float = None
    fric_iter_amt: int = 1
    use_abs_parameters: bool = False
    kappa_min_mult: float = 1e11
    constraint_offset: float = 0.0
    tuning: list = field(default_factory=list)
    restart_path: str = None
    append_str: str = ""
    # viewer-only (parsed, unused)
    orthographic: bool = False
    zoom: float = 1.0
    camera_tracking: bool = False
    playback_speed: float = 1.0
    size: float = -1.0


def _resolve(path, cfg_path):
    """Resolve a scene-relative path like the reference's resolvePath: try
    relative to the config file, then relative to an `input/` sibling, then
    as given."""
    cands = [
        os.path.join(os.path.dirname(cfg_path), path),
        path,
    ]
    # reference scenes use paths like `input/tetMeshes/cube.msh` relative to
    # the repo root; walk up from the config dir looking for them
    d = os.path.dirname(os.path.abspath(cfg_path))
    for _ in range(6):
        cands.append(os.path.join(d, path))
        d = os.path.dirname(d)
    for c in cands:
        if os.path.exists(c):
            return c
    # .seg shapes may exist only as the same-stem .obj (the reference's
    # readSEG fallback); resolve against that stem too
    if path.endswith((".seg", ".pt")):
        for c in cands:
            if os.path.exists(os.path.splitext(c)[0] + ".obj"):
                return c
    return path


def load_config(path):
    """Parse a scene script -> Config."""
    cfg = Config()
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0

    def next_line():
        nonlocal i
        line = lines[i]
        i += 1
        return line

    while i < len(lines):
        toks = next_line().split()
        if not toks or toks[0].startswith("#"):
            continue
        t = toks[0]
        if t == "energy":
            cfg.energy = {"NH": "NH", "FCR": "FCR"}.get(toks[1], "NH")
        elif t == "timeIntegration":
            cfg.time_integration = toks[1]
            if toks[1] == "NM" and len(toks) >= 4:
                cfg.nm_beta, cfg.nm_gamma = float(toks[2]), float(toks[3])
        elif t in ("linearSolver", "linSysSolver"):
            cfg.lin_sys_solver = toks[1]
        elif t == "size":
            cfg.size = float(toks[1])
        elif t == "time":
            cfg.duration, cfg.dt = float(toks[1]), float(toks[2])
        elif t == "density":
            cfg.rho = float(toks[1])
        elif t == "stiffness":
            cfg.ym, cfg.pr = float(toks[1]), float(toks[2])
        elif t == "turnOffGravity":
            cfg.with_gravity = False
        elif t == "dampingStiff":
            cfg.damping_stiff = max(0.0, float(toks[1]))
        elif t == "dampingRatio":
            cfg.damping_ratio = min(1.0, max(0.0, float(toks[1])))
        elif t == "script":
            cfg.script = toks[1]
            rest = toks[2:]
            if toks[1] == "meshSeqFromFile" and rest:
                cfg.mesh_seq_folder = _resolve(rest[0], path)
                rest = rest[1:]
            if rest:
                n = int(rest[0])
                cfg.script_params = [float(v) for v in rest[1 : 1 + n]]
        elif t == "DBCTimeRange":
            cfg.dbc_time_range = (float(toks[1]), float(toks[2]))
        elif t == "NBCTimeRange":
            cfg.nbc_time_range = (float(toks[1]), float(toks[2]))
        elif t == "shape":
            cfg.shapes.append(
                ShapeSpec(
                    path=_resolve(toks[2], path),
                    translate=np.zeros(3),
                    rotate=np.eye(3),
                    scale=np.ones(3),
                )
            )
        elif t == "shapes":
            n = int(toks[2])
            got = 0
            while got < n:
                sl = next_line()
                stoks = sl.split()
                if not stoks or stoks[0].startswith("#"):
                    continue
                # line continuation
                while stoks and stoks[-1] == "\\":
                    stoks = stoks[:-1] + next_line().split()
                sp = ShapeSpec(
                    path=_resolve(stoks[0], path),
                    translate=np.array([float(v) for v in stoks[1:4]]),
                    rotate=_euler_xyz_deg(*[float(v) for v in stoks[4:7]]),
                    scale=np.array([float(v) for v in stoks[7:10]]),
                )
                k = 10
                while k < len(stoks):
                    ex = stoks[k]
                    if ex == "material":
                        sp.material = tuple(float(v) for v in stoks[k + 1 : k + 4])
                        k += 4
                    elif ex == "linearVelocity":
                        sp.linear_vel = np.array([float(v) for v in stoks[k + 1 : k + 4]])
                        k += 4
                    elif ex == "angularVelocity":
                        sp.angular_vel = np.radians(
                            np.array([float(v) for v in stoks[k + 1 : k + 4]])
                        )
                        k += 4
                    elif ex == "DBC":
                        vals = [float(v) for v in stoks[k + 1 : k + 13]]
                        k += 13
                        tr = [0.0, math.inf]
                        for j in range(2):
                            if k < len(stoks):
                                try:
                                    tr[j] = float(stoks[k])
                                    k += 1
                                except ValueError:
                                    break
                        sp.dbc.append(
                            DBCSpec(
                                np.array(vals[0:3]),
                                np.array(vals[3:6]),
                                np.array(vals[6:9]),
                                np.radians(np.array(vals[9:12])),
                                (tr[0], tr[1]),
                            )
                        )
                    elif ex == "NBC":
                        vals = [float(v) for v in stoks[k + 1 : k + 10]]
                        k += 10
                        tr = [0.0, math.inf]
                        for j in range(2):
                            if k < len(stoks):
                                try:
                                    tr[j] = float(stoks[k])
                                    k += 1
                                except ValueError:
                                    break
                        sp.nbc.append(
                            NBCSpec(
                                np.array(vals[0:3]),
                                np.array(vals[3:6]),
                                np.array(vals[6:9]),
                                (tr[0], tr[1]),
                            )
                        )
                    elif ex == "initVel":
                        vals = [float(v) for v in stoks[k + 1 : k + 7]]
                        sp.init_lvel = np.array(vals[0:3])
                        sp.init_avel = np.radians(np.array(vals[3:6]))
                        k += 7
                    elif ex == "meshSeq":
                        sp.mesh_seq = _resolve(stoks[k + 1], path)
                        k += 2
                    elif ex.startswith("#"):
                        break
                    else:
                        k += 1  # unknown keyword: skip (reference logs error)
                cfg.shapes.append(sp)
                got += 1
        elif t == "shapeMatrix":
            cnt = [int(v) for v in toks[2:5]]
            pos = [float(v) for v in toks[5:8]] if len(toks) >= 8 else [0.0, 0.0, 0.0]
            sl = next_line().split()
            spath = _resolve(sl[0], path)
            step = [float(v) for v in sl[1:4]]
            rot = _euler_xyz_deg(*[float(v) for v in sl[4:7]])
            scale = np.array([float(v) for v in sl[7:10]])
            mat = (None, None, None)
            if len(sl) > 10 and sl[10] == "material":
                mat = tuple(float(v) for v in sl[11:14])
            for xi in range(cnt[0]):
                for yi in range(cnt[1]):
                    for zi in range(cnt[2]):
                        cfg.shapes.append(
                            ShapeSpec(
                                path=spath,
                                translate=np.array(
                                    [
                                        pos[0] + step[0] * xi,
                                        pos[1] + step[1] * yi,
                                        pos[2] + step[2] * zi,
                                    ]
                                ),
                                rotate=rot,
                                scale=scale,
                                material=mat,
                            )
                        )
        elif t == "tol":
            n = int(toks[1])
            vals = []
            while len(vals) < n:
                vals.extend(float(v) for v in next_line().split())
            cfg.tol = vals[:n]
        elif t == "warmStart":
            cfg.warm_start = int(toks[1])
        elif t == "ground":
            fric, y = float(toks[1]), float(toks[2])
            cfg.halfspaces.append(
                HalfSpaceSpec(origin=(0.0, y, 0.0), normal=(0.0, 1.0, 0.0), friction=fric)
            )
        elif t == "halfSpace":
            o = tuple(float(v) for v in toks[1:4])
            nrm = tuple(float(v) for v in toks[4:7])
            fric = float(toks[8])  # toks[7] is the unused stiffness
            cfg.halfspaces.append(HalfSpaceSpec(origin=o, normal=nrm, friction=fric))
        elif t == "meshCO":
            p = _resolve(toks[1], path)
            origin = np.array([float(v) for v in toks[2:5]])
            scale, _stiff, fric = float(toks[5]), float(toks[6]), float(toks[7])
            rot = np.eye(3)
            if len(toks) > 8 and toks[8] == "rotate":
                rot = _euler_xyz_deg(*[float(v) for v in toks[9:12]])
            cfg.mesh_cos.append(MeshCOSpec(p, origin, rot, scale, fric))
        elif t == "selfCollisionOn":
            cfg.self_collision = True
        elif t == "selfCollisionOff":
            cfg.self_collision = False
        elif t == "selfFric":
            cfg.self_fric = float(toks[1])
        elif t == "constraintSolver":
            cfg.constraint_solver = {"interiorPoint": "IP", "IP": "IP"}.get(toks[1], toks[1])
        elif t == "QPSolver":
            cfg.qp_solver = toks[1]  # OSQP/Gurobi in the reference; the TPU
            # build always uses the matrix-free ADMM solver (qp/admm.py)
        elif t == "constraintType":
            cfg.constraint_type = toks[1]
        elif t == "appendStr":
            cfg.append_str = toks[1]
        elif t == "restart":
            cfg.restart_path = _resolve(toks[1], path)
        elif t == "disableCout":
            pass
        elif t == "rotateModel":
            cfg.rotate_model = (
                np.array([float(v) for v in toks[1:4]]),
                float(toks[4]),
            )
        elif t == "handleRatio":
            cfg.handle_ratio = float(toks[1])
        elif t == "tuning":
            n = int(toks[1])
            vals = []
            while len(vals) < n:
                vals.extend(float(v) for v in next_line().split())
            cfg.tuning = vals[:n]
        elif t == "dHat":
            cfg.dhat = float(toks[1])
        elif t == "epsv":
            cfg.epsv = float(toks[1])
        elif t == "fricIterAmt":
            cfg.fric_iter_amt = int(toks[1])
        elif t == "useAbsParameters":
            cfg.use_abs_parameters = True
        elif t in ("kappaMinMultiplier", "minBarrierStiffnessScale"):
            cfg.kappa_min_mult = float(toks[1])
        elif t == "constraintOffset":
            cfg.constraint_offset = float(toks[1])
        elif t in ("CCDMethod", "ccdMethod"):
            cfg.ccd_method = toks[1]
        elif t in ("CCDTolerance", "ccdTolerance"):
            cfg.ccd_tolerance = float(toks[1])
        elif t == "view":
            cfg.orthographic = len(toks) > 1 and toks[1] == "orthographic"
        elif t == "zoom":
            cfg.zoom = float(toks[1])
        elif t == "cameraTracking":
            cfg.camera_tracking = True
        elif t == "playBackSpeed":
            cfg.playback_speed = float(toks[1])
        elif t == "section":
            # apply only the section matching our constraint solver (IP)
            name = toks[1]
            body = []
            while i < len(lines):
                stoks = lines[i].split()
                i += 1
                if stoks and stoks[0] == "section" and len(stoks) > 1 and stoks[1] == "end":
                    break
                body.append(lines[i - 1])
            if name == cfg.constraint_solver or name == "IP":
                lines[i:i] = body  # splice the body in for parsing
        # unknown keywords are ignored (reference warns and continues)
    return cfg


def save_config(cfg: Config, path):
    """Write back a config.txt snapshot (reference backUpConfig,
    Config.cpp:625)."""
    with open(path, "w") as f:
        f.write(f"energy {cfg.energy}\n")
        f.write(f"timeIntegration {cfg.time_integration}\n")
        f.write(f"time {cfg.duration} {cfg.dt}\n")
        f.write(f"density {cfg.rho}\n")
        f.write(f"stiffness {cfg.ym} {cfg.pr}\n")
        if not cfg.with_gravity:
            f.write("turnOffGravity\n")
        f.write(f"script {cfg.script}\n")
        f.write(f"shapes input {len(cfg.shapes)}\n")
        for s in cfg.shapes:
            f.write(f"# {s.path}\n")
        for h in cfg.halfspaces:
            if tuple(h.normal) == (0.0, 1.0, 0.0):
                f.write(f"ground {h.friction} {h.origin[1]}\n")
            else:
                f.write(
                    f"halfSpace {h.origin[0]} {h.origin[1]} {h.origin[2]} "
                    f"{h.normal[0]} {h.normal[1]} {h.normal[2]} 1e5 {h.friction}\n"
                )
        if cfg.self_fric > 0:
            f.write(f"selfFric {cfg.self_fric}\n")
        f.write(f"{'selfCollisionOn' if cfg.self_collision else 'selfCollisionOff'}\n")
