"""Diagnostic CLI: numerical checkers runnable on demand.

Port of ipc_tpu/diagnostic.py, the analog of the reference's Diagnostic
sub-project (src/Projects/Diagnostic/Diagnostic.cpp:56-700): derivative
checks of the energies and distance kernels, dType fuzzing, CCD probes and
solver checks, as named modes:

    python -m ipc_tpu_torch.diagnostic sigma_derivs       (reference mode 11)
    python -m ipc_tpu_torch.diagnostic dist_derivs        (mode 14)
    python -m ipc_tpu_torch.diagnostic dtype_fuzz         (mode 15)
    python -m ipc_tpu_torch.diagnostic ee_dist            (mode 16)
    python -m ipc_tpu_torch.diagnostic ccd_probe          (modes 17/18/25)
    python -m ipc_tpu_torch.diagnostic solver_check       (modes 22/23: PCG on
                                                           a random SPD block system)
    python -m ipc_tpu_torch.diagnostic grad_check <scene> [steps]
                                                          (Optimizer::checkGradient)
    python -m ipc_tpu_torch.diagnostic all

Options: --device (default: the CUDA card, raising without one; `cpu` for
the CPU, as every entry point of the port) and --dtype float64|float32.

The finite-difference modes (sigma_derivs, dist_derivs, grad_check) run in
float64: their references are host float64 differences. The others take a
dtype: float64 by default with the JAX package's limits, and float32 with
limits of float32 rounding (dtype_fuzz: the region-aware distance may
exceed a reduced candidate by 1e-5; ee_dist: |d - 0.25| < 1e-6;
solver_check: PCG to 1e-6, residual below 1e-3). `all` runs every mode but
grad_check, the dtype modes in float64 and in float32. Each mode prints
PASS/FAIL with its measured error; the exit code is 0 only if all pass.

grad_check maps the JAX package's private stepper calls onto the port's
host-path terms (step_terms.build_terms(host=True), what IPCStepper.step
uses): `_candidates(x)` -> `IPCStepper._candidates(x)`, `_grad(x, x_tilde,
kappa, dHat, cand, None)` -> `terms.gradient(...)` over
`sc.active_set(x, cand, dHat)` (the barrier vanishes beyond dHat), and
`_energy_f(...)` -> `terms.e_float(terms.energy(...))` over
`sc.candidate_set(cand)`, each without friction, forces or damping.
"""

import argparse
import sys

import numpy as np
import torch

__all__ = ["MODES", "DTYPE_MODES", "grad_check", "main"]

F64 = torch.float64


def _fd(f, x, eps=1e-6):
    x = np.asarray(x, dtype=np.float64)
    g = np.zeros_like(x)
    it = np.nditer(x, flags=["multi_index"])
    while not it.finished:
        i = it.multi_index
        xp, xm = x.copy(), x.copy()
        xp[i] += eps
        xm[i] -= eps
        g[i] = (f(xp) - f(xm)) / (2 * eps)
        it.iternext()
    return g


def _verdict(ok):
    return "PASS" if ok else "FAIL"


def sigma_derivs(device):
    """Sigma-space dE/d2E checks for NH and FCR (reference mode 11)."""
    from ipc_tpu_torch.energy.elasticity import MODELS
    from ipc_tpu_torch.mesh import lame_params

    mu, lam = (torch.tensor([v], dtype=F64, device=device) for v in lame_params(1e5, 0.4))

    def t(s):
        return torch.as_tensor(np.asarray(s, np.float64)[None], device=device)

    rng = np.random.default_rng(0)
    worst = 0.0
    for name, m in MODELS.items():
        for _ in range(10):
            s = rng.uniform(0.3, 2.0, 3)
            g = m["dE"](t(s), mu, lam)[0].cpu().numpy()
            g_fd = _fd(lambda s: float(m["E"](t(s), mu, lam)[0]), s, 1e-7)
            worst = max(worst, np.abs(g - g_fd).max() / max(1.0, np.abs(g_fd).max()))
            H = m["d2E"](t(s), mu, lam)[0].cpu().numpy()
            H_fd = np.stack([_fd(lambda s: float(m["dE"](t(s), mu, lam)[0, i]), s, 1e-7)
                             for i in range(3)])
            worst = max(worst, np.abs(H - H_fd).max() / max(1.0, np.abs(H_fd).max()))
    ok = worst < 1e-4
    print(f"sigma_derivs: {_verdict(ok)} (max rel err {worst:.3e})")
    return ok


def dist_derivs(device):
    """Distance-kernel gradient FD checks (reference mode 14); the
    gradient by autograd, as JAX takes it by jax.grad."""
    from ipc_tpu_torch.ops import distance as D

    rng = np.random.default_rng(1)
    worst = 0.0
    for ct in range(4):
        code = torch.tensor(ct, device=device)

        def d2(x):
            return D.stencil_dist2(code, torch.as_tensor(x, device=device))

        for _ in range(10):
            x = rng.uniform(-1, 1, (4, 3))
            xt = torch.as_tensor(x, device=device).requires_grad_(True)
            g = torch.autograd.grad(D.stencil_dist2(code, xt), xt)[0].cpu().numpy()
            g_fd = _fd(lambda x: float(d2(x)), x)
            worst = max(worst, np.abs(g - g_fd).max() / max(1.0, np.abs(g_fd).max()))
    ok = worst < 1e-4
    print(f"dist_derivs: {_verdict(ok)} (max rel err {worst:.3e})")
    return ok


def dtype_fuzz(device, dtype=F64, n=2000):
    """dType classification consistency fuzz (reference mode 15): the
    region-aware distance must lower-bound every reduced candidate."""
    from ipc_tpu_torch.ops import distance as D

    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.uniform(-1, 1, (n, 4, 3)), device=device).to(dtype)
    x0, x1, x2, x3 = X[:, 0], X[:, 1], X[:, 2], X[:, 3]
    d_pt = D.point_triangle_dist2(x0, x1, x2, x3)
    m_pt = torch.stack([D.d_PP(x0, x1), D.d_PP(x0, x2), D.d_PP(x0, x3),
                        D.point_edge_dist2(x0, x1, x2), D.point_edge_dist2(x0, x2, x3),
                        D.point_edge_dist2(x0, x3, x1)]).amin(dim=0)
    d_ee = D.edge_edge_dist2(x0, x1, x2, x3)
    m_ee = torch.stack([D.point_edge_dist2(x0, x2, x3), D.point_edge_dist2(x1, x2, x3),
                        D.point_edge_dist2(x2, x0, x1),
                        D.point_edge_dist2(x3, x0, x1)]).amin(dim=0)
    tol = 1e-12 if dtype == F64 else 1e-5
    # the worst slack: how far the region-aware distance rises above the
    # smallest reduced candidate (<= tol passes)
    slack = float(torch.maximum(d_pt - m_pt, d_ee - m_ee).max())
    ok = slack <= tol
    print(f"dtype_fuzz: {_verdict(ok)} ({n} samples, worst slack {slack:.6e})")
    return ok


def ee_dist(device, dtype=F64):
    """EE distance + mollifier checks (reference mode 16/24)."""
    from ipc_tpu_torch.ops import distance as D

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)

    x = t([[-1.0, 0, 0], [1, 0, 0], [0, 0.5, -1], [0, 0.5, 1]])
    d = float(D.edge_edge_dist2(x[0], x[1], x[2], x[3]))
    ok = abs(d - 0.25) < (1e-12 if dtype == F64 else 1e-6)
    # a nearly parallel pair is mollified
    xp = t([[0.0, 0, 0], [1, 0, 0], [0.0, 0.01, 1e-4], [1.0, 0.01, 0]])
    e = float(D.mollifier_ee(xp, D.eps_x_ee(xp[0], xp[1], xp[2], xp[3])))
    ok = ok and 0.0 < e < 1.0
    print(f"ee_dist: {_verdict(ok)} (d={d}, mollifier={e:.3g})")
    return ok


def ccd_probe(device, dtype=F64):
    """Interactive-style CCD probes (reference modes 17/18/25)."""
    from ipc_tpu_torch.contact.ccd import accd_ee, accd_pt
    from ipc_tpu_torch.ops import distance as D

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64)[None], device=device).to(dtype)

    ok = True
    for kind, accd, dist2, x4, p4 in (
            ("PT", accd_pt, D.point_triangle_dist2,
             [[0.25, 1.0, 0.25], [0, 0, 0], [1, 0, 0], [0, 0, 1]],
             [[0.0, -2.0, 0.0], [0, 0, 0], [0, 0, 0], [0, 0, 0]]),
            ("EE", accd_ee, D.edge_edge_dist2,
             [[-1.0, 1, 0], [1, 1, 0], [0, 0, -1], [0, 0, 1]],
             [[0.0, -2, 0], [0, -2, 0], [0, 0, 0], [0, 0, 0]])):
        x4, p4 = t(x4), t(p4)
        toi = accd(x4, p4, 0.2, 64)
        y = (x4 + toi[:, None, None] * p4)[0]
        t_f, d_at_t = float(toi[0]), float(dist2(y[0], y[1], y[2], y[3]))
        print(f"  {kind} head-on: toi={t_f:.4f} (exact impact 0.5), d(toi)={d_at_t:.3e}")
        ok = ok and 0.3 < t_f < 0.5 and d_at_t > 0
    print(f"ccd_probe: {_verdict(ok)}")
    return ok


def solver_check(device, dtype=F64):
    """PCG on a random block-SPD system (reference modes 22/23/105)."""
    from ipc_tpu_torch.solver.pcg import apply_block_precond, block_jacobi_inverse, pcg

    rng = np.random.default_rng(3)
    n = 200
    A = rng.normal(size=(3 * n, 3 * n))
    A = A @ A.T + 3 * n * np.eye(3 * n)
    b = rng.normal(size=(n, 3))
    At = torch.as_tensor(A, device=device).to(dtype)
    diag = torch.as_tensor(np.stack([A[3 * i:3 * i + 3, 3 * i:3 * i + 3] for i in range(n)]),
                           device=device).to(dtype)
    inv = block_jacobi_inverse(diag)
    tol, limit = (1e-10, 1e-6) if dtype == F64 else (1e-6, 1e-3)
    x, it, _ = pcg(lambda v: (At @ v.reshape(-1)).reshape(n, 3),
                   torch.as_tensor(b, device=device).to(dtype),
                   lambda r: apply_block_precond(inv, r), tol=tol)
    err = float(np.abs(A @ x.double().cpu().numpy().reshape(-1) - b.reshape(-1)).max())
    ok = err < limit
    print(f"solver_check: {_verdict(ok)} (iters={it}, residual {err:.3e})")
    return ok


def grad_check(scene_path, steps=1, device=None):
    """Full-objective FD gradient check on a scene (reference
    Optimizer::checkGradient, Optimizer.cpp:3780-3826), on the host-path
    terms (module docstring)."""
    from ipc_tpu_torch.config import load_config
    from ipc_tpu_torch.device import resolve_device
    from ipc_tpu_torch.sim import Simulation

    sim = Simulation(load_config(scene_path), dtype=F64, device=resolve_device(device))
    st = sim.stepper
    state = sim.initial_state()
    for _ in range(steps):
        state, _ = st.step(state)
    x = state.x
    x_tilde = st.compute_x_tilde(state)
    T = st._terms_for()
    cand = st._candidates(x)
    kappa = st.suggest_kappa(st.dHat)
    act = None if st.sc is None else st.sc.active_set(x, cand, st.dHat)
    act_e = None if st.sc is None else st.sc.candidate_set(cand)
    g = T.gradient(x, x_tilde, kappa, st.dHat, None, None, None, act, st._hs_D, None,
                   T.dbc).cpu().numpy()

    def energy(xn):
        xt = torch.as_tensor(xn, device=x.device)
        return T.e_float(T.energy(xt, x_tilde, kappa, st.dHat, None, act=act_e, hsD=st._hs_D))

    xn = x.cpu().numpy()
    dbc = st.mesh.dbc_mask.cpu().numpy()
    rng = np.random.default_rng(0)
    worst = 0.0
    for vi in rng.choice(len(xn), min(5, len(xn)), replace=False):
        if dbc[vi]:
            continue
        for c in range(3):
            eps = 1e-7
            xp, xm = xn.copy(), xn.copy()
            xp[vi, c] += eps
            xm[vi, c] -= eps
            fd = (energy(xp) - energy(xm)) / (2 * eps)
            worst = max(worst, abs(g[vi, c] - fd) / max(1.0, abs(fd)))
    ok = worst < 1e-3
    print(f"grad_check({scene_path}): {_verdict(ok)} (max rel err {worst:.3e})")
    return ok


MODES = {
    "sigma_derivs": sigma_derivs,
    "dist_derivs": dist_derivs,
    "dtype_fuzz": dtype_fuzz,
    "ee_dist": ee_dist,
    "ccd_probe": ccd_probe,
    "solver_check": solver_check,
}
DTYPE_MODES = ("dtype_fuzz", "ee_dist", "ccd_probe", "solver_check")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ipc_tpu_torch.diagnostic", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", help=f"{', '.join(MODES)}, grad_check or all")
    ap.add_argument("args", nargs="*", help="grad_check: scene file [steps]")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--dtype", default="float64", choices=("float64", "float32"),
                    help="dtype of the modes that take one (not `all`, which runs both)")
    args = ap.parse_args(argv)

    from ipc_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    dtype = F64 if args.dtype == "float64" else torch.float32
    if args.mode == "all":
        ok = True
        for name, fn in MODES.items():
            for dt in ((F64, torch.float32) if name in DTYPE_MODES else (F64,)):
                if name in DTYPE_MODES:
                    print(f"[{name} {str(dt).removeprefix('torch.')}]")
                ok = (fn(device, dt) if name in DTYPE_MODES else fn(device)) and ok
    elif args.mode == "grad_check":
        if not args.args:
            ap.error("grad_check needs a scene file")
        steps = int(args.args[1]) if len(args.args) > 1 else 1
        ok = grad_check(args.args[0], steps, device)
    elif args.mode in MODES:
        fn = MODES[args.mode]
        ok = fn(device, dtype) if args.mode in DTYPE_MODES else fn(device)
    else:
        print(f"unknown mode {args.mode}; modes: {', '.join(MODES)}, grad_check, all")
        return 2
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
