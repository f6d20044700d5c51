"""The reference's judgement of time steps, in plain PyTorch (float64).

A backward-Euler IPC step from (x_n, v_n) ends at a stationary point of
the incremental potential

    E(x) = 1/2 sum_i m_i |x_i - x~_i|^2 + h^2 sum_t vol_t Psi_NH(F_t(x))
           + kappa (B_ground(x) + B_self(x)) + kappa D_friction(x),
    x~ = x_n + h v_n + h^2 g,

over the free (unscripted) vertices, with the clamped log barrier b(d^2)
of every surface vertex against the ground and of every point-triangle and
edge-edge pair of the surface (edge-edge mollified near parallel), and
lagged smoothed Coulomb friction. `step_numbers` evaluates that gradient at
the program's x_{n+1}, from positions alone. Two quantities of the method
are the program's own choices and are not read from it: the barrier
stiffness kappa, which the reference fits by least squares (one scalar for
the whole step), and the friction lagging point, which the reference takes
at x_n (the program lags at its warm-start iterate). The step's numbers:

  residual    |grad E| over |each force family's magnitude| (2-norms over
              the free vertices; 0 at an exact minimiser, ~1 when the
              forces do not balance at all);
  handle_err  the scripted handles' largest miss of their prescribed
              rotation from x_n, over their largest prescribed move;
  min_det     the least tet volume ratio det F (no inverted tet: > 0);
  min_gap     the least surface distance, pairs and ground, over the
              barrier width dHat (no interpenetration: > 0; 1 when nothing
              is closer than dHat);
  crossings   surface edges passing through a surface triangle (0).

`judge_chain` runs a chain of steps from x_0, v_0 (velocities worked out
again as (x_{n+1} - x_n)/h) and keeps each number's worst value.
"""

import math

import torch

from . import contact as C

__all__ = ["step_numbers", "judge_chain", "WORST"]

# which way each number is worse
WORST = {"newton": max, "handle_err": max, "min_det": min, "min_gap": min, "crossings": max}


def _barrier(d2, dhat2):
    active = (d2 > 0) & (d2 < dhat2)
    ds = torch.where(active, d2, torch.full_like(d2, dhat2))
    b = -(ds - dhat2) ** 2 * torch.log(ds / dhat2)
    return torch.where(active, b, torch.zeros_like(b))


def _barrier_grad(d2, dhat2):
    active = (d2 > 0) & (d2 < dhat2)
    ds = torch.where(active, d2, torch.full_like(d2, dhat2))
    t = ds - dhat2
    g = -2.0 * t * torch.log(ds / dhat2) - t * t / ds
    return torch.where(active, g, torch.zeros_like(g))


def _f0(u2, eps):
    """Smoothed |u| (first-order static-friction clamp of band eps)."""
    small = u2 <= eps * eps
    pos = small & (u2 > 0)
    us = torch.where(small, u2, torch.zeros_like(u2))
    # sqrt's derivative at 0 is infinite: keep it off the graph there
    root = torch.where(pos, torch.sqrt(torch.where(pos, u2, torch.ones_like(u2))),
                       torch.zeros_like(u2))
    f_small = us * (-root / 3.0 + eps) / (eps * eps) + eps / 3.0
    f_big = torch.sqrt(torch.where(small, torch.full_like(u2, eps * eps), u2))
    return torch.where(small, f_small, f_big)


def _psi_nh(scene, x):
    x4 = x[scene.tets]
    Ds = torch.stack([x4[:, 1] - x4[:, 0], x4[:, 2] - x4[:, 0], x4[:, 3] - x4[:, 0]], dim=2)
    F = Ds @ scene.rest_inv
    J = torch.linalg.det(F)
    # an inverted tet is reported by min_det; its energy is kept finite so
    # the other numbers still read
    logJ = torch.log(torch.clamp(J, min=1e-12))
    psi = (0.5 * scene.mu * ((F * F).sum(dim=(1, 2)) - 3.0) - scene.mu * logJ
           + 0.5 * scene.lam * logJ * logJ)
    return (scene.vol * psi).sum(), J


class _Pairs:
    """Surface point-triangle and edge-edge pairs within dHat at x, with
    their closest-point weights (held fixed) and squared distances."""

    def __init__(self, scene, x, r):
        dev = x.device
        self.pt = self.ee = torch.zeros((0, 4), dtype=torch.int64, device=dev)
        if not scene.self_contact:
            return
        sv, tris, edges = scene.surf, scene.tris, scene.edges
        ia, ib = C.near_pairs(x, sv[:, None], tris, r)
        pt = torch.cat([sv[ia][:, None], tris[ib]], dim=1)
        pt = pt[(pt[:, :1] != pt[:, 1:]).all(dim=1)]
        ia, ib = C.near_pairs(x, edges, edges, r)
        keep = ia < ib
        ee = torch.cat([edges[ia[keep]], edges[ib[keep]]], dim=1)
        shared = (ee[:, :2, None] == ee[:, None, 2:]).any(dim=2).any(dim=1)
        self.pt, self.ee = pt, ee[~shared]

    @staticmethod
    def weights(x, pt, ee):
        with torch.no_grad():
            xp, xe = x[pt], x[ee]
            wp = C.pt_closest(xp[:, 0], xp[:, 1], xp[:, 2], xp[:, 3])
            we = C.ee_closest(xe[:, 0], xe[:, 1], xe[:, 2], xe[:, 3])
        return wp, we


def _dist2(x, ids, w):
    q = torch.einsum("ni,nij->nj", w, x[ids])
    return (q * q).sum(-1), q


def _cross2(x, ee):
    xe = x[ee]
    c = torch.cross(xe[:, 1] - xe[:, 0], xe[:, 3] - xe[:, 2], dim=-1)
    return (c * c).sum(-1)


def _eps_x(scene, ee):
    xr = scene.x_rest[ee]
    ea = ((xr[:, 0] - xr[:, 1]) ** 2).sum(-1)
    eb = ((xr[:, 2] - xr[:, 3]) ** 2).sum(-1)
    return 1e-3 * ea * eb


def _mollifier(c2, eps_x):
    r = c2 / eps_x
    return torch.where(c2 < eps_x, (2.0 - r) * r, torch.ones_like(r))


def _lag_entries(scene, x_lag, only=None):
    """Lagged friction entries at x_lag with unit stiffness: per ground
    vertex and per pair, (key (N,), vertex ids (N,k), weights (N,k),
    tangent projector (N,3,3), multiplier mu * lambda (N,)). `only` keeps
    the entries whose key is not in it."""
    dhat2 = scene.dhat2
    V = scene.mass.shape[0]
    out = []
    g = scene.ground
    if g is not None and g["friction"] > 0:
        sv = scene.surf
        s = x_lag[sv] @ g["normal"] + g["offset"]
        d2 = s * s
        on = (d2 < dhat2) & (d2 > 1e-12 * dhat2) & (s > 0)
        lam = -2.0 * torch.sqrt(d2) * _barrier_grad(d2, dhat2)
        n = g["normal"]
        P = torch.eye(3, dtype=x_lag.dtype, device=x_lag.device) - torch.outer(n, n)
        k = int(on.sum())
        out.append((-1 - sv[on], sv[on][:, None],
                    torch.ones((k, 1), dtype=x_lag.dtype, device=x_lag.device),
                    P.expand(k, 3, 3), g["friction"] * lam[on]))
    if scene.self_contact and scene.mu_self > 0:
        pairs = _Pairs(scene, x_lag, math.sqrt(dhat2))
        wp, we = pairs.weights(x_lag, pairs.pt, pairs.ee)
        for ids, w, is_ee in ((pairs.pt, wp, False), (pairs.ee, we, True)):
            d2, q = _dist2(x_lag, ids, w)
            on = (d2 > 1e-12 * dhat2) & (d2 < dhat2)
            if is_ee:  # mollified edge-edge pairs carry no friction
                on = on & (_cross2(x_lag, ids) >= _eps_x(scene, ids))
            lam = -2.0 * torch.sqrt(d2) * _barrier_grad(d2, dhat2)
            nrm = q / torch.sqrt(torch.clamp(d2, min=1e-300))[:, None]
            P = (torch.eye(3, dtype=x_lag.dtype, device=x_lag.device)
                 - nrm[:, :, None] * nrm[:, None, :])
            key = ((ids[:, 0] * V + ids[:, 1]) * V + ids[:, 2]) * V + ids[:, 3]
            key = key * 2 + int(is_ee)
            out.append((key[on], ids[on], w[on], P[on], scene.mu_self * lam[on]))
    if only is not None:
        out = [tuple(a[~torch.isin(e[0], only)] for a in e) for e in out]
    return out


def _friction_lag(scene, x_n, x_next):
    """The lagged friction of a step: each contact active at x_n lagged
    there, and each contact that the step makes (active at x_next only)
    lagged at x_next. The method lags at its own warm start, between the
    two, which the reference does not see."""
    first = _lag_entries(scene, x_n)
    keys = torch.cat([e[0] for e in first]) if first else None
    later = _lag_entries(scene, x_next, only=keys) if first else []
    return [e[1:] for e in first + later]


def _contact_energy(scene, x, pairs, wp, we, lag, x_n):
    """Unit-stiffness barrier + friction energy at x."""
    dhat2 = scene.dhat2
    E = torch.zeros((), dtype=x.dtype, device=x.device)
    g = scene.ground
    if g is not None:
        s = x[scene.surf] @ g["normal"] + g["offset"]
        E = E + _barrier(s * s, dhat2).sum()
    if pairs.pt.shape[0]:
        E = E + _barrier(_dist2(x, pairs.pt, wp)[0], dhat2).sum()
    if pairs.ee.shape[0]:
        d2, _ = _dist2(x, pairs.ee, we)
        E = E + (_mollifier(_cross2(x, pairs.ee), _eps_x(scene, pairs.ee))
                 * _barrier(d2, dhat2)).sum()
    eps = math.sqrt(scene.eps2)
    for ids, w, P, lam in lag:
        if ids.shape[0] == 0:
            continue
        rel = torch.einsum("nk,nkj->nj", w, x[ids] - x_n[ids])
        u = torch.einsum("nij,nj->ni", P, rel)
        E = E + (lam * _f0((u * u).sum(-1), eps)).sum()
    return E


def _kappa_suggest(scene):
    """The barrier stiffness the method starts from (IPC's suggestKappa):
    1e11 * average node mass / (4e-16 bboxDiag^2 * b''(1e-16 bboxDiag^2))."""
    diag2 = scene.bbox_diag ** 2
    d = 1e-16 * diag2
    t = d - scene.dhat2
    Hb = -2.0 * math.log(d / scene.dhat2) - 4.0 * t / d + (t * t) / (d * d)
    avg_m = float(scene.mass.sum()) / scene.mass.shape[0]
    return 1e11 * avg_m / (4e-16 * diag2 * Hb)


def _tet_blocks(scene, x):
    """(T,12,12) per-tet Hessians of h^2 vol Psi_NH, projected to PSD."""
    h2 = scene.dt * scene.dt

    def psi(x12, Dinv, vol):
        x4 = x12.reshape(4, 3)
        Ds = torch.stack([x4[1] - x4[0], x4[2] - x4[0], x4[3] - x4[0]], dim=1)
        F = Ds @ Dinv
        J = torch.dot(F[:, 0], torch.linalg.cross(F[:, 1], F[:, 2]))
        logJ = torch.log(torch.clamp(J, min=1e-12))
        return h2 * vol * (0.5 * scene.mu * ((F * F).sum() - 3.0) - scene.mu * logJ
                           + 0.5 * scene.lam * logJ * logJ)

    H = torch.func.vmap(torch.func.hessian(psi))(
        x[scene.tets].reshape(-1, 12), scene.rest_inv, scene.vol)
    out = torch.empty_like(H)
    # batched eigensolvers take bounded batches
    for i in range(0, H.shape[0], 8192):
        w, Q = torch.linalg.eigh(H[i:i + 8192])
        out[i:i + 8192] = (Q * torch.clamp(w, min=0.0)[:, None, :]) @ Q.transpose(1, 2)
    return out


def _normal_blocks(w, q, d2, coef, dhat2):
    """Rank-one barrier blocks (N,3k,3k): coef * max(4 b'' d^2 + 2 b', 0)
    along the pair's normal, spread by the closest-point weights w (N,k)."""
    ds = torch.clamp(d2, min=1e-300)
    t = ds - dhat2
    lg = torch.log(ds / dhat2)
    bp = -2.0 * t * lg - t * t / ds
    bpp = -2.0 * lg - 4.0 * t / ds + t * t / (ds * ds)
    active = (d2 > 0) & (d2 < dhat2)
    s = torch.where(active, torch.clamp(4.0 * bpp * d2 + 2.0 * bp, min=0.0), torch.zeros_like(d2))
    n = q / torch.sqrt(ds)[:, None]
    nn = n[:, :, None] * n[:, None, :]
    k = w.shape[1]
    B = (coef * s)[:, None, None, None, None] * w[:, :, None, None, None] \
        * w[:, None, :, None, None] * nn[:, None, None]
    return B.permute(0, 1, 3, 2, 4).reshape(-1, 3 * k, 3 * k)


def _friction_blocks(lag, x, x_n, kappa, eps):
    """PSD blocks of the lagged friction at x: a P + c u u^T on the
    relative displacement (stick and slip branches), spread by weights."""
    out = []
    for ids, w, P, lam in lag:
        if ids.shape[0] == 0:
            continue
        rel = torch.einsum("nk,nkj->nj", w, x[ids] - x_n[ids])
        u = torch.einsum("nij,nj->ni", P, rel)
        u2 = (u * u).sum(-1)
        un = torch.sqrt(u2)
        slip = u2 > eps * eps
        a = torch.where(slip, 1.0 / torch.clamp(un, min=1e-300), (2.0 * eps - un) / (eps * eps))
        f2 = torch.where(slip, torch.zeros_like(un), 2.0 * (eps - un) / (eps * eps))
        c = torch.where(u2 > 1e-300, (f2 - a) / torch.clamp(u2, min=1e-300), torch.zeros_like(u2))
        Hr = (kappa * lam)[:, None, None] * (a[:, None, None] * P
                                             + c[:, None, None] * u[:, :, None] * u[:, None, :])
        k = w.shape[1]
        B = w[:, :, None, None, None] * w[:, None, :, None, None] * Hr[:, None, None]
        out.append((ids, B.permute(0, 1, 3, 2, 4).reshape(-1, 3 * k, 3 * k)))
    return out


class _Newton:
    """The reference's projected Newton system at x, and the step it takes:
    mass + elasticity + barrier + friction blocks, block-Jacobi PCG."""

    def __init__(self, scene, fams, free):
        self.scene, self.fams, self.free = scene, fams, free
        V = scene.mass.shape[0]
        D = torch.zeros((V, 3, 3), dtype=scene.mass.dtype, device=scene.mass.device)
        D = D + scene.mass[:, None, None] * torch.eye(3, dtype=D.dtype, device=D.device)
        for ids, B in fams:
            k = ids.shape[1]
            for i in range(k):
                D.index_add_(0, ids[:, i], B[:, 3 * i:3 * i + 3, 3 * i:3 * i + 3])
        self.Dinv = torch.linalg.inv(D)

    def apply(self, v):
        out = self.scene.mass[:, None] * v
        for ids, B in self.fams:
            k = ids.shape[1]
            y = torch.einsum("nij,nj->ni", B, v[ids].reshape(-1, 3 * k)).reshape(-1, 3)
            out = out.index_add(0, ids.reshape(-1), y)
        return out * self.free[:, None]

    def solve(self, g, tol=1e-8, maxiter=3000):
        b = -g * self.free[:, None]
        x = torch.zeros_like(b)
        r = b.clone()
        z = torch.einsum("vij,vj->vi", self.Dinv, r) * self.free[:, None]
        p = z.clone()
        rz = (r * z).sum()
        b_norm = float(b.norm())
        for _ in range(maxiter):
            if float(r.norm()) <= tol * b_norm:
                break
            Ap = self.apply(p)
            pAp = (p * Ap).sum()
            if not float(pAp) > 0.0:
                return torch.full_like(x, math.inf)
            alpha = rz / pAp
            x = x + alpha * p
            r = r - alpha * Ap
            z = torch.einsum("vij,vj->vi", self.Dinv, r) * self.free[:, None]
            rz_new = (r * z).sum()
            p = z + (rz_new / rz) * p
            rz = rz_new
        return x


def step_numbers(scene, x_n, v_n, x_next):
    """The numbers of one step from (x_n, v_n) to the program's x_next
    (all (V,3) float64 on the scene's device): a dict of floats. `newton`
    is the reference's Newton step at x_next in units of the method's own
    stopping bound, sqrt(rel_gl2_tol) bboxDiag h."""
    h = scene.dt
    x = x_next.detach().clone().requires_grad_(True)
    free = (~scene.dbc).to(x.dtype)
    x_tilde = x_n + h * v_n + h * h * scene.gravity
    g_I = scene.mass[:, None] * (x.detach() - x_tilde)
    psi, J = _psi_nh(scene, x)
    (g_E,) = torch.autograd.grad(h * h * psi, x)
    dhat = math.sqrt(scene.dhat2)
    xd = x.detach()
    pairs = _Pairs(scene, xd, dhat)
    wp, we = pairs.weights(xd, pairs.pt, pairs.ee)
    lag = _friction_lag(scene, x_n, x_next.detach())
    (g_C,) = torch.autograd.grad(_contact_energy(scene, x, pairs, wp, we, lag, x_n), x)
    fams = [(scene.tets, _tet_blocks(scene, xd))]
    bar = []
    g = scene.ground
    if g is not None:
        sv = scene.surf
        s = xd[sv] @ g["normal"] + g["offset"]
        on = (s * s < scene.dhat2) & (s * s > 1e-12 * scene.dhat2)
        bar.append((sv[on][:, None], torch.ones((int(on.sum()), 1), dtype=xd.dtype,
                                                device=xd.device),
                    (s[on][:, None] * g["normal"][None, :]), (s[on] ** 2),
                    torch.ones_like(s[on])))
    for ids, w, is_ee in ((pairs.pt, wp, False), (pairs.ee, we, True)):
        if ids.shape[0] == 0:
            continue
        d2, q = _dist2(xd, ids, w)
        # a pair all but touching is min_gap's to report; its stiffness
        # would overflow the system
        on = (d2 > 1e-12 * scene.dhat2) & (d2 < scene.dhat2)
        coef = (_mollifier(_cross2(xd, ids), _eps_x(scene, ids)) if is_ee
                else torch.ones_like(d2))
        bar.append((ids[on], w[on], q[on], d2[on], coef[on]))
    eps = math.sqrt(scene.eps2)
    k0 = _kappa_suggest(scene)
    best = None
    # kappa is the method's own choice (kappa_suggest, raised to balance the
    # forces at the step's start, doubled on approach, capped at 100x):
    # the step passes with the kappa under which it is most nearly converged
    for kappa in [k0 * 2.0 ** i for i in range(8)]:
        grad = g_I + g_E + kappa * g_C
        fk = list(fams)
        for ids, w, q, d2, coef in bar:
            fk.append((ids, _normal_blocks(w, q, d2, kappa * coef, scene.dhat2)))
        fk += _friction_blocks(lag, xd, x_n, kappa, eps)
        p = _Newton(scene, fk, free).solve(grad)
        newton = float(p.abs().max()) / (math.sqrt(scene.rel_gl2_tol) * scene.bbox_diag * h)
        if not math.isfinite(newton):
            newton = math.inf
        if best is None or newton < best[0]:
            best = (newton, kappa)
        if newton <= 1.0:
            break

    with torch.no_grad():
        gaps = [torch.tensor([1.0], dtype=xd.dtype, device=xd.device)]
        if scene.ground is not None:
            gnd = scene.ground
            gaps.append((xd[scene.surf] @ gnd["normal"] + gnd["offset"]) / dhat)
        for ids, w in ((pairs.pt, wp), (pairs.ee, we)):
            if ids.shape[0]:
                gaps.append(torch.sqrt(_dist2(xd, ids, w)[0]) / dhat)
        min_gap = float(torch.cat(gaps).min())
        crossings = 0
        if scene.self_contact:
            ia, ib = C.near_pairs(xd, scene.edges, scene.tris, 0.0)
            e, t = scene.edges[ia], scene.tris[ib]
            ok = ~(e[:, :, None] == t[:, None, :]).any(dim=2).any(dim=1)
            e, t = e[ok], t[ok]
            crossings = int(C.segment_crosses_triangle(
                xd[e[:, 0]], xd[e[:, 1]], xd[t[:, 0]], xd[t[:, 1]], xd[t[:, 2]]).sum())
        handle_err = 0.0
        if scene.handles:
            miss, move = [], []
            for ids, R, c0 in scene.handles:
                target = (x_n[ids] - c0) @ R.T + c0
                miss.append((xd[ids] - target).norm(dim=1).max())
                move.append((target - x_n[ids]).norm(dim=1).max())
            handle_err = float(torch.stack(miss).max() / torch.stack(move).max())
    return dict(newton=best[0], handle_err=handle_err, min_det=float(J.detach().min()),
                min_gap=min_gap, crossings=crossings, kappa=best[1])


def judge_chain(scene, x0, v0, xs, first=0):
    """Numbers of the chain x0 -> xs[0] -> xs[1] ... (positions (V,3) of
    any float dtype, on any device; cast to the scene's float64 device).
    v0 is the velocity at x0. Returns (worst per number, per-step rows)."""
    dev = scene.x_rest.device

    def f64(a):
        return torch.as_tensor(a).to(device=dev, dtype=torch.float64)

    x_n, v_n = f64(x0), f64(v0)
    worst, rows = {}, []
    for i, xn1 in enumerate(xs):
        x_next = f64(xn1)
        nums = step_numbers(scene, x_n, v_n, x_next)
        nums["step"] = first + i
        rows.append(nums)
        for k, pick in WORST.items():
            worst[k] = nums[k] if k not in worst else pick(worst[k], nums[k])
        v_n = (x_next - x_n) / scene.dt
        x_n = x_next
    return worst, rows
