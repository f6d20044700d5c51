"""The active pairs' kernel (csrc/pair_terms.cu via contact/pair_terms.py) on
the card beside its plain version, on the active sets of the benchmark's
scenes.

    python -m ipc_tpu_torch.pair_timing [twist100 boxes twist225]

Builds each scene on the card in float32 with the device step
(jit_step.make_step): the mat twist at n = 100 (60,000 tets) and n = 225
(303,750 tets, whose steps run the moving-DBC AL) from rest, the two-box
landing (n_cells = 20, 96,000 tets) after steps 0-7. Its recorded steps
(`scene_sets`, the cells' episodes) run with tracing on and the active set
of every call of the three entry points recorded: the blocks once a Newton
iteration and once a coarse assembly, the gradient once a Newton iteration
(and at kappa's start), the energy in every line-search trial. Prints per
scene one JSON object with the recorded calls' PT / EE counts by entry and
the steps' `pairs.*` counters, then per (family, dtype: the scene's float32
and the same stencils in float64) of the largest blocks call (the largest
call of any entry where every blocks call is empty):

  n                    stencils
  code_equal           the share of stencils whose dType code is the plain
                       version's on the card
  energy_err, grad_err, blocks_err
                       the largest per-stencil |kernel - plain| / |plain|
                       (energies; gradient rows; projected 12x12 blocks)
  f32_err, f32_kept, f32_ok (float32 only)
                       the float32 rule (`f32_rule`): per output, the
                       kernel's and the float32 plain version's per-stencil
                       distance from the float64 plain version at the
                       median, 99th percentile and largest, over the
                       f32_kept stencils; f32_ok where the kernel's is at
                       most twice the plain version's plus float32's eps
  sweeps_mean, sweeps_max
                       the Jacobi sweeps of the projected blocks
  energy_ms, grad_ms, blocks_ms
                       median device ms of one kernel launch
                       (hv_timing.device_ms: queued behind a device sleep,
                       L2 flushed before each)
  bytes, bytes_us      what a blocks launch must move (vids, the four rows
                       of x, eps, the (N,12,12) blocks written) at 3.35 TB/s
  flops, flops_us      what projecting the nonzero blocks needs, whatever
                       the algorithm: one symmetric eigendecomposition with
                       eigenvectors (9 K^3, Golub and Van Loan's count) and
                       the rebuild Q max(w, 0) Q^T (K^2 (K + 1)), K the
                       reduced block's size, at 67 / 34 TFLOP/s (f32 / f64,
                       the card's vector peak)

and per (scene, dtype) the whole `hessian_blocks_from_active` call's wall ms
(median of 5, synchronized), through the kernel and through the plain
version (vmap(hessian) and make_psd, the latter in chunks of 16,384: eigh
on the card refuses 32,768 matrices). Last, per scene, `gradient_check`
over every recorded gradient call with pairs: the kernel's gradient
against its energy along the step the line search then tried. The
comparison and timing calls count in no counter
(utils/observability.Capture).
"""

import json
import sys
import time

import torch

from ipc_tpu_torch.hv_timing import FLUSH_BYTES, HBM_BYTES_PER_S, device_ms

__all__ = ["SCENES", "scene_sets", "largest", "plain_terms", "kernel_terms", "f32_rule",
           "compare", "measure", "call_ms", "line_search_steps", "gradient_check"]

# (builder, size, steps before the recorded ones, steps recorded): the cells'
# episodes (portbench/traffic: turn, impact, al)
SCENES = {"twist100": ("build_twist_scene", 100, 0, 4), "boxes": ("build_scene", 20, 8, 2),
          "twist225": ("build_twist_scene", 225, 0, 2)}
FLOPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}
PLAIN_CHUNK = 16384
QUANTILES = (0.5, 0.99, 1.0)


def scene_sets(name, device, size=None):
    """(calls, counters, dHat): every call of the active pairs' three entry
    points (SelfContact.energy_active, gradient_active,
    hessian_blocks_from_active) in the recorded steps of scene `name`
    (SCENES; `size` in place of its size) on `device`, as (entry, x,
    ActiveSet) in call order; those steps' `pairs.*` counters under
    tracing; and the scene's dHat."""
    import dataclasses

    from ipc_tpu_torch import jit_step, scenes
    from ipc_tpu_torch.contact.pipeline import ActiveSet
    from ipc_tpu_torch.utils import observability as obs

    builder, default, before, steps = SCENES[name]
    kw = {"with_contact": True} if name == "boxes" else {}
    st = getattr(scenes, builder)(size or default, "float32", device, **kw)
    step = jit_step.make_step(st)
    state = st.initial_state()
    aux = jit_step.initial_device_aux(st)
    if aux is not None:
        state = dataclasses.replace(state, aux=aux)
    for _ in range(before):
        state, _ = step(state)
    sc, calls = st.sc, []
    entries = ("energy_active", "gradient_active", "hessian_blocks_from_active")

    def recorder(entry):
        fn = getattr(sc, entry)

        def record(x, act, *args, **kw):
            calls.append((entry, x.detach().clone(),
                          ActiveSet(vids_p=act.vids_p, vids_e=act.vids_e, eps_e=act.eps_e,
                                    cnt_pt=act.cnt_pt, cnt_ee=act.cnt_ee)))
            return fn(x, act, *args, **kw)

        return record

    for entry in entries:
        setattr(sc, entry, recorder(entry))
    obs.set_tracing(True)
    try:
        for _ in range(steps):
            state, _ = step(state)
    finally:
        obs.set_tracing(False)
        for entry in entries:
            delattr(sc, entry)
    counters = {k: v for k, v in obs.collect()["counters"].items() if k.startswith("pairs.")}
    return calls, counters, float(st.dHat)


def largest(calls, entry=None):
    """(x, ActiveSet) of the recorded call with the most stencils, among the
    calls of `entry` when they have any."""
    mine = [c for c in calls if c[0] == entry and c[2].cnt_pt + c[2].cnt_ee]
    _, x, act = max(mine or calls, key=lambda c: c[2].cnt_pt + c[2].cnt_ee)
    return x, act


def plain_terms(kind, x, vids, eps, dHat, project=True):
    """(energy (N,), gradient (N,4,3), blocks (N,12,12), code (N,)) of the
    plain version on x's device: the eager functions of
    contact/selfcollision.py and ops/spd.make_psd (in chunks of PLAIN_CHUNK)."""
    from ipc_tpu_torch.contact import selfcollision as SC
    from ipc_tpu_torch.ops import distance as D
    from ipc_tpu_torch.ops.spd import make_psd

    tab = SC.SlotTables(x.device, x.dtype)
    x4 = x[vids]
    rows = SC._rows(x4 - SC._centroid(x4))
    if kind == "pt":
        e, g = SC.pt_pair_energy(x4, dHat, tab), SC.pt_pair_grad(x4, dHat, tab)
        H, code = SC.pt_pair_hess(x4, dHat, tab), D.dtype_PT(*rows)
    else:
        e, g = SC.ee_pair_energy(x4, eps, dHat, tab), SC.ee_pair_grad(x4, eps, dHat, tab)
        H, code = SC.ee_pair_hess(x4, eps, dHat, tab), D.dtype_EE(*rows)
    if project and H.shape[0]:
        H = torch.cat([make_psd(h) for h in H.split(PLAIN_CHUNK)])
    return e, g, H, code


def kernel_terms(kind, x, vids, eps, dHat, project=True):
    """(energy, gradient, blocks, code, sweeps) of the kernel, kappa 1."""
    from ipc_tpu_torch.contact.pair_terms import launch

    n = int(vids.shape[0])
    code = torch.empty((n,), dtype=torch.int32, device=x.device)
    sweeps = torch.empty((n,), dtype=torch.int32, device=x.device)
    e = launch(kind, "energy", x, vids, eps, dHat)
    g = launch(kind, "grad", x, vids, eps, dHat)
    H = launch(kind, "blocks", x, vids, eps, dHat, project=project, code=code, sweeps=sweeps)
    return e, g, H, code, sweeps


def _rel(a, b):
    """Per-stencil |a - b| / |b| (0 where both are 0)."""
    n = a.shape[0]
    a = a.reshape(n, -1).double()
    b = b.reshape(n, -1).double()
    num = (a - b).norm(dim=1)
    den = b.norm(dim=1)
    return torch.where(num == 0, torch.zeros_like(num), num / den)


def f32_rule(kind, x, vids, eps, dHat, kern, plain):
    """The float32 rule, for float32 stencils whose kernel terms `kern` and
    plain terms `plain` (energy, gradient, blocks, code, ...) are given:
    against the float64 plain version on the same stencils, over those
    whose float32 dType code and activity are float64's and which are
    active (the plain version's own float32 rounding moves the others
    across a boundary), the per-stencil |float32 - float64| / |float64| of
    the kernel and of the float32 plain version at QUANTILES. The kernel
    passes where its distance is at most twice the plain version's plus
    float32's eps at each, for energies, gradients and blocks alike.
    Returns (errs, kept, ok): errs [(kernel's, plain's)] per output, None
    where no stencil is kept (every pair beyond dHat)."""
    ref = plain_terms(kind, x.double(), vids, None if eps is None else eps.double(), dHat)
    keep = ((plain[3] == ref[3]) & ((plain[0] != 0) == (ref[0] != 0)) & (ref[0] != 0)).cpu()
    kept = int(keep.sum())
    if not kept:
        return None, 0, True
    q = torch.tensor(QUANTILES, dtype=torch.float64)
    errs, ok = [], True
    for got, pl, r in zip(kern[:3], plain[:3], ref[:3]):
        ek = torch.quantile(_rel(got, r).cpu()[keep], q)
        ep = torch.quantile(_rel(pl, r).cpu()[keep], q)
        errs.append((ek.tolist(), ep.tolist()))
        ok = ok and bool((ek <= 2 * ep + torch.finfo(torch.float32).eps).all())
    return errs, kept, ok


def compare(kind, x, vids, eps, dHat):
    """Kernel vs plain version on the same stencils: dict(n, code_equal,
    energy_err, grad_err, blocks_err, sweeps_mean, sweeps_max) and, for
    float32, f32_err, f32_kept and f32_ok (`f32_rule`)."""
    k = kernel_terms(kind, x, vids, eps, dHat)
    p = plain_terms(kind, x, vids, eps, dHat)
    n = int(vids.shape[0])
    if not n:
        return dict(n=0, code_equal=1.0, energy_err=0.0, grad_err=0.0, blocks_err=0.0,
                    sweeps_mean=0.0, sweeps_max=0)
    rec = dict(n=n, code_equal=int((k[3].long() == p[3]).sum()) / n,
               energy_err=float(_rel(k[0], p[0]).max()), grad_err=float(_rel(k[1], p[1]).max()),
               blocks_err=float(_rel(k[2], p[2]).max()),
               sweeps_mean=float(k[4].double().mean()), sweeps_max=int(k[4].max()))
    if x.dtype == torch.float32:
        rec["f32_err"], rec["f32_kept"], rec["f32_ok"] = f32_rule(kind, x, vids, eps, dHat, k, p)
    return rec


def _flops(kind, x, vids, eps, code, H):
    """The flops of projecting the nonzero blocks H (module docstring)."""
    from ipc_tpu_torch.contact import selfcollision as SC
    from ipc_tpu_torch.ops.distance import ee_cross_sq_norm

    npts = torch.as_tensor([2, 2, 2, 3, 3, 3, 4] if kind == "pt" else
                           [2, 2, 3, 2, 2, 3, 3, 3, 4], device=x.device)[code.long()]
    if kind == "ee":
        moll = ee_cross_sq_norm(*SC._rows(x[vids])) < eps
        npts = torch.where(moll, torch.full_like(npts, 4), npts)
    K = 3 * npts.double()
    f = 9 * K**3 + K * K * (K + 1)
    live = (H.reshape(H.shape[0], -1) != 0).any(dim=1)
    return float(torch.where(live, f, torch.zeros_like(f)).sum())


def measure(kind, x, vids, eps, dHat):
    """One record (module docstring) of one family's stencils."""
    from ipc_tpu_torch.contact.pair_terms import launch
    from ipc_tpu_torch.utils.observability import Capture

    flush_buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=x.device)

    def flush():
        flush_buf.sum()

    with Capture():  # comparison and timing calls are not main-path launches
        rec = compare(kind, x, vids, eps, dHat)
        for what in ("energy", "grad", "blocks"):
            rec[f"{what}_ms"] = device_ms(lambda: launch(kind, what, x, vids, eps, dHat), flush)
        _, _, H, code, _ = kernel_terms(kind, x, vids, eps, dHat)
    n, size = rec["n"], x.element_size()
    rec["bytes"] = n * (32 + 12 * size + (size if kind == "ee" else 0) + 144 * size)
    rec["bytes_us"] = 1e6 * rec["bytes"] / HBM_BYTES_PER_S
    rec["flops"] = _flops(kind, x, vids, eps, code, H)
    rec["flops_us"] = 1e6 * rec["flops"] / FLOPS_PER_S[x.dtype]
    return rec


def _wall_ms(fn, reps=5):
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return sorted(out)[len(out) // 2]


def call_ms(x, act, dHat, kappa=1.0):
    """(kernel_ms, plain_ms): the wall time of one whole blocks call of the
    active set `act` through the kernel (contact/pair_terms.blocks) and
    through the plain version, median of 5."""
    from ipc_tpu_torch.contact import pair_terms as PAIRS
    from ipc_tpu_torch.contact import selfcollision as SC
    from ipc_tpu_torch.utils.observability import Capture

    tab = SC.SlotTables(x.device, x.dtype)

    def plain():
        H = [plain_terms("pt", x, act.vids_p, None, dHat)[2],
             plain_terms("ee", x, act.vids_e, act.eps_e, dHat)[2]]
        return kappa * torch.cat(H)

    with Capture():
        PAIRS.blocks(x, act, kappa, dHat, tab)  # the library's first load outside the window
        return _wall_ms(lambda: PAIRS.blocks(x, act, kappa, dHat, tab)), _wall_ms(plain)


def line_search_steps(calls):
    """[(x, act, x_next)]: each recorded gradient call with pairs, its x and
    active set, and the x of the first energy call after it at another x
    (the line search's first trial)."""
    out = []
    for i, (entry, x, act) in enumerate(calls):
        if entry != "gradient_active" or not act.cnt_pt + act.cnt_ee:
            continue
        nxt = next((c[1] for c in calls[i + 1:] if c[0] == "energy_active"
                    and not torch.equal(c[1], x)), None)
        if nxt is not None:
            out.append((x, act, nxt))
    return out


FD_STEPS = (1e-1, 1e-2, 1e-3, 1e-4, 1e-5, 1e-6)


def gradient_check(x, act, x_next, dHat):
    """The kernel's gradient against its energy along p = x_next - x, the
    active set `act` held fixed (float32 x, the main path's dtype). With
    D the directional derivative sum over stencils of g_i . p_i and the
    scale S = sum ||g_i|| ||p_i|| of the float64 plain gradients g_i:

      fd_err      min over FD_STEPS h of |(E(x + h p) - E(x - h p)) / 2h
                  - D| / S, E and D the kernel's in float64: the gradient
                  is the derivative of the energy
      k32_err     |D of the float32 kernel - D of the float64 plain| / S
      p32_err     the same of the float32 plain version
      p32_budget  sum ||g32_i - g_i|| ||p_i|| / S of the float32 plain
                  version: its rounding with no cancellation

    ok where fd_err <= 1e-6 and k32_err <= 2 p32_budget + float32's eps: a
    bias of the kernel's float32 gradient along the step would add up over
    the stencils where rounding cancels."""
    from ipc_tpu_torch.contact import selfcollision as SC
    from ipc_tpu_torch.contact.pair_terms import launch
    from ipc_tpu_torch.utils.observability import Capture

    p = x_next.double() - x.double()
    fams = [(kind, vids, eps) for kind, vids, eps in (("pt", act.vids_p, None),
                                                      ("ee", act.vids_e, act.eps_e))
            if vids.shape[0]]

    def plain_grad(kind, xd, vids, eps):
        tab = SC.SlotTables(xd.device, xd.dtype)
        return (SC.pt_pair_grad(xd[vids], dHat, tab) if kind == "pt"
                else SC.ee_pair_grad(xd[vids], eps, dHat, tab))

    def rows(fn, dtype):
        return [fn(kind, x.to(dtype), vids, None if eps is None else eps.to(dtype)).double()
                for kind, vids, eps in fams]

    def along(g):
        return float(sum((gi * p[vids]).sum() for gi, (_, vids, _) in zip(g, fams)))

    def energy(xd):
        return float(sum(launch(kind, "energy", xd, vids, eps.double() if eps is not None
                                else None, dHat).sum() for kind, vids, eps in fams))

    def kernel_grad(kind, xd, vids, eps):
        return launch(kind, "grad", xd, vids, eps, dHat)

    with Capture():  # not main-path launches
        g64, g32p = rows(plain_grad, torch.float64), rows(plain_grad, torch.float32)
        g64k, g32k = rows(kernel_grad, torch.float64), rows(kernel_grad, torch.float32)
        x64 = x.double()
        d64k = along(g64k)
        fd = min(abs((energy(x64 + h * p) - energy(x64 - h * p)) / (2 * h) - d64k)
                 for h in FD_STEPS)
    pn = [p[vids].reshape(vids.shape[0], -1).norm(dim=1) for _, vids, _ in fams]
    scale = float(sum((g.reshape(g.shape[0], -1).norm(dim=1) * q).sum()
                      for g, q in zip(g64, pn)))
    budget = float(sum(((a - b).reshape(a.shape[0], -1).norm(dim=1) * q).sum()
                       for a, b, q in zip(g32p, g64, pn)))
    d64, S = along(g64), scale or 1.0
    rec = dict(n_pt=act.cnt_pt, n_ee=act.cnt_ee, scale=scale, fd_err=fd / S,
               k32_err=abs(along(g32k) - d64) / S, p32_err=abs(along(g32p) - d64) / S,
               p32_budget=budget / S)
    rec["ok"] = rec["fd_err"] <= 1e-6 and rec["k32_err"] <= (
        2 * rec["p32_budget"] + torch.finfo(torch.float32).eps)
    return rec


def main(argv=None):
    from ipc_tpu_torch.contact.pipeline import ActiveSet
    from ipc_tpu_torch.device import require_cuda

    names = (argv if argv is not None else sys.argv[1:]) or list(SCENES)
    device = require_cuda()
    print(f"[pair_timing] {torch.cuda.get_device_name(0)}", flush=True)
    for name in names:
        calls, counters, dHat = scene_sets(name, device)
        counts = {e: [(a.cnt_pt, a.cnt_ee) for c, _, a in calls if c == e]
                  for e in ("hessian_blocks_from_active", "gradient_active", "energy_active")}
        print(json.dumps(dict(scene=name, counts=counts, **counters)), flush=True)
        x, act = largest(calls, "hessian_blocks_from_active")
        for dtype in (torch.float32, torch.float64):
            xd, epsd = x.to(dtype), act.eps_e.to(dtype)
            for kind, vids, eps in (("pt", act.vids_p, None), ("ee", act.vids_e, epsd)):
                rec = measure(kind, xd, vids, eps, dHat)
                print(json.dumps(dict(scene=name, family=kind,
                                      dtype=str(dtype).replace("torch.", ""), **rec)),
                      flush=True)
            actd = ActiveSet(vids_p=act.vids_p, vids_e=act.vids_e, eps_e=epsd,
                             cnt_pt=act.cnt_pt, cnt_ee=act.cnt_ee)
            k_ms, p_ms = call_ms(xd, actd, dHat)
            print(json.dumps(dict(scene=name, dtype=str(dtype).replace("torch.", ""),
                                  call="hessian_blocks_from_active", kernel_ms=k_ms,
                                  plain_ms=p_ms)), flush=True)
        for x, act, x_next in line_search_steps(calls):
            print(json.dumps(dict(scene=name, check="gradient",
                                  **gradient_check(x, act, x_next, dHat))), flush=True)
        del calls


if __name__ == "__main__":
    main()
