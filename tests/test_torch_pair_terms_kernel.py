"""The active pairs' barrier kernel (csrc/pair_terms.cu) and its router
(contact/pair_terms.py).

On the CPU: the router runs the plain version, bit for bit what
SelfContact computed before it (the eager per-pair functions of
contact/selfcollision.py, their vmap(grad / hessian), ops/spd.make_psd and
the kappa products), over the hand-made cases of tests/pair_cases.py and a
seeded fuzz, float32 and float64, and launches nothing: `pairs.calls` counts
each family call with stencils, `pairs.kernel_calls` stays 0. The host
path's energy over a whole candidate set (SelfContact.candidate_set, mostly
pairs beyond dHat) is the eager sum, bit for bit. Every tensor off the
CPU goes to `launch`, the card's route, which refuses all but CUDA float32
and float64 (CPU and meta tensors, float16 and bfloat16 among them).

On the card (marker `cuda`; they skip here), float32 and float64, the kernel
against the plain version on the same card (pair_timing.compare): every
stencil's dType code equal; the energies, gradient rows and projected
blocks within 1e-10 of each stencil's norm in float64; in float32 the
kernel's distance from the float64 plain version, at its median, 99th
percentile and largest over the stencils, at most twice the float32 plain
version's plus float32's eps, the rounding of storing the result (the plain
version's own rounding sets the tolerance; stencils whose float32 type or
activity differs from float64's are left out of the comparison, in both;
pair_timing.f32_rule);
exact zeros at and beyond dHat and in the slots a
reduced type leaves unused; every projected block's least eigenvalue at
least -8 eps ||H||. Over the hand-made cases, a 10^5-stencil fuzz per
family, the largest active set that the energy, gradient or blocks got in
the steps of the twist (n = 100, steps 0-3; its blocks' sets are empty) and
of the landing (n_cells = 20, steps 8-9), and one 40,000-pair call
(the eager eigh refuses 32,768 12x12 matrices on the card). Over those steps
`pairs.kernel_calls == pairs.calls`, and with the eager functions and
make_psd made to raise the steps still run: a CUDA tensor never reaches
them. Along each line search's first trial step in the landing's steps the
kernel's gradient is its energy's derivative, and its float32 directional
derivative carries no bias beyond the float32 plain version's rounding
(pair_timing.gradient_check).

The module imports no JAX, so the card runs it where only PyTorch is
installed: python -m pytest --noconftest -m cuda tests/test_torch_pair_terms_kernel.py
"""

import numpy as np
import pytest
import torch

from ipc_tpu_torch.contact import pair_terms as PAIRS
from ipc_tpu_torch.contact import selfcollision as SC
from ipc_tpu_torch.contact.pipeline import ActiveSet
from ipc_tpu_torch.ops.spd import make_psd
from ipc_tpu_torch.utils import observability as obs
from pair_cases import DHAT, ee_cases, fuzz, pt_cases

DTYPES = [torch.float64, torch.float32]
BITS = {torch.float64: torch.int64, torch.float32: torch.int32}
FUZZ_N = 100_000
FUZZ_SEED = 20261018
KAPPA = 3.5


def _active(Xp, Xe, eps, dtype, device="cpu"):
    """(x (V,3), ActiveSet) holding stencils Xp (PT) and Xe (EE) (numpy)
    as disjoint vertex rows."""
    X = np.concatenate([Xp.reshape(-1, 3), Xe.reshape(-1, 3)])
    x = torch.as_tensor(X, device=device).to(dtype)
    n_pt, n_ee = Xp.shape[0], Xe.shape[0]
    ids = torch.arange(4 * (n_pt + n_ee), device=device).reshape(-1, 4)
    return x, ActiveSet(vids_p=ids[:n_pt], vids_e=ids[n_pt:],
                        eps_e=torch.as_tensor(eps, device=device).to(dtype),
                        cnt_pt=n_pt, cnt_ee=n_ee)


def _cases(dtype, device="cpu"):
    Xp = np.stack([c[1] for c in pt_cases()])
    ee = ee_cases()
    return _active(Xp, np.stack([c[1] for c in ee]), np.array([c[3] for c in ee]), dtype,
                   device)


def _fuzz(dtype, n, device="cpu"):
    Xp, _ = fuzz("pt", n, FUZZ_SEED)
    Xe, eps = fuzz("ee", n, FUZZ_SEED + 1)
    return _active(Xp, Xe, eps, dtype, device)


def _parent_terms(x, act, kappa, dHat, project):
    """What SelfContact's three calls computed before the router (verbatim)."""
    tab = SC.SlotTables(x.device, x.dtype)
    e_pt = SC.pt_pair_energy(x[act.vids_p], dHat, tab)
    e_ee = SC.ee_pair_energy(x[act.vids_e], act.eps_e, dHat, tab)
    g_pt = SC.pt_pair_grad(x[act.vids_p], dHat, tab)
    g_ee = SC.ee_pair_grad(x[act.vids_e], act.eps_e, dHat, tab)
    rows = torch.cat([kappa * g_pt.reshape(-1, 3), kappa * g_ee.reshape(-1, 3)])
    H = torch.cat([SC.pt_pair_hess(x[act.vids_p], dHat, tab),
                   SC.ee_pair_hess(x[act.vids_e], act.eps_e, dHat, tab)])
    if project and H.shape[0]:
        H = make_psd(H)
    return e_pt, e_ee, rows, kappa * H


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(BITS[a.dtype]), b.contiguous().view(BITS[b.dtype]))


def test_the_cases_have_their_codes():
    """Each hand-made case is the closest-point type it is named for."""
    from ipc_tpu_torch.ops import distance as D

    x, act = _cases(torch.float64)
    for vids, cases, classify in ((act.vids_p, pt_cases(), D.dtype_PT),
                                  (act.vids_e, ee_cases(), D.dtype_EE)):
        x4 = x[vids]
        code = classify(*SC._rows(x4 - SC._centroid(x4)))
        for (name, _, want, *_), got in zip(cases, code.tolist()):
            assert want is None or got == want, (name, got)


@pytest.mark.parametrize("data", ["cases", "fuzz"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("project", [True, False])
def test_cpu_runs_the_plain_version_bit_for_bit(data, dtype, project):
    x, act = _cases(dtype) if data == "cases" else _fuzz(dtype, 2000)
    tab = SC.SlotTables(x.device, x.dtype)
    kappa = torch.tensor(KAPPA, dtype=dtype)
    launches, calls = obs.counter("pairs.kernel_calls"), obs.counter("pairs.calls")
    e_pt, e_ee = PAIRS.energies(x, act, DHAT, tab)
    rows = PAIRS.gradient_rows(x, act, kappa, DHAT, tab)
    H = PAIRS.blocks(x, act, kappa, DHAT, tab, project)
    want = _parent_terms(x, act, kappa, DHAT, project)
    for got, ref in zip((e_pt, e_ee, rows, H), want):
        assert _same_bits(got, ref)
    assert obs.counter("pairs.kernel_calls") == launches
    assert obs.counter("pairs.calls") - calls == 6  # 3 calls x 2 families with stencils
    assert bool((e_pt != 0).any() and (e_ee != 0).any() and (e_pt == 0).any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_empty_sets(dtype):
    x, act = _cases(dtype)
    empty = ActiveSet(vids_p=act.vids_p[:0], vids_e=act.vids_e[:0], eps_e=act.eps_e[:0],
                      cnt_pt=0, cnt_ee=0)
    tab = SC.SlotTables(x.device, x.dtype)
    calls = obs.counter("pairs.calls")
    e_pt, e_ee = PAIRS.energies(x, empty, DHAT, tab)
    assert e_pt.shape == (0,) and e_ee.shape == (0,)
    assert PAIRS.gradient_rows(x, empty, 2.0, DHAT, tab).shape == (0, 3)
    assert PAIRS.blocks(x, empty, 2.0, DHAT, tab).shape == (0, 12, 12)
    assert obs.counter("pairs.calls") == calls


@pytest.mark.parametrize("dtype", DTYPES)
def test_host_path_energy_over_a_candidate_set(dtype):
    """The host path's energy over every candidate of a broad phase, most of
    them beyond dHat, is the eager sum bit for bit (plain and compensated)."""
    from ipc_tpu_torch import scenes
    from ipc_tpu_torch.ops.compensated import df_add, df_scale, df_sum

    st = scenes.build_scene(2, str(dtype).replace("torch.", ""), "cpu", with_contact=True)
    sc, xr = st.sc, st.mesh.x_rest
    # the upper box 0.002 above the lower one, inside sqrt(dHat) = 0.0026
    x = xr - (xr[:, 1:2] > 1.1).to(xr.dtype) * torch.tensor([0.0, 0.188, 0.0], dtype=xr.dtype)
    cand = sc.build_candidates(x, gap=4 * float(np.sqrt(st.dHat)))
    act = sc.candidate_set(cand)
    e_pt = SC.pt_pair_energy(x[act.vids_p], st.dHat, sc.tab)
    e_ee = SC.ee_pair_energy(x[act.vids_e], act.eps_e, st.dHat, sc.tab)
    assert act.cnt_pt > 0 and act.cnt_ee > 0 and bool((e_pt == 0).any())
    assert bool((e_pt != 0).any() or (e_ee != 0).any())
    assert _same_bits(sc.energy_active(x, act, KAPPA, st.dHat),
                      KAPPA * (e_pt.sum() + e_ee.sum()))
    hi, lo = sc.energy_active(x, act, KAPPA, st.dHat, df=True)
    want = df_scale(df_add(df_sum(e_pt), df_sum(e_ee)), KAPPA)
    assert _same_bits(hi, want[0]) and _same_bits(lo, want[1])


REFUSED = {
    "cpu float64": (torch.float64, "cpu", ValueError),
    "cpu float32": (torch.float32, "cpu", ValueError),
    "meta": (torch.float64, "meta", ValueError),
    "meta float16": (torch.float16, "meta", ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("what", ["energy", "grad", "blocks"])
def test_the_card_route_refuses_other_tensors(case, what):
    dtype, device, err = REFUSED[case]
    x, act = _cases(dtype)
    x = x.to(device)
    with pytest.raises(err):
        PAIRS.launch("ee", what, x, act.vids_e.to(device), act.eps_e.to(device), DHAT)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("entry", ["energies", "gradient_rows", "blocks"])
def test_the_router_sends_every_tensor_off_the_cpu_to_the_kernel(dtype, entry):
    """Only CPU tensors take the plain version: any other device goes to the
    kernel's route, which refuses what is not CUDA float32 / float64."""
    x, act = _cases(torch.float64)
    x = x.to("meta", dtype)
    act = ActiveSet(vids_p=act.vids_p.to("meta"), vids_e=act.vids_e.to("meta"),
                    eps_e=act.eps_e.to("meta", dtype), cnt_pt=act.cnt_pt, cnt_ee=act.cnt_ee)
    tab = SC.SlotTables(torch.device("cpu"), torch.float64)
    args = {"energies": (x, act, DHAT, tab), "gradient_rows": (x, act, KAPPA, DHAT, tab),
            "blocks": (x, act, KAPPA, DHAT, tab)}[entry]
    launches = obs.counter("pairs.kernel_calls")
    with pytest.raises(ValueError, match="CUDA float32/float64 only"):
        getattr(PAIRS, entry)(*args)
    assert obs.counter("pairs.kernel_calls") == launches


# --- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair-terms kernel runs only on the card")
    return torch.device("cuda")


def _fam(act, kind):
    return (act.vids_p, None) if kind == "pt" else (act.vids_e, act.eps_e)


def _min_eig_ratio(H):
    """The least eigenvalue of each block over its Frobenius norm (f64, CPU,
    in chunks: eigh on the card refuses 32,768 matrices)."""
    H = H.double().cpu()
    w = torch.cat([torch.linalg.eigvalsh(h) for h in H.split(8192)])[:, 0]
    nrm = H.reshape(H.shape[0], -1).norm(dim=1)
    return torch.where(nrm > 0, w / nrm, torch.zeros_like(w))


def _against_plain(x, act, label, dHat=DHAT):
    """The kernel against the plain version on the card (module docstring)."""
    from ipc_tpu_torch.pair_timing import _rel, f32_rule, kernel_terms, plain_terms

    eps_t = torch.finfo(x.dtype).eps
    for kind in ("pt", "ee"):
        vids, eps = _fam(act, kind)
        if not vids.shape[0]:
            continue
        k = kernel_terms(kind, x, vids, eps, dHat)
        p = plain_terms(kind, x, vids, eps, dHat)
        codes = int((k[3].long() == p[3]).sum()) / vids.shape[0]
        w = _min_eig_ratio(k[2])
        errs = []
        if x.dtype == torch.float64:
            for got, ref in zip(k[:3], p[:3]):
                errs.append(float(_rel(got, ref).max()))
            print(f"[pairs] {label} {kind} float64: n={vids.shape[0]} codes {codes:.6f} "
                  f"rel err energy/grad/blocks {errs} min eig/|H| {float(w.min()):.3e} "
                  f"sweeps mean {float(k[4].double().mean()):.3f} max {int(k[4].max())}")
            assert max(errs) <= 1e-10
        else:
            # every pair beyond dHat keeps none: the zeros are checked below
            errs, kept, ok = f32_rule(kind, x, vids, eps, dHat, k, p)
            print(f"[pairs] {label} {kind} float32: n={vids.shape[0]} codes {codes:.6f} "
                  f"kept {kept} err vs f64 (kernel, plain) at q50/q99/max "
                  f"{errs} min eig/|H| {float(w.min()):.3e} sweeps mean "
                  f"{float(k[4].double().mean()):.3f} max {int(k[4].max())}")
            assert ok, errs
        assert bool((k[3].long() == p[3]).all())
        assert float(w.min()) >= -8 * eps_t
        for got in k[:3]:
            assert bool(torch.isfinite(got).all())
        # inactive pairs and the slots a reduced type leaves unused: exact zeros
        g_p, H_p = p[1].cpu(), p[2].cpu().reshape(-1, 4, 3, 12)
        unused = (g_p == 0).all(dim=2) & (H_p == 0).all(dim=3).all(dim=2)  # (N,4)
        g_k, H_k = k[1].cpu(), k[2].cpu()
        assert bool((g_k[unused] == 0).all())
        assert bool((H_k.reshape(-1, 4, 3, 12)[unused] == 0).all())
        assert bool((H_k.reshape(-1, 12, 4, 3).transpose(1, 2)[unused] == 0).all())
        assert bool((k[0][p[0] == 0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_the_cases(cuda_device, dtype):
    x, act = _cases(dtype, cuda_device)
    _against_plain(x, act, "cases")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_the_seeded_fuzz(cuda_device, dtype):
    x, act = _fuzz(dtype, FUZZ_N, cuda_device)
    _against_plain(x, act, "fuzz")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_takes_40000_pairs_in_one_call(cuda_device, dtype):
    x, act = _fuzz(dtype, 40_000, cuda_device)
    tab = SC.SlotTables(x.device, x.dtype)
    H = PAIRS.blocks(x, act, 1.0, DHAT, tab)
    assert H.shape == (80_000, 12, 12) and bool(torch.isfinite(H).all())
    assert float(_min_eig_ratio(H).min()) >= -8 * torch.finfo(dtype).eps
    # the same blocks as calls of 8,192 pairs a family
    parts = []
    for vids, eps, kind in ((act.vids_p, None, "pt"), (act.vids_e, act.eps_e, "ee")):
        for i in range(0, vids.shape[0], 8192):
            parts.append(PAIRS.launch(kind, "blocks", x, vids[i:i + 8192],
                                      None if eps is None else eps[i:i + 8192], DHAT))
    assert torch.equal(H, torch.cat(parts))


@pytest.mark.cuda
def test_each_call_is_one_launch_a_family(cuda_device):
    x, act = _cases(torch.float32, cuda_device)
    tab = SC.SlotTables(x.device, x.dtype)
    empty_ee = ActiveSet(vids_p=act.vids_p, vids_e=act.vids_e[:0], eps_e=act.eps_e[:0],
                         cnt_pt=act.cnt_pt, cnt_ee=0)
    kappa = torch.tensor(KAPPA, device=cuda_device)
    out = []
    for call in (lambda: PAIRS.energies(x, act, DHAT, tab),
                 lambda: PAIRS.gradient_rows(x, act, kappa, DHAT, tab),
                 lambda: PAIRS.blocks(x, act, kappa, DHAT, tab),
                 lambda: PAIRS.blocks(x, empty_ee, kappa, DHAT, tab)):
        n0, c0 = obs.counter("pairs.kernel_calls"), obs.counter("pairs.calls")
        call()
        out.append((obs.counter("pairs.kernel_calls") - n0, obs.counter("pairs.calls") - c0))
    torch.cuda.synchronize()
    assert out == [(2, 2), (2, 2), (2, 2), (1, 1)]


@pytest.mark.cuda
def test_kappa_on_the_device_and_on_the_host(cuda_device):
    x, act = _cases(torch.float32, cuda_device)
    tab = SC.SlotTables(x.device, x.dtype)
    for fn in (PAIRS.gradient_rows, PAIRS.blocks):
        a = fn(x, act, torch.tensor(KAPPA, device=cuda_device, dtype=torch.float64), DHAT, tab)
        b = fn(x, act, KAPPA, DHAT, tab)
        c = fn(x, act, 1.0, DHAT, tab)
        assert torch.equal(a, b) and torch.equal(b, KAPPA * c)


@pytest.fixture(scope="module")
def scene_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pair-terms kernel runs only on the card")
    from ipc_tpu_torch.pair_timing import scene_sets

    out = {}
    mp = pytest.MonkeyPatch()
    try:
        def refuse(*a, **k):
            raise AssertionError("a CUDA tensor reached the plain version")

        for name in ("pt_pair_energy", "ee_pair_energy", "pt_pair_grad", "ee_pair_grad",
                     "pt_pair_hess", "ee_pair_hess"):
            mp.setattr(SC, name, refuse)
        mp.setattr(PAIRS, "make_psd", refuse)
        for scene, size in (("twist100", None), ("boxes", None)):
            calls, counters, dHat = scene_sets(scene, torch.device("cuda"), size)
            out[scene] = (calls, counters, dHat)
    finally:
        mp.undo()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["twist100", "boxes"])
def test_every_pairs_call_on_the_card_is_the_kernel(scene_steps, scene):
    calls, counters, _ = scene_steps[scene]
    print(f"[pairs] {scene} counters {counters} counts "
          f"{[(e, a.cnt_pt, a.cnt_ee) for e, _, a in calls if a.cnt_pt + a.cnt_ee]}")
    assert counters["pairs.calls"] > 0
    assert counters["pairs.kernel_calls"] == counters["pairs.calls"]


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["twist100", "boxes"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_scene_sets(scene_steps, scene, dtype):
    from ipc_tpu_torch.pair_timing import largest

    calls, _, dHat = scene_steps[scene]
    x, act = largest(calls)
    assert act.cnt_pt + act.cnt_ee > 0
    act = ActiveSet(vids_p=act.vids_p, vids_e=act.vids_e, eps_e=act.eps_e.to(dtype),
                    cnt_pt=act.cnt_pt, cnt_ee=act.cnt_ee)
    _against_plain(x.to(dtype), act, scene, dHat)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["boxes"])  # the twist's gradient calls have no pairs
def test_the_gradient_is_the_energy_s_derivative_on_scene_steps(scene_steps, scene):
    """Along each line search's first trial step of the scenes' steps, the
    kernel's float64 gradient is its energy's derivative and its float32
    gradient carries no bias beyond the float32 plain version's rounding
    (pair_timing.gradient_check)."""
    from ipc_tpu_torch.pair_timing import gradient_check, line_search_steps

    calls, _, dHat = scene_steps[scene]
    steps = line_search_steps(calls)
    assert steps
    for x, act, x_next in steps:
        rec = gradient_check(x, act, x_next, dHat)
        print(f"[pairs] {scene} gradient check {rec}")
        assert rec["ok"], rec
