"""ACCD's CUDA kernel (csrc/accd.cu) and its wrapper (contact/ccd.py).

On the CPU: `accd_pt` / `accd_ee` run the plain version `_accd`, bit for
bit, on the hand-made cases of tests/ccd_cases.py (float64 and float32,
max_iter 64 and 128) and launch nothing; they refuse stencils that are not
(N,4,3), a dtype mismatch or a dtype other than float32 / float64, tensors
on two devices and a device that is neither the CPU nor CUDA;
`_accd_kernel`, the card's route, refuses non-contiguous inputs. Under
tracing the counters keep their values: `ccd.calls` counts the calls with
stencils, the live counters are the plain loop's, and `ccd.kernel_calls`
stays 0.

On the card (marker `cuda`; they skip here), float32 and float64: the
kernel against the plain version on the same card (accd_timing.compare),
|dt| <= 1e-12 (f64) / 1e-5 (f32) and every stencil's live passes equal,
printing the largest difference and the share of equal bits, over the
hand-made cases, a seeded fuzz of 10^5 stencils per family
(ccd_cases.fuzz: wild, aimed, near-parallel, coincident, zero-area or
zero-length, no motion, rigid motion, slow motion that reaches t_max), and
the largest candidate set of each family in one device step of the twist
(n = 100, step 0) and of the landing (n_cells = 20, step 8), rebuilt from
the scenes (accd_timing.scene_calls). On the fuzz also the guarantee of
test_accd_conservative_on_seeded_fuzz: no sampled point of [0, t] closer
than the preserved gap 0.2 d0, less 1024 ulps of the stencil's largest
coordinate (the float32 distance of near-parallel edges is that coarse).
Over each of those device steps `ccd.kernel_calls == ccd.calls`, and each
wrapper call with stencils counts one launch in `ccd.kernel_calls`. On the hand-made cases and the fuzz the kernel,
the plain version on the card and the plain version on the CPU agree bit
for bit, safe steps and live passes: all three round in one order
(contact/ccd.py), so a CCD-clamped step is the same on both devices.

The module imports no JAX, so the card runs it where only PyTorch is
installed: python -m pytest --noconftest -m cuda tests/test_torch_accd_kernel.py
"""

import numpy as np
import pytest
import torch

from ccd_cases import FUZZ_KINDS, ee_cases, fuzz, pt_cases
from ipc_tpu_torch.accd_timing import SCENES, compare, plain_live, scene_calls
from ipc_tpu_torch.contact import ccd as CCD
from ipc_tpu_torch.ops.distance import edge_edge_dist2, point_triangle_dist2
from ipc_tpu_torch.utils import observability as obs

KINDS = {
    "pt": (CCD.accd_pt, CCD._pt, point_triangle_dist2, pt_cases),
    "ee": (CCD.accd_ee, CCD._ee, edge_edge_dist2, ee_cases),
}
DTYPES = [torch.float64, torch.float32]
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
BITS = {torch.float64: torch.int64, torch.float32: torch.int32}
FUZZ_N = 100_000
FUZZ_SEED = 20261018


def _cases(kind, dtype, device="cpu"):
    cases = KINDS[kind][3]()
    X = torch.as_tensor(np.stack([c[0] for c in cases]), device=device).to(dtype)
    P = torch.as_tensor(np.stack([c[1] for c in cases]), device=device).to(dtype)
    return X, P


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("max_iter", [64, 128])
def test_cpu_runs_the_plain_version(kind, dtype, max_iter):
    wrapper, dist2, _, _ = KINDS[kind]
    X, P = _cases(kind, dtype)
    launches = obs.counter("ccd.kernel_calls")
    got = wrapper(X, P, 0.2, max_iter)
    want = CCD._accd(X, P, dist2, 0.2, max_iter)
    assert got.dtype == dtype and got.shape == (X.shape[0],)
    assert torch.equal(got.view(BITS[dtype]), want.view(BITS[dtype]))
    assert obs.counter("ccd.kernel_calls") == launches


REFUSED = {
    "three points": (lambda X, P: (X[:, :3], P[:, :3]), ValueError),
    "flat": (lambda X, P: (X.reshape(-1, 12), P.reshape(-1, 12)), ValueError),
    "p4 shorter": (lambda X, P: (X, P[:-1]), ValueError),
    "dtype mismatch": (lambda X, P: (X, P.float()), TypeError),
    "integer": (lambda X, P: (X.long(), P.long()), TypeError),
    "two devices": (lambda X, P: (X, P.to("meta")), ValueError),
    "meta device": (lambda X, P: (X.to("meta"), P.to("meta")), ValueError),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_wrapper_refuses(case, kind):
    make, err = REFUSED[case]
    X, P = make(*_cases(kind, torch.float64))
    with pytest.raises(err):
        KINDS[kind][0](X, P)


def test_the_card_route_refuses_non_contiguous_inputs():
    X, P = _cases("pt", torch.float64)
    strided = X.transpose(1, 2).contiguous().transpose(1, 2)
    assert strided.shape == X.shape and not strided.is_contiguous()
    for args in ((strided, P), (X, strided)):
        with pytest.raises(ValueError, match="contiguous"):
            CCD._accd_kernel("pt", *args, 0.2, 64, False)


def test_counters_under_tracing_on_the_cpu():
    Xp, Pp = _cases("pt", torch.float64)
    Xe, Pe = _cases("ee", torch.float64)
    _, live_pt = plain_live("pt", Xp, Pp)
    _, live_ee = plain_live("ee", Xe, Pe)
    assert int(live_pt.sum()) > 0 and int(live_ee.sum()) > 0
    off = (CCD.accd_pt(Xp, Pp), CCD.accd_ee(Xe, Pe))
    obs.set_tracing(True)
    try:
        on = (CCD.accd_pt(Xp, Pp), CCD.accd_ee(Xe, Pe), CCD.accd_pt(Xp[:0], Pp[:0]))
    finally:
        obs.set_tracing(False)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    c = obs.collect()["counters"]
    n = Xp.shape[0] + Xe.shape[0]
    assert c == {"ccd.calls": 2, "ccd.passes": 3 * 64, "ccd.pair_passes": n * 64,
                 "ccd.live_pair_passes": int(live_pt.sum() + live_ee.sum()),
                 "ccd.live_passes": int(live_pt.max() + live_ee.max())}
    assert c.get("ccd.kernel_calls", 0) == 0


# --- the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ACCD kernel runs only on the card")
    return torch.device("cuda")


def _against_plain(kind, X, P, label):
    rec = compare(kind, X, P)
    print(f"[accd] {label} {kind} {X.dtype}: n={rec['n']} max|dt|={rec['max_abs_diff']:.3e} "
          f"bit-equal {rec['bit_equal']:.6f} live-equal {rec['live_equal']:.6f} "
          f"live pair-passes {rec['live_pair_passes']}, most {rec['live_passes']}")
    assert rec["max_abs_diff"] <= TOL[X.dtype]
    assert rec["live_equal"] == 1.0
    return rec


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_the_cases(cuda_device, kind, dtype):
    X, P = _cases(kind, dtype, cuda_device)
    _against_plain(kind, X, P, "cases")


def _closest_along(dist2, X, P, t, n_samples=256, chunk=8192):
    """Per stencil, the least distance over n_samples points of [0, t]."""
    ts = torch.linspace(0.0, 1.0, n_samples, dtype=X.dtype, device=X.device)
    out = []
    for i in range(0, X.shape[0], chunk):
        x, p, a = X[i:i + chunk], P[i:i + chunk], t[i:i + chunk]
        Y = x[:, None] + (ts[None, :] * a[:, None])[..., None, None] * p[:, None]
        out.append(dist2(Y[..., 0, :], Y[..., 1, :], Y[..., 2, :], Y[..., 3, :]).amin(dim=1))
    return torch.sqrt(torch.clamp(torch.cat(out), min=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_the_seeded_fuzz(cuda_device, kind, dtype):
    wrapper, _, dist2, _ = KINDS[kind]
    Xn, Pn, k = fuzz(kind, FUZZ_N, FUZZ_SEED)
    X = torch.as_tensor(Xn, device=cuda_device).to(dtype)
    P = torch.as_tensor(Pn, device=cuda_device).to(dtype)
    _against_plain(kind, X, P, "fuzz")
    t = wrapper(X, P)
    assert bool(torch.isfinite(t).all()) and bool(((t >= 0) & (t <= 1)).all())
    k = torch.as_tensor(k, device=cuda_device)
    moving = k != FUZZ_KINDS.index("coincident")  # the others have a gap to keep
    assert float((t[moving] > 0).double().mean()) > 0.9
    Xd, Pd, td = X.double(), P.double(), t.double()
    d0 = torch.sqrt(torch.clamp(dist2(Xd[:, 0], Xd[:, 1], Xd[:, 2], Xd[:, 3]), min=0.0))
    m = torch.maximum(Xd.abs().amax(dim=(1, 2)), (Xd + Pd).abs().amax(dim=(1, 2)))
    slack = _closest_along(dist2, Xd, Pd, td) - (0.2 * d0 - 1024 * torch.finfo(dtype).eps * m)
    bad = (td > 0) & (slack < 0)
    assert not bool(bad.any()), torch.nonzero(bad)[:5].flatten().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_the_cpu_bit_for_bit(cuda_device, kind, dtype):
    Xn, Pn, _ = fuzz(kind, FUZZ_N, FUZZ_SEED)
    Xc, Pc = _cases(kind, dtype)
    X = torch.cat([Xc, torch.as_tensor(Xn).to(dtype)])
    P = torch.cat([Pc, torch.as_tensor(Pn).to(dtype)])
    t_cpu, live_cpu = plain_live(kind, X, P)
    Xg, Pg = X.to(cuda_device), P.to(cuda_device)
    t_card, live_card = plain_live(kind, Xg, Pg)
    t, live = CCD._accd_kernel(kind, Xg, Pg, 0.2, 64, True)
    bits = BITS[dtype]
    for what, (tt, ll) in {"kernel": (t, live), "plain on the card": (t_card, live_card)}.items():
        tt, ll = tt.cpu(), ll.cpu()
        same = tt.view(bits) == t_cpu.view(bits)
        print(f"[accd] {kind} {dtype} {what} vs the CPU: n={X.shape[0]} bit-equal "
              f"{float(same.double().mean()):.6f}")
        assert bool(same.all()), (what, torch.nonzero(~same)[:5].flatten().tolist())
        assert torch.equal(ll, live_cpu), what


@pytest.fixture(scope="module")
def scene_steps():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ACCD kernel runs only on the card")
    return {name: scene_calls(name, torch.device("cuda")) for name in SCENES}


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_scene_candidates(scene_steps, scene, dtype):
    kept, _ = scene_steps[scene]
    assert set(kept) == {"pt", "ee"}
    for kind, (x4, p4) in sorted(kept.items()):
        assert x4.shape[0] > 0
        _against_plain(kind, x4.to(dtype), p4.to(dtype), scene)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", sorted(SCENES))
def test_every_ccd_call_is_one_launch(scene_steps, scene):
    _, counters = scene_steps[scene]
    print(f"[accd] {scene} step counters: {counters}")
    assert counters["ccd.calls"] > 0
    assert counters["ccd.kernel_calls"] == counters["ccd.calls"]


@pytest.mark.cuda
def test_wrapper_counts_its_launches(cuda_device):
    X, P = _cases("ee", torch.float32, cuda_device)
    launches = []
    for call in (lambda: CCD.accd_ee(X, P), lambda: CCD.accd_ee(X[:0], P[:0]),
                 lambda: CCD.accd_pt(*_cases("pt", torch.float32, cuda_device))):
        n0 = obs.counter("ccd.kernel_calls")
        call()
        launches.append(obs.counter("ccd.kernel_calls") - n0)
    torch.cuda.synchronize()
    assert launches == [1, 0, 1]
