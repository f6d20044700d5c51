"""The active pairs' barrier terms, routed by device: per-pair energies,
gradient rows and PSD-projected 12x12 Hessian blocks of the PT and EE
self-contact barrier (SelfContact.energy_active / gradient_active /
hessian_blocks_from_active in contact/pipeline.py).

CPU tensors run the plain version unchanged: the eager per-pair functions
of contact/selfcollision.py, `torch.func.vmap(grad / hessian)` over them
and ops/spd.make_psd. Every other tensor goes to the kernel
(csrc/pair_terms.cu), one launch per family and call: one thread per
stencil classifies it, evaluates the barrier of its reduced type in closed
form with its gradient and Hessian and, for the blocks, projects the
reduced block to PSD by cyclic Jacobi rotations, with no host read. The
kernel takes CUDA tensors of float32 or float64 and refuses anything else,
so no tensor off the CPU reaches the plain version.

What the kernel computes is the plain version's mathematics, not its
rounding: its classification is the plain version's on the card bit for
bit (the same _rn operations in ATen's CUDA order), its values agree within
rounding (tests/test_torch_pair_terms_kernel.py).

Counters (utils/observability.py), on the host: `pairs.calls` (family
calls with at least one stencil, on every device) and `pairs.kernel_calls`
(kernel launches: on the card one per family call with stencils).
"""

import torch

from ipc_tpu_torch.contact import selfcollision as SC
from ipc_tpu_torch.ops.spd import make_psd
from ipc_tpu_torch.utils.observability import count

__all__ = ["launch", "energies", "gradient_rows", "blocks"]

_OUT = {"energy": (), "grad": (4, 3), "blocks": (12, 12)}


def _kappa(kappa, x):
    """(tensor to keep alive, its device pointer, host value) of kappa for
    the kernel: a CUDA tensor is read on the device (no host read), cast to
    x's dtype as the plain version's product casts it; anything else is a
    host value."""
    if isinstance(kappa, torch.Tensor) and kappa.device.type == "cuda":
        k = kappa.reshape(()).to(x.dtype)
        return k, k.data_ptr(), 1.0
    return None, None, float(kappa)


def launch(kind, what, x, vids, eps, dHat, kappa=1.0, project=True, out=None, code=None,
           sweeps=None):
    """One kernel launch over the stencils `vids` (N,4) of x (V,3): `kind`
    "pt" or "ee" (eps (N,), the mollifier thresholds, for "ee"), `what`
    "energy" (N,), "grad" (N,4,3) rows times kappa or "blocks" (N,12,12)
    times kappa, PSD-projected when `project`. Writes into `out` (a new
    tensor when None) and, given `code` / `sweeps` (N,) int32, each
    stencil's dType code / the Jacobi sweeps of its block (0 where none
    ran). Returns out. Counts one launch in `pairs.kernel_calls` when N > 0.
    Raises ValueError for anything but a CUDA tensor of float32 or float64."""
    if x.device.type != "cuda" or x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"pair_terms.launch: CUDA float32/float64 only, got {x.dtype} on "
                         f"{x.device}")
    n = int(vids.shape[0])
    if out is None:
        out = x.new_empty((n, *_OUT[what]))
    if not n:
        return out
    if not out.is_contiguous():
        raise ValueError("pair_terms.launch: out must be contiguous")
    x, vids = x.contiguous(), vids.contiguous()
    if vids.dtype != torch.int64 or out.dtype != x.dtype:
        raise TypeError(f"pair_terms.launch: vids {vids.dtype} (int64), out {out.dtype} "
                        f"({x.dtype})")
    if kind == "ee":
        eps = eps.to(x.dtype).contiguous()
    k_dev, kptr, kval = _kappa(kappa, x)  # k_dev lives past the launch
    from ipc_tpu_torch.build import load_kernels

    fn = getattr(load_kernels(),
                 f"ipc_pairs_{kind}_{what}_{'f32' if x.dtype == torch.float32 else 'f64'}")
    err = fn(x.data_ptr(), vids.data_ptr(), eps.data_ptr() if kind == "ee" else None, n,
             float(dHat), kptr, kval, int(bool(project)),
             out.data_ptr(), None if code is None else code.data_ptr(),
             None if sweeps is None else sweeps.data_ptr(),
             torch.cuda.current_stream(x.device).cuda_stream)
    count("pairs.kernel_calls")
    if err != 0:
        raise RuntimeError(f"pairs_{kind}_{what}: CUDA launch failed with error {err}")
    return out


def _calls(act):
    for vids in (act.vids_p, act.vids_e):
        if vids.shape[0]:
            count("pairs.calls")


def _split(x, act, what, dHat, kappa=1.0, project=True):
    """Both families' kernel outputs in one tensor, PT rows first."""
    n_pt = int(act.vids_p.shape[0])
    out = x.new_empty((n_pt + int(act.vids_e.shape[0]), *_OUT[what]))
    launch("pt", what, x, act.vids_p, None, dHat, kappa, project, out[:n_pt])
    launch("ee", what, x, act.vids_e, act.eps_e, dHat, kappa, project, out[n_pt:])
    return out, n_pt


def energies(x, act, dHat, tab):
    """Per-pair barrier energies (e_pt (Npt,), e_ee (Nee,)) of an active set,
    without kappa."""
    _calls(act)
    if x.device.type == "cpu":
        return (SC.pt_pair_energy(x[act.vids_p], dHat, tab),
                SC.ee_pair_energy(x[act.vids_e], act.eps_e, dHat, tab))
    out, n_pt = _split(x, act, "energy", dHat)
    return out[:n_pt], out[n_pt:]


def gradient_rows(x, act, kappa, dHat, tab):
    """(4 (Npt + Nee), 3) per-corner gradient rows times kappa, PT stencils
    first: what the active set's vertex gather-sum adds up."""
    _calls(act)
    if x.device.type == "cpu":
        g_pt = SC.pt_pair_grad(x[act.vids_p], dHat, tab)
        g_ee = SC.ee_pair_grad(x[act.vids_e], act.eps_e, dHat, tab)
        return torch.cat([kappa * g_pt.reshape(-1, 3), kappa * g_ee.reshape(-1, 3)])
    return _split(x, act, "grad", dHat, kappa)[0].reshape(-1, 3)


def blocks(x, act, kappa, dHat, tab, project=True):
    """(Npt + Nee, 12, 12) Hessian blocks times kappa, PSD-projected when
    `project`, PT stencils first."""
    _calls(act)
    if x.device.type == "cpu":
        H = torch.cat([SC.pt_pair_hess(x[act.vids_p], dHat, tab),
                       SC.ee_pair_hess(x[act.vids_e], act.eps_e, dHat, tab)])
        if project and H.shape[0]:
            H = make_psd(H)
        return kappa * H
    return _split(x, act, "blocks", dHat, kappa, project)[0]
