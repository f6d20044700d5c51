"""Time the ACCD kernel (csrc/accd.cu via contact/ccd.py) on the card beside
its plain version and its bound, on the candidate sets of the benchmark's
two scenes.

    python -m ipc_tpu_torch.accd_timing

Builds the mat twist (n = 100: 60,000 tets) and the two-box scene
(n_cells = 20: 96,000 tets, self-contact) on the card in float32, with the
device step (jit_step.make_step): the twist from rest, the boxes after
steps 0-7, where the upper cube lands. One step of each (`scene_calls`)
runs with the program's tracing on and `SelfContact.ccd_alpha`'s inputs
recorded; of each family (pt, ee) the call with the most stencils is kept.
Prints one JSON object per (scene, family, dtype: the scene's float32 and
the same stencils in float64):

  n                     stencils in the call
  max_abs_diff, bit_equal
                        kernel vs plain version on the card (the largest
                        |t| difference; the share of stencils with equal bits)
  live_equal            the share of stencils whose live passes (the passes
                        they begin not done) are the plain version's
  live_pair_passes, live_passes
                        the kernel's live passes: summed, and the most
  kernel_ms, plain_ms   median device ms of one call (hv_timing.device_ms:
                        queued behind a device sleep, L2 flushed before each)
  bytes, bound_us, share_of_bound
                        x4 and p4 read once, t written once, at 3.35 TB/s,
                        and that bound over kernel_ms. Not the kernel's
                        limit: its live passes' arithmetic is (csrc/accd.cu)

and one per scene with the step's `ccd.*` counters: `ccd.calls` and
`ccd.kernel_calls` (launches) among them. The comparison and timing calls
count in no counter (utils/observability.Capture).
"""

import json

import torch

from ipc_tpu_torch.hv_timing import FLUSH_BYTES, HBM_BYTES_PER_S, device_ms

__all__ = ["SCENES", "scene_calls", "plain_live", "kernel_live", "compare", "measure"]

# (builder, size, steps before the recorded one)
SCENES = {"twist": ("build_twist_scene", 100, 0), "boxes": ("build_scene", 20, 8)}


def scene_calls(name, device, size=None):
    """({"pt": (x4, p4), "ee": (x4, p4)}, counters): the largest ccd_alpha
    call of each family in one device step of scene `name` (SCENES; `size`
    in place of its size) on `device`, and that step's `ccd.*` counters
    under tracing."""
    import dataclasses

    from ipc_tpu_torch import jit_step, scenes
    from ipc_tpu_torch.utils import observability as obs

    builder, default, before = SCENES[name]
    size = size or default
    kw = {"with_contact": True} if name == "boxes" else {}
    st = getattr(scenes, builder)(size, "float32", device, **kw)
    step = jit_step.make_step(st)
    state = st.initial_state()
    aux = jit_step.initial_device_aux(st)
    if aux is not None:
        state = dataclasses.replace(state, aux=aux)
    for _ in range(before):
        state, _ = step(state)
    sc, kept = st.sc, {}
    ccd_alpha = sc.ccd_alpha

    def record(x, dx, cand, *args):
        for kind, vids in (("pt", cand.pt_vids), ("ee", cand.ee_vids)):
            if vids.shape[0] > kept.get(kind, (torch.empty(0),))[0].shape[0]:
                kept[kind] = (x[vids].clone(), dx[vids].clone())
        return ccd_alpha(x, dx, cand, *args)

    sc.ccd_alpha = record
    obs.set_tracing(True)
    try:
        step(state)
    finally:
        obs.set_tracing(False)
        del sc.ccd_alpha
    counters = {k: v for k, v in obs.collect()["counters"].items() if k.startswith("ccd.")}
    return kept, counters


def plain_live(kind, x4, p4, slackness=0.2, max_iter=64):
    """(t, live): the plain version's safe steps and, per stencil, the
    passes it began not done."""
    from ipc_tpu_torch.contact import ccd as CCD

    dist2 = CCD._pt if kind == "pt" else CCD._ee
    t, done = CCD._accd_loop(x4, p4, dist2, slackness, max_iter, 1.0, True)
    return t, max_iter - done


def kernel_live(kind, x4, p4, slackness=0.2, max_iter=64):
    """(t, live) of the kernel: its safe steps and, per stencil, the
    passes it began not done (what the wrapper counts while tracing is on)."""
    from ipc_tpu_torch.contact.ccd import _accd_kernel

    return _accd_kernel(kind, x4, p4, slackness, max_iter, True)


def compare(kind, x4, p4):
    """Kernel vs plain version on the same stencils: dict(n, max_abs_diff,
    bit_equal, live_equal, live_pair_passes, live_passes)."""
    t, live = kernel_live(kind, x4, p4)
    tp, livep = plain_live(kind, x4, p4)
    n = int(t.shape[0])
    return dict(n=n, max_abs_diff=float((t - tp).abs().max()) if n else 0.0,
                bit_equal=float((t == tp).double().mean()) if n else 1.0,
                live_equal=float((live == livep).double().mean()) if n else 1.0,
                live_pair_passes=int(live.sum()), live_passes=int(live.max()) if n else 0)


def measure(kind, x4, p4):
    """One record (module docstring) of one family's stencils."""
    from ipc_tpu_torch.contact import ccd as CCD
    from ipc_tpu_torch.utils.observability import Capture

    wrapper = CCD.accd_pt if kind == "pt" else CCD.accd_ee
    dist2 = CCD._pt if kind == "pt" else CCD._ee
    flush_buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=x4.device)

    def flush():
        flush_buf.sum()

    with Capture():  # comparison and timing calls are not main-path launches
        rec = compare(kind, x4, p4)
        rec["kernel_ms"] = device_ms(lambda: wrapper(x4, p4), flush)
        rec["plain_ms"] = device_ms(lambda: CCD._accd(x4, p4, dist2, 0.2, 64), flush)
    size = x4.element_size()
    rec["bytes"] = rec["n"] * (24 + 1) * size
    rec["bound_us"] = 1e6 * rec["bytes"] / HBM_BYTES_PER_S
    rec["share_of_bound"] = rec["bound_us"] / (1e3 * rec["kernel_ms"])
    return rec


def main():
    from ipc_tpu_torch.device import require_cuda

    device = require_cuda()
    print(f"[accd_timing] {torch.cuda.get_device_name(0)}", flush=True)
    for name in SCENES:
        kept, counters = scene_calls(name, device)
        print(json.dumps(dict(scene=name, **counters)), flush=True)
        for kind, (x4, p4) in kept.items():
            for dtype in (torch.float32, torch.float64):
                rec = measure(kind, x4.to(dtype), p4.to(dtype))
                print(json.dumps(dict(scene=name, family=kind,
                                      dtype=str(dtype).replace("torch.", ""), **rec)),
                      flush=True)


if __name__ == "__main__":
    main()
