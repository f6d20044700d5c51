"""Time the Hv kernel (ops/tet_hv.py) on the card beside its bound, its
plain version and a library yardstick.

    python -m ipc_tpu_torch.hv_timing [scene:n ...]

prints one JSON object per (scene, n, dtype), for the shapes named (e.g.
`twist:150 twist:225`, the paper's larger mat twists) or by default the two-box scene's
topology at n_cells 8 and 20 (6,144 and 96,000 tets), the mat-twist
scene's at n = 100 (60,000 tets, 20,402 vertices), the driver scene's
(the boxes at n_cells 20 over a meshCO plate: its 4 tet-less vertices
have degree 0, so their table rows are all padding) and the shard shape
of a 2-rank sharded step (parallel/sharding.py: rank 0's 48,000 tets of
the boxes at n_cells 20 over all 18,524 vertices of the padded mesh, half
of which no tet of the rank touches), with seeded random SPD-like H
blocks and v rows (a fifth of them zeroed, as DBC rows are):

  max_abs_err, limit  kernel vs plain version, and the tolerance (1e-5 in
                      f32, 1e-12 in f64, times the plain result's max |.|)
  bitwise_repeat      two kernel calls give equal bits
  kernel_ms, plain_ms, library_ms
                      median of 20 device times per call (CUDA events);
                      the calls are queued behind a device sleep, so host
                      launch overhead is not in them, and L2 is flushed
                      before each call (the bound counts every byte from
                      device memory)
  library_err         the yardstick's max |.| difference from the plain result
  assembly_ms, nnz    the yardstick's one-time CSR assembly from H (median of
                      3, host syncs included) and its stored values
  bytes, flops, bound_us, bound_by, share_of_bound
                      the least time for the call: the larger of bytes
                      (H, v, tets, inc read once, out written once) at
                      3.35 TB/s and flops (2 per H value) at the FP32 / FP64
                      peak (67 / 34 TFLOP/s, H100 SXM data sheet); share is
                      bound over kernel time
  empty_ms            the same timing of a call that launches nothing: the
                      floor of the method
  tetless_zero        the rows of the vertices no tet touches (the driver
                      scene's plate, the shard's other half and padding)
                      are exact zeros in the kernel's result (null where
                      every vertex has a tet)
  split_us            mean device microseconds per call of each kernel the
                      call launches (torch.profiler, L2 flushed between
                      calls); a kernel that waits on another (a programmatic
                      dependent launch) counts its wait

The yardstick is one PyTorch call computing the same linear map: `A @ v`
with A the assembled torch.sparse_csr_tensor (cuSPARSE SpMV). The port never
calls it. The module uses only make_tet_hv_table, tet_hv, tet_hv_reference
and the scene builders on "cpu", so it also times an older checkout of the
package for a same-card comparison.
"""

import json
import re
import statistics
import warnings

import numpy as np
import torch

__all__ = ["device_ms", "kernel_split_us", "device_launches", "hv_problem", "hv_bound", "assemble_csr", "measure"]

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
TOL = {torch.float32: 1e-5, torch.float64: 1e-12}
REPS = 20
SLEEP_CYCLES = 50_000_000  # ~25 ms: long enough to queue 20 calls behind it
FLUSH_BYTES = 256 << 20    # > 50 MB L2


def device_ms(fn, flush):
    """Median device milliseconds of one fn() call over REPS calls, all
    queued behind a device sleep (so no call waits on the host), with
    flush() run before each call outside the timed window."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(REPS)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in events:
        flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def kernel_split_us(fn, flush):
    """{kernel name: mean device microseconds per fn() call over REPS
    calls}, with flush() before each call; the flush's own kernels are left
    out."""
    acts = [torch.profiler.ProfilerActivity.CUDA]

    def per_call(f):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(REPS):
                f()
            torch.cuda.synchronize()
        return {e.key: e.self_device_time_total / REPS for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA}

    flush_keys = set(per_call(flush))
    out = {}
    for key, us in per_call(lambda: (flush(), fn())).items():
        if key not in flush_keys:
            m = re.search(r"(\w+_kernel)\b", key)
            out[m.group(1) if m else key[:60]] = us
    return out


def device_launches(fn, device):
    """(fn(), the tet_hv calls that ran on the card `device` while fn ran),
    read from the kernel's own device counter (ops/tet_hv.device_launches):
    the card's record, CUDA graph replays included, to hold the wrapper's
    launch count against."""
    from ipc_tpu_torch.ops import tet_hv as TH

    n0 = TH.device_launches(device)
    out = fn()
    return out, TH.device_launches(device) - n0


SCENES = (("boxes", 8), ("boxes", 20), ("twist", 100), ("driver", 20), ("shard", 20))
SHARD_RANKS = 2
DRIVER_TETLESS = 4  # the driver scene's plate: two triangles, four vertices


def hv_problem(n_cells, scene="boxes"):
    """Numpy inputs at a scene's topology (the two-box scene at n_cells,
    the mat-twist scene at n = n_cells, the driver scene: the boxes plus
    DRIVER_TETLESS tet-less vertices, or the shard: rank 0's tets of the
    boxes padded for SHARD_RANKS ranks over the padded vertices), seeded
    by n_cells: tets (T,4), n_verts, H (T,12,12) SPD-like, v (V,3) with a
    fifth of its rows zeroed."""
    from ipc_tpu_torch import scenes

    build = scenes.build_twist_scene if scene == "twist" else scenes.build_scene
    st = build(n_cells, torch.float64, "cpu")
    tets = st.mesh.tets.numpy()
    n_verts = int(st.mesh.x_rest.shape[0]) + (DRIVER_TETLESS if scene == "driver" else 0)
    if scene == "shard":
        from ipc_tpu_torch.parallel.sharding import shard_mesh_data

        padded, rows = shard_mesh_data(st.mesh, SHARD_RANKS, 0)
        tets = padded.tets.numpy()[slice(*rows["tets"])]
        n_verts = int(padded.x_rest.shape[0])
    rng = np.random.default_rng(n_cells)
    M = rng.normal(size=(tets.shape[0], 12, 12))
    H = M @ np.swapaxes(M, 1, 2) / 12.0
    v = rng.normal(size=(n_verts, 3))
    v[rng.uniform(size=n_verts) < 0.2] = 0.0
    return tets, n_verts, H, v


def hv_bound(n_tets, n_verts, D, dtype):
    """(bytes, flops, bound_us, bound_by) of one call."""
    s = torch.finfo(dtype).bits // 8
    nbytes = n_tets * 144 * s + n_verts * 3 * s + n_tets * 16 + n_verts * D * 4 + n_verts * 3 * s
    flops = 2 * 144 * n_tets
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return nbytes, flops, 1e6 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def assemble_csr(H, tets, n_verts):
    """The (3V,3V) CSR matrix sum_t P_t^T H_t P_t (duplicates summed)."""
    dof = (3 * tets[:, :, None] + torch.arange(3, device=tets.device)).reshape(-1, 12)
    rows = dof[:, :, None].expand(-1, 12, 12).reshape(-1)
    cols = dof[:, None, :].expand(-1, 12, 12).reshape(-1)
    n = 3 * n_verts
    with warnings.catch_warnings():  # torch flags its sparse CSR support as beta
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), H.reshape(-1), (n, n))
        return coo.coalesce().to_sparse_csr()


def measure(n_cells, dtype, device, scene="boxes"):
    """One record (see the module docstring) for a scene's topology at
    n_cells, in dtype, on the card."""
    from ipc_tpu_torch.ops.tet_hv import make_tet_hv_table, tet_hv, tet_hv_reference

    tets_np, n_verts, H_np, v_np = hv_problem(n_cells, scene)
    table = make_tet_hv_table(tets_np, n_verts, device)
    H = torch.as_tensor(H_np, device=device).to(dtype).contiguous()
    v = torch.as_tensor(v_np, device=device).to(dtype).contiguous()
    launches0 = tet_hv.launches
    out = tet_hv(H, v, table)
    again = tet_hv(H, v, table)
    plain = tet_hv_reference(H, table.tets, v, table.gsum)
    torch.cuda.synchronize()
    err = (out - plain).abs().max().item()
    scale = plain.abs().max().item()
    untouched = np.ones(n_verts, bool)
    untouched[tets_np.reshape(-1)] = False
    tetless_zero = (bool((out[torch.as_tensor(untouched, device=device)] == 0).all())
                    if untouched.any() else None)

    flush_buf = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device=device)

    def flush():
        flush_buf.sum()  # reads only: L2 left holding clean lines

    asm = []
    for _ in range(3):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        A = assemble_csr(H, table.tets, n_verts)
        b.record()
        torch.cuda.synchronize()
        asm.append(a.elapsed_time(b))
    vflat = v.reshape(-1)
    lib = (A @ vflat).reshape(-1, 3)
    torch.cuda.synchronize()

    kernel_ms = device_ms(lambda: tet_hv(H, v, table), flush)
    plain_ms = device_ms(lambda: tet_hv_reference(H, table.tets, v, table.gsum), flush)
    library_ms = device_ms(lambda: A @ vflat, flush)
    empty_ms = device_ms(lambda: None, flush)
    split_us = kernel_split_us(lambda: tet_hv(H, v, table), flush)
    tet_hv.launches = launches0  # comparison calls are not main-path launches
    n_tets, D = tets_np.shape[0], int(table.inc.shape[1])
    nbytes, flops, bound_us, bound_by = hv_bound(n_tets, n_verts, D, dtype)
    return dict(
        scene=scene, n_cells=n_cells, tets=n_tets, verts=n_verts, D=D,
        dtype=str(dtype).replace("torch.", ""),
        max_abs_err=err, limit=TOL[dtype] * scale, bitwise_repeat=bool(torch.equal(out, again)),
        kernel_ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
        library_err=(lib - plain).abs().max().item(),
        assembly_ms=statistics.median(asm), nnz=int(A.values().numel()),
        bytes=nbytes, flops=flops, bound_us=bound_us, bound_by=bound_by,
        share_of_bound=bound_us / (1e3 * kernel_ms), empty_ms=empty_ms, split_us=split_us,
        tetless_zero=tetless_zero,
    )


def main(argv=None):
    import argparse

    from ipc_tpu_torch.device import require_cuda

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("shapes", nargs="*", help="scene:n (scene boxes|twist|driver|shard); "
                    "default: SCENES")
    args = ap.parse_args(argv)
    shapes = [(s.split(":")[0], int(s.split(":")[1])) for s in args.shapes] or SCENES
    device = require_cuda()
    print(f"[hv_timing] {torch.cuda.get_device_name(0)}", flush=True)
    for scene, n_cells in shapes:
        for dtype in (torch.float32, torch.float64):
            print(json.dumps(measure(n_cells, dtype, device, scene)), flush=True)


if __name__ == "__main__":
    main()
