"""Start n rank processes and collect what each returns.

`launch(fn, world, backend, device, args)` spawns `world` processes (the
spawn context: a fresh interpreter each, no inherited CUDA state), which
meet through a `file://` rendezvous in a new temporary directory (no port
to pick, so parallel test workers cannot collide), initialize the default
process group (sharding.make_group), make it the active one
(spmd.activate) and call `fn(rank, world, device, *args)`; `fn` must be a
module-level function of an importable module (ipc_tpu_torch.parallel.jobs;
a spawned rank has the caller's sys.path) and return picklable values. A
rank's device is `device` when given ("cpu" in the tests; a CPU rank runs
torch single-threaded), else cuda:(rank % device_count).

No fallback: an unknown backend, NCCL on the CPU, a rank that raises, exits
with a non-zero code or outlives `timeout` fails the launch (RuntimeError
or TimeoutError), and every rank still running is then stopped.
"""

import os
import queue
import tempfile
import time
import traceback

__all__ = ["launch"]

BACKENDS = ("nccl", "gloo")


def _rank_main(fn, rank, world, backend, init_method, device, args, out):
    try:
        import torch
        import torch.distributed as dist

        from ipc_tpu_torch.parallel import spmd
        from ipc_tpu_torch.parallel.sharding import make_group

        if device is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        else:
            dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        group = make_group(backend, init_method, rank, world)
        spmd.activate(group, dev)
        try:
            result = fn(rank, world, dev, *args)
        finally:
            spmd.deactivate()
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world, backend="gloo", device=None, args=(), timeout=900.0):
    """[fn's result on rank r for r in range(world)] (module docstring)."""
    import multiprocessing

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if backend == "nccl" and device is not None and str(device).startswith("cpu"):
        raise ValueError("the nccl backend takes CUDA tensors only")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        out = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, backend, init, device, args, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results = {}
        try:
            while len(results) < world:
                try:
                    rank, ok, res = out.get(timeout=1.0)
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} exited with code {dead[0][1]}")
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"the ranks ran past {timeout} s")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{res}")
                results[rank] = res
            for r, p in enumerate(procs):
                p.join(max(1.0, deadline - time.monotonic()))
                if p.exitcode != 0:
                    raise RuntimeError(f"rank {r} exited with code {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
    return [results[r] for r in range(world)]
