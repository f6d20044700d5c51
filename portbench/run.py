#!/usr/bin/env python3
"""Run one benchmark cell of ipc_tpu_torch once and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Progress, the card's name and power limit and,
last, each compared number beside its limit go to standard error; the last
line of standard output is the result, one JSON object (README.md). Exits
non-zero and prints no result when the cell's cards are not there, when
the run fails, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(ROOT, "build", "portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    # one process with few threads: the step's host work is one Python
    # thread; idle intra-op pools only add jitter
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    sys.path.insert(0, ROOT)

    import torch

    torch.set_num_threads(1)

    from portbench import harness

    cell = harness.load_cell(args.workload, root=ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"[portbench] {args.workload} needs {cell.chips} CUDA device(s); "
             f"available: {torch.cuda.is_available()}, count: "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    _log(f"[portbench] device {torch.cuda.get_device_name(0)}, count "
         f"{torch.cuda.device_count()}, nvidia-smi: {harness.power_limit()}; torch "
         f"{torch.__version__} CUDA {torch.version.cuda}")
    _log(f"[portbench] workload {args.workload} seed {args.seed} seconds {args.seconds} "
         f"trace {args.trace}")
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device,
                             log=_log, t_process=T_PROCESS)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        _log(f"[portbench] forbidden modules loaded: {', '.join(bad)}")
        return 4
    _log(f"[portbench] correct = {result['correct']}; the compared numbers:")
    for name, c in result["checks"].items():
        _log(f"[portbench] check {name} = {c['value']!r} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
