"""Batch scene runner (the counterpart of tools/batch.py, the analog of the
reference's batch.py): run every scene file of a folder through
sim.run_scene, one output folder each, and print one JSON record per scene
(scene, ok, steps, wall; error on a failure). The exit code is 0 only when
every scene ran.

    python -m ipc_tpu_torch.tools.batch scenes/ --out output/ --steps 100 \\
        [--device cpu] [--f32] [--jit-step]

--device replaces the JAX tool's --platform: the card by default (raising
without one), `cpu` for the CPU. float64 unless --f32; the host path unless
--jit-step.
"""

import argparse
import glob
import json
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("folder")
    ap.add_argument("--out", default="output")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--jit-step", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from ipc_tpu_torch.device import resolve_device
    from ipc_tpu_torch.sim import run_scene

    device = resolve_device(args.device)
    scenes = sorted(glob.glob(os.path.join(args.folder, "*.txt")))
    results = []
    for scene in scenes:
        name = os.path.splitext(os.path.basename(scene))[0]
        out_dir = os.path.join(args.out, name)
        t0 = time.perf_counter()
        try:
            state = run_scene(
                scene,
                out_dir=out_dir,
                n_steps=args.steps,
                dtype=torch.float32 if args.f32 else torch.float64,
                device=device,
                use_jit_step=args.jit_step,
            )
            rec = dict(scene=name, ok=True, steps=int(state.step),
                       wall=round(time.perf_counter() - t0, 2))
        except Exception as e:  # keep sweeping on per-scene failure
            rec = dict(scene=name, ok=False, error=str(e)[:200],
                       wall=round(time.perf_counter() - t0, 2))
        print(json.dumps(rec), flush=True)
        results.append(rec)
    n_ok = sum(r["ok"] for r in results)
    print(f"# {n_ok}/{len(results)} scenes ok")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
