"""CLI driver: `python -m ipc_tpu_torch <scene.txt> [options]`.

Port of `python -m ipc_tpu`: loads a reference-format scene file, runs it
with the host-path stepper (IPCStepper.step), or with --jit-step the
device step, and writes the same artifacts (iterStats.txt,
sysE/sysM/sysL.txt, info.txt, resultsStats.txt, status{k}.npz,
surf{k}.obj). The JAX CLI's flags, with `--device` in place of
`--platform`: without it the run is on the card, and raises when none is
visible; `--device cpu` runs on the CPU. float64 unless --f32.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ipc_tpu_torch", description=__doc__)
    ap.add_argument("scene", help="scene script (.txt, reference DSL)")
    ap.add_argument("-o", "--output", default=None, help="output directory")
    ap.add_argument("-n", "--steps", type=int, default=None, help="number of steps "
                    "(default: duration/dt from the scene)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    ap.add_argument("--f32", action="store_true", help="run in float32")
    ap.add_argument("--jit-step", action="store_true",
                    help="use the device step (jit_step.make_step) instead of the host path")
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--gif", action="store_true",
                    help="render per-step frames and write anim.gif")
    ap.add_argument("--verbose", action="store_true",
                    help="print the host path's Newton iterations")
    args = ap.parse_args(argv)

    import torch

    from ipc_tpu_torch.device import resolve_device
    from ipc_tpu_torch.sim import run_scene

    state = run_scene(
        args.scene,
        out_dir=args.output,
        n_steps=args.steps,
        dtype=torch.float32 if args.f32 else torch.float64,
        device=resolve_device(args.device),
        save_every=args.save_every,
        use_jit_step=args.jit_step,
        verbose=args.verbose,
        gif=args.gif,
    )
    print(f"done: {int(state.step)} steps, t = {float(state.t):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
