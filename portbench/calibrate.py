#!/usr/bin/env python3
"""Readings that the limits of a cell's compared numbers are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--out chiprun_out/calib.json]

In one process (the program is built once): for each seed, the steps
before S0 and one episode through the program's step, judged by the
reference as a run judges them (the sound readings); for each control
seed, the same chain with every state rounded to bfloat16, the nearest
precision below the configuration's float32 (the control), and two planted
faults: the episode's steps returning their input state unchanged, and one
vertex of each episode step's output moved by a tenth of the mesh's
shortest surface edge. The controls and faults are judged over the
episode's steps. Not part of a benchmark run; needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    import torch

    from portbench import harness
    from portbench.reference import judge as RJ
    from portbench.reference import scene as RS

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        _log("[calibrate] no CUDA device")
        return 3
    if device.type == "cuda":
        _log(f"[calibrate] {torch.cuda.get_device_name(0)}; {harness.power_limit()}")
    cell = harness.load_cell(args.workload, root=args.root)
    scene = RS.build(cell.config, device)
    stepper, step = harness.build_program(cell, device)
    nb, K = int(cell.traffic["steps_before"]), int(cell.traffic["episode_steps"])
    h = scene.dt
    e = scene.x_rest[scene.edges]
    shift = 0.1 * float((e[:, 0] - e[:, 1]).norm(dim=1).min())
    out = dict(workload=args.workload, sound={}, control={}, unchanged={}, moved={})
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        state, x0, v0 = harness.initial_state(cell, stepper, scene, seed)
        chain, iters = [], []
        for _ in range(nb + K):
            state, st = step(state)
            chain.append(state.x.detach().clone())
            iters.append((st.newton_iters, st.pcg_iters_total))
        t1 = time.perf_counter()
        worst, rows = RJ.judge_chain(scene, x0, v0, chain)
        out["sound"][seed] = worst
        out.setdefault("iterations", {})[seed] = iters
        _log(f"[calibrate] seed {seed}: steps {t1 - t0:.1f} s, judged {time.perf_counter() - t1:.1f} s, "
             f"(Newton, PCG) per step {iters}: {worst}")
        if seed not in controls:
            continue
        x64 = [torch.as_tensor(x0, device=device)] + [c.double() for c in chain]

        def episode_judge(xs):
            """Judge the episode's steps from the chain's state before them."""
            xa = x64[nb]
            va = (x64[nb] - x64[nb - 1]) / h if nb else torch.as_tensor(v0, device=device)
            return RJ.judge_chain(scene, xa, va, xs, first=nb)[0]

        rounded = [x.to(torch.bfloat16).double() for x in x64]
        xa = rounded[nb]
        va = (rounded[nb] - rounded[nb - 1]) / h if nb else torch.as_tensor(v0, device=device)
        out["control"][seed] = RJ.judge_chain(scene, xa, va, rounded[nb + 1:], first=nb)[0]
        out["unchanged"][seed] = episode_judge([x64[nb]] * K)
        moved = []
        for x in x64[nb + 1:]:
            y = x.clone()
            y[int(scene.surf[len(scene.surf) // 2]), 0] += shift
            moved.append(y)
        out["moved"][seed] = episode_judge(moved)
        _log(f"[calibrate] seed {seed}: control {out['control'][seed]}; unchanged "
             f"{out['unchanged'][seed]}; moved {out['moved'][seed]}")
    for kind in ("sound", "control", "unchanged", "moved"):
        if out[kind]:
            nums = {k: [v[k] for v in out[kind].values()] for k in RJ.WORST}
            _log(f"[calibrate] {kind}: " + "; ".join(
                f"{k} min {min(v)!r} max {max(v)!r}" for k, v in nums.items()))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
