"""python -m ipc_tpu_torch.parallel: the two-box scene's step split over
ranks (the counterpart of __graft_entry__.dryrun_multichip).

    python -m ipc_tpu_torch.parallel --ranks 2 --backend gloo --device cpu
    python -m ipc_tpu_torch.parallel --ranks 2 --backend gloo --n-cells 20 --f32

builds scenes.build_scene(n_cells, with_contact=True), shards it over
--ranks processes with --backend (ranks on the card by default: rank r on
cuda:(r % device_count); --device cpu for the CPU), runs --steps steps
from rest and prints each rank's shard bytes (what is split and what is
replicated) and, per step, the Newton and PCG iterations, the pair counts
(summed, and each rank's own), collectives, operator applications,
tet_hv launches and wall seconds. It fails if the ranks' states differ
by a bit, or a state is not finite, below the ground or intersecting.
"""

import argparse
import sys

import numpy as np


def main(argv=None):
    from ipc_tpu_torch.parallel.jobs import step_job
    from ipc_tpu_torch.parallel.launch import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    ap.add_argument("--n-cells", type=int, default=10)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--f32", action="store_true", help="float32 (default float64)")
    args = ap.parse_args(argv)
    spec = dict(n_cells=args.n_cells, dtype="float32" if args.f32 else "float64",
                with_contact=True, steps=args.steps)
    outs = launch(step_job, args.ranks, args.backend, args.device, (spec,))
    print(f"[parallel] {args.ranks} ranks, backend {outs[0]['backend']}, "
          f"devices {[o['device'] for o in outs]}")
    for o in outs:
        for name, total, mine, kind in o["report"]:
            print(f"  rank {o['rank']} {name:16s} {total:>12d} B total {mine:>12d} B on the "
                  f"rank ({kind})")
    ok = True
    for i in range(args.steps):
        rows = [o["rows"][i] for o in outs]
        s = rows[0]["stats"]
        same = all(np.array_equal(r["x"], rows[0]["x"]) for r in rows)
        good = all(r["finite"] and r["ymin"] > 0 and not r["intersection"] for r in rows)
        ok &= same and good
        print(f"[parallel] step {i}: newton_iters={s['newton_iters']} "
              f"pcg_iters_total={s['pcg_iters_total']} pt/ee/et={s['pt_count']}/"
              f"{s['ee_count']}/{s['et_count']} active_pt/ee_max={s['active_pt_max']}/"
              f"{s['active_ee_max']} fric_count={s['fric_count']} per rank "
              f"{[r['rank_counts'] for r in rows]} collectives={rows[0]['collectives']} "
              f"operator_applications={[r['operator_applications'] for r in rows]} "
              f"tet_hv_launches={[r['tet_hv_launches'] for r in rows]} "
              f"wall_s={[round(r['wall_s'], 4) for r in rows]} ranks_bitwise_equal={same} "
              f"checks_held={good}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
