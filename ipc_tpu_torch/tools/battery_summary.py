"""Tally and table of a battery JSON (the port's copy of
tools/battery_summary.py; jax-free, kept here so the port imports nothing
of the repo's tools/). The numbers in prose are derived from the artifact,
never remembered.

Usage: python -m ipc_tpu_torch.tools.battery_summary BATTERY.json [--md]
  default: one tally line + per-status scene lists (for prose)
  --md:    a full markdown table for STATUS.md
"""

import argparse
import json
from collections import Counter


def tally(records):
    c = Counter(r["status"] for r in records)
    order = ["PASS", "SKIP", "TIMEOUT", "FAIL"]
    parts = [f"{c.get(s, 0)} {s}" for s in order if c.get(s, 0)]
    for s in c:
        if s not in order:
            parts.append(f"{c[s]} {s}")
    return f"{' / '.join(parts)} over {len(records)} records"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("json_path")
    ap.add_argument("--md", action="store_true")
    args = ap.parse_args(argv)
    with open(args.json_path) as f:
        records = json.load(f)

    print(tally(records))
    if args.md:
        print()
        print("| scene | config | path | steps | secs | newton | AL | status |")
        print("|---|---|---|---|---|---|---|---|")
        for r in sorted(records, key=lambda r: r["scene"]):
            print(
                f"| {r['scene']} | {r.get('config', '?')} "
                f"| {r.get('path', '-')} | {r.get('steps', r.get('step', 0))} "
                f"| {r.get('secs', '-')} | {r.get('newton_iters', '-')} "
                f"| {r.get('al_iters', '-')} | {r['status']} |"
            )
    else:
        print()
        by = {}
        for r in records:
            by.setdefault(r["status"], []).append(r["scene"])
        for s, names in sorted(by.items()):
            print(f"{s}:")
            for n in sorted(names):
                print(f"  {n}")


if __name__ == "__main__":
    main()
