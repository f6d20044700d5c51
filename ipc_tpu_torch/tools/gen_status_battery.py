"""The STATUS.md battery section generated from battery JSON files (the
port's copy of tools/gen_status_battery.py): the tally and the per-scene
table are derived from the data, so the prose cannot drift from the
evidence.

Merges one or more battery JSON files. Per scene the BEST outcome wins, not
the latest file: PASS > TIMEOUT > SKIP > FAIL, ties broken by steps
completed, then by file order (a later crash never hides an earlier PASS).
Writes a markdown table + tally between the BATTERY:BEGIN/END markers of
--status (only when that file exists), and prints the tally. The output is
the JAX tool's byte for byte but for the generated-by marker, which names
this file.

Usage:
  python -m ipc_tpu_torch.tools.gen_status_battery cpu.json cuda.json \
      --merge-out BATTERY.json [--status STATUS.md]
"""

import argparse
import json
import os
import re


_STATUS_RANK = {"PASS": 3, "TIMEOUT": 2, "SKIP": 1, "FAIL": 0}


def _rank(rec):
    steps = rec.get("steps", rec.get("step", 0)) or 0
    return (_STATUS_RANK.get(rec.get("status"), -1), steps)


def load_merge(paths):
    by_scene = {}
    order = []
    for p in paths:
        with open(p) as f:
            for rec in json.load(f):
                key = rec["scene"]
                if key not in by_scene:
                    order.append(key)
                    by_scene[key] = rec
                elif _rank(rec) >= _rank(by_scene[key]):
                    by_scene[key] = rec
    return [by_scene[k] for k in order]


def tally(recs):
    t = {}
    for r in recs:
        t[r["status"]] = t.get(r["status"], 0) + 1
    return t


def table(recs):
    lines = [
        "| Scene | Config | Path | Steps | Secs | Newton | Status |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=lambda r: r["scene"]):
        note = ""
        if r["status"] == "SKIP":
            note = " (asset absent)"
        elif r["status"] == "FAIL":
            note = f" — {r.get('error', '')[:60]}"
        lines.append(
            "| {scene} | {cfg} | {path} | {steps} | {secs} | {newton} | {status}{note} |".format(
                scene=r["scene"],
                cfg=r.get("config", "—"),
                path=r.get("path", "—"),
                steps=r.get("steps", r.get("step", "—")),
                secs=r.get("secs", "—"),
                newton=r.get("newton_iters", "—"),
                status=r["status"],
                note=note,
            )
        )
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("batteries", nargs="+")
    ap.add_argument("--status", default="STATUS.md")
    ap.add_argument("--merge-out", default="",
                    help="also write the merged record list to this path")
    args = ap.parse_args(argv)

    recs = load_merge(args.batteries)
    t = tally(recs)
    tally_line = " / ".join(f"{t.get(s, 0)} {s}" for s in
                            ("PASS", "SKIP", "TIMEOUT", "FAIL"))
    section = (
        "<!-- BATTERY:BEGIN (generated by ipc_tpu_torch/tools/gen_status_battery.py from "
        + ", ".join(os.path.basename(p) for p in args.batteries)
        + " — do not edit by hand) -->\n"
        f"**Battery tally over {len(recs)} scene records: {tally_line}.**\n\n"
        + table(recs)
        + "\n<!-- BATTERY:END -->"
    )

    if args.merge_out:
        with open(args.merge_out + ".tmp", "w") as f:
            json.dump(recs, f, indent=1)
        os.replace(args.merge_out + ".tmp", args.merge_out)

    if os.path.exists(args.status):
        with open(args.status) as f:
            txt = f.read()
        pat = re.compile(r"<!-- BATTERY:BEGIN.*?BATTERY:END -->", re.S)
        if pat.search(txt):
            txt = pat.sub(lambda m: section, txt)
        else:
            txt += "\n\n## Battery (generated)\n\n" + section + "\n"
        with open(args.status + ".tmp", "w") as f:
            f.write(txt)
        os.replace(args.status + ".tmp", args.status)
        print(f"updated {args.status}")
    print(f"{len(recs)} records: {tally_line}")


if __name__ == "__main__":
    main()
