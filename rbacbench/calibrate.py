"""The readings the check's limits are set from, on the card.

    python3 -m rbacbench.calibrate --workload <cell> --seeds S1 S2 ...
        [--seconds 5] [--out <file>.jsonl]

For each seed, in one process: one run of the cell (its set-up, a short
window at the cell's own load, the check of every answer), and the
control, the reference at int4 in the program's place over the same
queries, judged by the same numbers. One JSON line a seed: the program's
numbers (the lower readings), the control's (the upper), and the run's
set-up and window. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import guard, harness
from .manifest import load_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rbacbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    guard.check("start")
    if not torch.cuda.is_available():
        print("calibration runs on a card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        line = harness.run_cell(cell, seed, args.seconds, False, device,
                                time.perf_counter(), control=True)
        rec = {"cell": cell.name, "seed": seed,
               "program": {n: c["value"] for n, c in line["checks"].items()},
               "control": line["control"],
               "recall_at_k": line["metrics"]["recall_at_k"]["value"],
               "qps": line["metrics"]["qps"]["value"],
               "setup": line["setup"],
               "kind": line["device"]["kind"]}
        text = json.dumps(rec)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        torch.cuda.empty_cache()
    guard.check("end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
