"""Run one cell of the benchmark once.

    python3 rbacbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. It loads the cell's files by the names in
BENCHMARK.json, makes its inputs from the seed, sets the program up, warms
every call it will send, measures for `--seconds`, checks every answer
against the plain reference, and prints one JSON object as the last line
of standard output: the cell's end-to-end metrics (`--trace 0`) or its
per-layer metrics from a profiled stretch of the window (`--trace 1`).
The numbers the check compared, each with its limit, are the last lines
of standard error and the line's last key.

It exits 2, printing no result, without a CUDA device or with fewer than
the cell's chips, 3 where JAX or the JAX package is loaded, and 1 where
the program is absent. The program's kernel build goes to
<checkout>/build/kernels; the Triton and torch extension caches are
pointed inside <checkout>/build as well.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

from rbacbench import guard  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="rbacbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard.check("start")

    import torch
    import vectorsearch_rbac_tpu_torch  # noqa: F401  the system under test

    from rbacbench import harness
    from rbacbench.manifest import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(device)
    for ln in harness.card_line():
        harness.say(f"card: {ln}")
    harness.say(harness.peaks_line(kind))
    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            device, T_START)
    guard.check("result")
    for name, chk in line["checks"].items():
        harness.say(f"check {name} {chk['value']!r} limit {chk['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
