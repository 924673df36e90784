"""HNSW cost-model validation on the card: the planner's recall and time
families fitted to this card's searches.

    python -m vectorsearch_rbac_tpu_torch.bench.model_validation
        [--checkpoint PATH] [--device cuda|cpu]

The port's runner for scripts/model_validation_1m.py (all of it, :21-48):
sift_like_corpus(200,000 x 128, 100 blocks a document, seed 0), the
selectivity lab world (models/validate.py selectivity_lab_world:
selectivities 0.05 / 0.1 / 0.25 / 0.5 / 1.0, seed 1) on a float32 arena
of 16,384-row blocks, 256 queries drawn by default_rng(2) from the pool,
and multi_parameter_validation over sizes 25,000 / 50,000 / 100,000 /
200,000 and ef 16 / 32 / 64 / 128 / 256, top-10, the "classic" builder at
every size, fit_mode "joint" with the offset, timing_reps 2: an HNSW
index over a random row subset of each size, its fixed-beam ef sweep at
every selectivity (recall against the subset's exact top-10; host
seconds a query, each search ending in its copy to the host), then the
reference family's joint fit and, from the same sweeps, the TPU family's
(refit_tpu_family_from_json): the records of
results/model_validation.json and results/model_validation_tpu_family.json.
Every returned row must be readable by its user. The fit is joint over
the whole grid, so the grid runs in one call.

Prints one JSON line: the keys of results/model_validation.json, the TPU
family's record under "tpu_family", each cell's recall MAE and time MAPE
beside the TPU record's (where results/ holds it) under
"cells_vs_tpu_record", and "hardware" (the card's nvidia-smi name and
power limit). The finished record is checkpointed to --checkpoint
(state/model_validation.json); a rerun over the same grid prints it
without measuring again. Exits 2 without CUDA unless given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Sequence, Tuple

import numpy as np

from ..core import build_device_arena
from ..data import sift_like_corpus
from ..models.validate import (multi_parameter_validation,
                               refit_tpu_family_from_json,
                               selectivity_lab_world)
from . import evidence

N = 200_000
SELS = [0.05, 0.1, 0.25, 0.5, 1.0]
SIZES = [25_000, 50_000, 100_000, 200_000]
EFS = [16, 32, 64, 128, 256]
TOPK = 10
NQ = 256
CHECKPOINT = os.path.join("state", "model_validation.json")
TPU_RECORDS = (os.path.join("results", "model_validation.json"),
               os.path.join("results", "model_validation_tpu_family.json"))


def run(device, n: int = N, sels: Sequence[float] = SELS,
        sizes: Sequence[int] = SIZES, efs: Sequence[int] = EFS,
        nq: int = NQ, timing_reps: int = 2) -> Tuple[Dict, Dict]:
    """The grid on `device`: (the reference family's record, the TPU
    family's)."""
    corpus, qpool = sift_like_corpus(num_vectors=n, blocks_per_doc=100,
                                     seed=0)
    world = selectivity_lab_world(corpus.num_docs, sels, seed=1)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=16384)
    rng = np.random.default_rng(2)
    queries = qpool[rng.choice(len(qpool), nq, replace=False)].astype(
        np.float32)
    out = multi_parameter_validation(
        corpus, world, sels, sizes, efs, TOPK, queries, arena=arena,
        index_kind="hnsw", fit_offset=True, fit_mode="joint",
        builder="classic", timing_reps=timing_reps)
    out["corpus"] = f"clustered sift-like {n} x {corpus.dim}"
    return out, refit_tpu_family_from_json(out, TOPK)


def beside_records(out: Dict, tpu: Dict, records=TPU_RECORDS) -> list:
    """Per cell: this run's recall MAE and time MAPE for both families
    beside the TPU records' (None where a record lacks the cell)."""
    old = []
    for path in records:
        rec = evidence.load_checkpoint(path) or {"cells": []}
        old.append({(c["n"], c["sel"]): c for c in rec["cells"]})
    rows = []
    for c, t in zip(out["cells"], tpu["cells"]):
        key = (c["n"], c["sel"])
        ref, fam = (o.get(key, {}) for o in old)
        rows.append({
            "n": c["n"], "sel": c["sel"],
            "recall_mae": c["recall_mae"], "time_mape": c["time_mape"],
            "tpu_record_recall_mae": ref.get("recall_mae"),
            "tpu_record_time_mape": ref.get("time_mape"),
            "tpu_family_recall_mae": t["recall_mae"],
            "tpu_family_time_mape": t["time_mape"],
            "tpu_family_record_recall_mae": fam.get("recall_mae"),
            "tpu_family_record_time_mape": fam.get("time_mape")})
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the finished record (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device, "bench.model_validation")
    if device is None:
        return 2
    grid = {"n": N, "sels": SELS, "sizes": SIZES, "efs": EFS, "nq": NQ}
    prev = evidence.load_checkpoint(args.checkpoint)
    if prev and prev.get("grid") == grid:
        print("resuming: the grid is checkpointed", file=sys.stderr)
        out = prev
    else:
        out, tpu = run(device)
        out["tpu_family"] = tpu
        out["cells_vs_tpu_record"] = beside_records(out, tpu)
        out["grid"] = grid
        out["hardware"] = evidence.hardware(device)
        evidence.save_checkpoint(args.checkpoint, out)
    for c in out["cells_vs_tpu_record"]:
        print(f"n={c['n']:>7} sel={c['sel']:.2f}  recall_mae="
              f"{c['recall_mae']:.3f} (TPU record {c['tpu_record_recall_mae']})"
              f"  time_mape={c['time_mape']:.2f} (TPU record "
              f"{c['tpu_record_time_mape']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
