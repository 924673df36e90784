"""AnonySys at 10M rows on the card: the planner and the two-tier tiled
engine at ten times the headline corpus.

    python -m vectorsearch_rbac_tpu_torch.bench.anonysys_10m

The port's runner for scripts/anonysys_10m.py, at its sizes: the bench's
scenario with --dataset sift10m (sift_like_corpus(10,000,000 x 128, 100
blocks a document, seed 0), the tree world of 100 roles and 10,000
users, 8,192 queries from the held-out pool), top-10, AnonySys
planned at alpha 2.0 (the bench plans at the config's 1.5 and has no
flag for it). The exact float32 oracle runs first on an arena of its own,
freed before the int8 serving arena is built. The plan is made once
(`plan_dynamic_partitions`) and built twice (`build_searcher`), with the
big tier's partitions copied (`big_logical` False) and gathered from the
shared arena each pass (True); each build goes through `run_benchmark`
and one more pass whose every row must be readable by its user.

Prints one JSON line: per big_logical, the partitions, recall@10, QPS,
pass walls, storage MB and build seconds, beside the plan's seconds and
the card's nvidia-smi name and power limit. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Dict

import torch

from ..core import build_device_arena
from ..partition import build_searcher
from ..partition.dynamic import plan_dynamic_partitions, planner_inputs
from .ground_truth import GroundTruthOracle
from .harness import compute_truth_sample, run_benchmark
from .evidence import card, readable_or_raise
from .scenario import make_scenario, serving_config

N, NQ, K, ALPHA = 10_000_000, 8192, 10, 2.0


def run(device, block_rows: int = 131072, timed_passes: int = 5) -> Dict:
    t0 = time.perf_counter()
    corpus, world, wl = make_scenario(n=N, num_queries=NQ, topk=K, seed=0,
                                      dataset="sift10m")
    report: Dict = {"n": corpus.n, "queries": NQ, "alpha": ALPHA,
                    "scenario_s": time.perf_counter() - t0}

    t0 = time.perf_counter()
    gt_rows = min(block_rows, 65536)
    gt_arena = build_device_arena(corpus, world, device=device,
                                  block_rows=gt_rows, dtype="float32")
    truth = compute_truth_sample(
        GroundTruthOracle(gt_arena, block_rows=gt_rows, query_batch=1024),
        corpus, world, wl, K, recall_sample=None)
    del gt_arena
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    report["ground_truth_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=block_rows, dtype="int8")
    report["arena_s"] = time.perf_counter() - t0
    cfg = serving_config(seed=0, block_rows=block_rows, batch=2048, topk=K,
                         strategy="dynamic")
    cfg.optimizer.storage_alpha = ALPHA
    cfg.optimizer.topk = K
    t0 = time.perf_counter()
    plan = plan_dynamic_partitions(world, planner_inputs(corpus, world, cfg))
    report["plan_s"] = time.perf_counter() - t0
    report["partitions"] = len(plan.assignment)

    for big_logical in (False, True):
        cfg.index.big_logical = big_logical
        t0 = time.perf_counter()
        searcher = build_searcher("dynamic", corpus, world, arena, cfg,
                                  plan=plan)
        build_s = time.perf_counter() - t0
        res = run_benchmark(searcher, corpus, world, wl, None, k=K,
                            warmup_runs=1, timed_passes=timed_passes,
                            build_time_s=build_s, recall_sample=None,
                            truth=truth)
        _, ids = searcher.search_batch(wl.vectors, wl.user_ids,
                                       world.user_masks, K)
        readable_or_raise(f"big_logical {big_logical}", ids,
                          world.user_masks[wl.user_ids], arena.host_bits)
        report[f"big_logical_{big_logical}"] = {
            "recall_at_10": res.avg_recall, "qps": res.qps,
            "pass_walls_ms": res.extra["pass_walls_ms"],
            "storage_mb": res.storage["total_mb"],
            "big_tier_partitions": len(searcher._big),
            "build_s": build_s,
            "plan_and_build_s": report["plan_s"] + build_s,
        }
        del searcher
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench.anonysys_10m measures the card: no CUDA device",
              file=sys.stderr)
        return 2
    report = run(torch.device("cuda", 0))
    report["card"] = card()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
