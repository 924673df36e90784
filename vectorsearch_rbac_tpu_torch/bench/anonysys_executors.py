"""AnonySys's three executors over one plan at 1M on the card: the tiled
int8 flat scan, per-partition HNSW, and the hybrid.

    python -m vectorsearch_rbac_tpu_torch.bench.anonysys_executors
        [--executors tiled_flat hnsw_iterative hybrid] [--checkpoint PATH]
        [--device cuda|cpu]

The port's runner for scripts/anonysys_hnsw_1m.py, at its sizes: the
corpus, world, 4,096-query workload, truth and int8 arena of
bench.strategy_compare (the same script set-up), top-10, and one
FrameworkConfig(seed=0) with ef 40, batch 1,024 and storage alpha 2.0
for all three:

- C, "tiled_flat": build_searcher("dynamic"), the TiledSearcher. It makes
  the plan; plan_partitions and plan_s (planning and C's build) go into
  the record;
- A, "hnsw_iterative": index kind "hnsw", packed=False, on C's plan. Both
  packages force these partitions logical, so the graph batcher serves
  them (the iterative search, per-comb admissible entries);
- B, "hybrid": index kind "hybrid", packed=False, on C's plan: graphs
  where every comb routed to a partition keeps its selectivity, the flat
  scan elsewhere; hybrid_graph_partitions counts the graphs.

A and B record their build seconds (hnsw_build_s, hybrid_build_s).

Protocol: the script times one warm pass (warm_s) and then ONE pass.
A single host-clock read of a pass moves 15-30% between runs on the
card, so this runner takes 3 passes after the warm one and reports their
median under "qps", every wall beside it (pass_walls_s). recall_at_10 is
the last pass's, against the exact truth; every returned row must be
readable by its user; each executor also gives the kernels its timed
passes launched.

Each executor is checkpointed to --checkpoint
(state/anonysys_executors.json) as it is measured, and a rerun skips the
measured ones; a rerun without C plans again (plan_dynamic_partitions,
deterministic) and keeps the checkpointed plan_s. --executors splits the
run. Prints one JSON line: "protocol" (naming the TPU record
results/anonysys_hnsw_1m_r3.json), "hardware" (the card's nvidia-smi
name and power limit) and the script's keys. Exits 2 without CUDA unless
given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import FrameworkConfig
from ..partition import build_searcher
from ..partition.dynamic import plan_dynamic_partitions, planner_inputs
from . import evidence
from .evidence import free, log
from .ground_truth import compute_recall
from .strategy_compare import make_data, timed_passes

N, NQ, K, EF, ALPHA = 1_000_000, 4096, 10, 40, 2.0
# record key -> index kind (None: the config's default, the script's C)
EXECUTORS = {"tiled_flat": None, "hnsw_iterative": "hnsw",
             "hybrid": "hybrid"}
BUILD_KEYS = {"hnsw_iterative": "hnsw_build_s", "hybrid": "hybrid_build_s"}
REFERENCE_RECORD = "results/anonysys_hnsw_1m_r3.json"
CHECKPOINT = os.path.join("state", "anonysys_executors.json")
CONFIG = ("AnonySys alpha=2.0, 1M clustered sift-like, tree RBAC 100 roles, "
          "top-10, 4096 queries")


def executor_config(kind: Optional[str], k: int = K) -> FrameworkConfig:
    """The script's FrameworkConfig (its cfg, cfg_h, cfg_y)."""
    cfg = FrameworkConfig(seed=0)
    cfg.search.ef_search = EF
    cfg.search.batch_size = 1024
    cfg.optimizer.storage_alpha = ALPHA
    cfg.optimizer.topk = k
    if kind is not None:
        cfg.index.kind = kind
    return cfg


def plan_and_flat(data: Dict):
    """C: (searcher, its plan, seconds of planning and building)."""
    t0 = time.perf_counter()
    s = build_searcher("dynamic", data["corpus"], data["world"],
                       data["arena"], executor_config(None, data["k"]))
    return s, s.plan, time.perf_counter() - t0


def plan_only(data: Dict):
    cfg = executor_config(None, data["k"])
    return plan_dynamic_partitions(
        data["world"], planner_inputs(data["corpus"], data["world"], cfg))


def build_executor(name: str, data: Dict, plan):
    """A or B over `plan`: (searcher, build seconds)."""
    t0 = time.perf_counter()
    s = build_searcher("dynamic", data["corpus"], data["world"],
                       data["arena"], executor_config(EXECUTORS[name],
                                                      data["k"]),
                       plan=plan, packed=False)
    return s, time.perf_counter() - t0


def graph_partitions(searcher) -> int:
    return sum(1 for p in searcher.partitions.values()
               if type(p.index).__name__ == "HNSWIndex")


def measure(name: str, searcher, data: Dict) -> Dict:
    """A warm pass (its seconds are warm_s), then 3 timed passes."""
    q, uids, k = data["queries"], data["uids"], data["k"]
    t0 = time.perf_counter()
    searcher.search_batch(q, uids, data["world"].user_masks, k)
    warm = time.perf_counter() - t0
    ids, walls, launches = timed_passes(name, searcher, data, 3)
    return {f"recall_at_{k}": round(compute_recall(ids, data["truth"]), 4),
            "qps": round(len(q) / float(np.median(walls)), 1),
            "warm_s": round(warm, 1),
            "pass_walls_s": [round(w, 4) for w in walls],
            "kernels": launches}


def protocol(n: int, nq: int) -> Dict:
    return {"n": n, "queries": nq, "topk": K, "ef": EF, "alpha": ALPHA,
            "passes": "1 warm (warm_s), median of 3 (the script takes 1)",
            "reference_record": REFERENCE_RECORD + " (taken on a TPU v5e)"}


def run(executors: Sequence[str], device, n: int = N, nq: int = NQ,
        out: Optional[Dict] = None, checkpoint: Optional[str] = None
        ) -> Dict:
    """The record with the executors in `executors` that `out` does not
    hold yet measured and checkpointed one by one (C, then A, then B)."""
    out = out if out is not None else {}
    out.setdefault("config", CONFIG)
    out.setdefault("protocol", protocol(n, nq))
    out.setdefault("hardware", evidence.hardware(device))
    todo = [e for e in EXECUTORS if e in executors and e not in out]
    if not todo:
        log("all executors checkpointed: skip")
        return out
    t0 = time.perf_counter()
    data = make_data(n, nq, K, device)
    log(f"data: {time.perf_counter() - t0:.1f}s")
    plan = None
    for name in todo:
        if name == "tiled_flat":
            s, plan, plan_s = plan_and_flat(data)
            out["plan_partitions"] = len(plan.assignment)
            out["plan_s"] = round(plan_s, 1)
        else:
            if plan is None:
                plan = plan_only(data)
                out.setdefault("plan_partitions", len(plan.assignment))
            s, build_s = build_executor(name, data, plan)
            out[BUILD_KEYS[name]] = round(build_s, 1)
            if name == "hybrid":
                out["hybrid_graph_partitions"] = graph_partitions(s)
        row = measure(name, s, data)
        row["hardware"] = evidence.hardware(device)
        out[name] = row
        log(f"[{name}] " + json.dumps(row))
        evidence.save_checkpoint(checkpoint, out)
        del s
        free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--executors", nargs="+", choices=tuple(EXECUTORS),
                    default=list(EXECUTORS),
                    help="the executors to run (default all three)")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the executors measured so far (default "
                         f"{CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device,
                                     "bench.anonysys_executors")
    if device is None:
        return 2
    out = evidence.load_checkpoint(args.checkpoint) or {}
    if out:
        log(f"resuming: {[e for e in EXECUTORS if e in out]} checkpointed")
    out["hardware"] = evidence.hardware(device)
    out = run(args.executors, device, out=out, checkpoint=args.checkpoint)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
