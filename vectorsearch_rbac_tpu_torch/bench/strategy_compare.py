"""The five strategies side by side at 1M on the card: RLS, ROLE, USER,
AnonySys and QDTree on the int8 arena.

    python -m vectorsearch_rbac_tpu_torch.bench.strategy_compare
        [--strategies rls role user dynamic qdtree] [--checkpoint PATH]
        [--device cuda|cpu]

The port's runner for scripts/strategy_compare_1m.py, at its sizes and
protocol: sift_like_corpus(1,000,000 x 128, 100 blocks a document, seed
0); the tree world of 100 roles and 10,000 users (h 4, b0 3, b1 4, seed
0); 4,096 queries from the held-out pool (zipf 0, seed 1); top-10. The
truth comes from the exact float32 oracle on its own arena (65,536-row
blocks, query batch 1,024), freed before serving; serving uses the int8
arena of 131,072-row blocks. Each strategy is built by build_searcher at
FrameworkConfig(seed=0) with storage alpha 2.0, top-10 and a batch of
2,048 (rls) or 1,024 (the others); QDTree is given the workload. One warm
pass, then 5 passes on the host clock (each ends in its results on the
host), QPS from the median. Every returned row must be readable by its
user.

Each strategy gives the record's keys (recall_at_10, qps, ms_per_query,
storage_mb, partitions, build_s), its pass walls and the kernels its
timed passes launched. storage_mb is storage_report()["total_mb"], the
port's own bytes (bitset words and the chunk engine's arrays), not the
reference's accounting, so it differs from the TPU record's.

make_data() is the set-up this runner shares with bench.anonysys_executors
and bench.qdtree_sweeps (their scripts build the same corpus, world,
workload, truth and arena). Each strategy is checkpointed to --checkpoint
(state/strategy_compare.json) as it is measured, and a rerun skips the
measured ones; --strategies splits the run. Prints one JSON line:
"protocol" (naming the TPU record results/strategy_compare_1m_r4.json),
"hardware" (the card's nvidia-smi name and power limit) and the
strategies. Exits 2 without CUDA unless given --device cpu.
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
from ..data import sift_like_corpus
from ..partition import build_searcher
from . import evidence
from .evidence import free, log
from .ground_truth import compute_recall

N, NQ, K = 1_000_000, 4096, 10
STRATEGIES = ("rls", "role", "user", "dynamic", "qdtree")
REFERENCE_RECORD = "results/strategy_compare_1m_r4.json"
CHECKPOINT = os.path.join("state", "strategy_compare.json")


def make_data(n: int, nq: int, k: int, device) -> Dict:
    """The scripts' set-up (evidence.scene) over sift_like_corpus(n)."""
    corpus, qpool = sift_like_corpus(num_vectors=n, blocks_per_doc=100,
                                     seed=0)
    return evidence.scene(corpus, qpool, nq, k, device)


def strategy_config(name: str, k: int = K) -> FrameworkConfig:
    """The script's FrameworkConfig for one strategy."""
    cfg = FrameworkConfig(seed=0)
    cfg.search.batch_size = 2048 if name == "rls" else 1024
    cfg.optimizer.storage_alpha = 2.0
    cfg.optimizer.topk = k
    return cfg


def build(name: str, data: Dict):
    """(searcher, build seconds) as the script builds the strategy."""
    kwargs = {"workload": data["workload"]} if name == "qdtree" else {}
    t0 = time.perf_counter()
    s = build_searcher(name, data["corpus"], data["world"], data["arena"],
                       strategy_config(name, data["k"]), **kwargs)
    return s, time.perf_counter() - t0


def timed_passes(name: str, searcher, data: Dict, passes: int):
    """`passes` passes on the host clock after the caller's warm-up: (the
    last pass's ids, the walls in seconds, the kernels they launched);
    the ids' rows must be readable by their users."""
    q, uids, k = data["queries"], data["uids"], data["k"]
    masks = data["world"].user_masks
    before = evidence.launch_counts()
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        _, ids = searcher.search_batch(q, uids, masks, k)
        walls.append(time.perf_counter() - t0)
    launches = evidence.launches_since(before)
    evidence.readable_or_raise(name, ids, masks[uids],
                               data["arena"].host_bits)
    return ids, walls, launches


def measure(name: str, searcher, data: Dict, build_s: float) -> Dict:
    """The script's measurement: a warm pass, 5 timed passes (median)."""
    q, uids, k = data["queries"], data["uids"], data["k"]
    searcher.search_batch(q, uids, data["world"].user_masks, k)
    ids, walls, launches = timed_passes(name, searcher, data, 5)
    wall = float(np.median(walls))
    rep = searcher.storage_report()
    return {
        f"recall_at_{k}": round(compute_recall(ids, data["truth"]), 4),
        "qps": round(len(q) / wall, 1),
        "ms_per_query": round(wall / len(q) * 1000, 3),
        "storage_mb": round(rep["total_mb"], 1),
        "partitions": rep.get("num_partitions", 1),
        "build_s": round(build_s, 1),
        "pass_walls_s": [round(w, 4) for w in walls],
        "kernels": launches,
    }


def protocol(n: int, nq: int) -> Dict:
    return {"n": n, "dim": 128, "queries": nq, "topk": K,
            "world": "tree RBAC 100 roles / 10k users",
            "passes": "1 warm, median of 5 (host clock)",
            "storage_mb": "the port's own bytes (storage_report total_mb)",
            "reference_record": REFERENCE_RECORD + " (taken on a TPU v5e)"}


def run(strategies: Sequence[str], device, n: int = N, nq: int = NQ,
        out: Optional[Dict] = None, checkpoint: Optional[str] = None
        ) -> Dict:
    """The record with the strategies in `strategies` that `out` does not
    hold yet measured and checkpointed one by one."""
    out = out if out is not None else {}
    out.setdefault("protocol", protocol(n, nq))
    out.setdefault("hardware", evidence.hardware(device))
    todo = [s for s in STRATEGIES if s in strategies and s not in out]
    if not todo:
        log("all strategies checkpointed: skip")
        return out
    t0 = time.perf_counter()
    data = make_data(n, nq, K, device)
    log(f"data: {time.perf_counter() - t0:.1f}s")
    for name in todo:
        s, build_s = build(name, data)
        row = measure(name, s, data, build_s)
        row["hardware"] = evidence.hardware(device)
        out[name] = row
        log(f"[{name}] " + json.dumps(row))
        evidence.save_checkpoint(checkpoint, out)
        del s
        free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strategies", nargs="+", choices=STRATEGIES,
                    default=list(STRATEGIES),
                    help="the strategies to run (default all five)")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the strategies measured so far (default "
                         f"{CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device, "bench.strategy_compare")
    if device is None:
        return 2
    out = evidence.load_checkpoint(args.checkpoint) or {}
    if out:
        log(f"resuming: {[s for s in STRATEGIES if s in out]} checkpointed")
    out["hardware"] = evidence.hardware(device)
    out = run(args.strategies, device, out=out, checkpoint=args.checkpoint)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
