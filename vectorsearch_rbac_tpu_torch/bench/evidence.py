"""What the bench's runners share: the --device flag, the card's
nvidia-smi line, the checkpoint under state/ and the permission check.

The evidence runners (bench.graph_crossover, bench.model_validation,
bench.ivf_coverage and bench.binary_1m, the port's counterparts of the
scripts whose records the planner's rules rest on) and the result
runners (bench.strategy_compare, bench.anonysys_executors,
bench.qdtree_sweeps, bench.cohere_rerank_legs, bench.sift10m_merge_legs)
take --device (default cuda) and exit 2 without a card unless given
--device cpu; nothing falls back to the CPU quietly. A CPU run prints
"cpu" where a card run prints the card's name and power limit, so that
its times are never read as the card's. bench.online, bench.serving,
bench.cold_start and bench.anonysys_10m print card() and check rows with
readable_or_raise too. scene() is the result runners' shared set-up.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to run (default cuda; cpu only when asked)")


def resolve_device(name: str, runner: str) -> Optional[torch.device]:
    """cuda:0, or the CPU when asked for; None (after saying why) where
    CUDA was asked for and there is none."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print(f"{runner} measures the card: no CUDA device (pass --device "
              "cpu to run on the CPU)", file=sys.stderr)
        return None
    return torch.device("cuda", 0)


def hardware(device: torch.device) -> str:
    """card() on the card, "cpu" on the CPU."""
    return card() if device.type == "cuda" else "cpu"


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def load_checkpoint(path: str) -> Optional[dict]:
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def save_checkpoint(path: str, record: dict) -> None:
    """Write the record whole (a crash mid-write keeps the last one)."""
    if not path:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)


def readable_or_raise(name: str, ids: np.ndarray, masks: np.ndarray,
                      row_bits: np.ndarray) -> None:
    """Every returned arena row (ids >= 0) shares a role with its query's
    mask row."""
    ids = np.asarray(ids)
    ok = ((row_bits[np.maximum(ids, 0)]
           & np.asarray(masks, np.uint32)[:, None, :]).any(2) | (ids < 0))
    if not ok.all():
        raise RuntimeError(f"{name}: {int((~ok).sum())} returned rows are "
                           "not readable by their users")


def launches_since(before: dict) -> dict:
    """The kernel launches counted since `before` (a copy of
    ops._build.LAUNCHES), by kernel."""
    from ..ops import _build

    return {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()
            if v - before.get(k, 0)}


def launch_counts() -> dict:
    from ..ops import _build

    return dict(_build.LAUNCHES)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def scene(corpus, query_pool, nq: int, k: int, device,
          ns: Optional[int] = None, metric: str = "l2",
          oracle_batch: int = 1024) -> Dict:
    """The result scripts' set-up over their corpus: the tree world of 100
    roles and 10,000 users (h 4, b0 3, b1 4, seed 0), nq queries from the
    pool (zipf 0, seed 1), the exact top-k truth of the first ns (default
    all) from a float32 arena of its own (65,536-row blocks), freed before
    the int8 serving arena of 131,072-row blocks is built."""
    from ..core import build_device_arena
    from ..rbac import TreeRBACGenerator
    from .ground_truth import GroundTruthOracle
    from .queries import QueryWorkload, generate_query_workload

    ns = nq if ns is None else ns
    world = TreeRBACGenerator(num_users=10_000, num_roles=100,
                              num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                              seed=0).generate()
    wl = generate_query_workload(corpus, world, num_queries=nq, topk=k,
                                 zipf_param=0, query_pool=query_pool, seed=1)
    queries = wl.vectors.astype(np.float32)
    sub = QueryWorkload(vectors=queries[:ns], user_ids=wl.user_ids[:ns],
                        topk=k, selectivities=wl.selectivities[:ns],
                        repetitions=wl.repetitions[:ns])
    gt = build_device_arena(corpus, world, device=device, block_rows=65536,
                            dtype="float32", metric=metric)
    truth = GroundTruthOracle(gt, block_rows=65536,
                              query_batch=oracle_batch).compute(
        corpus, world, sub, k)
    del gt
    free(device)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=131072, dtype="int8", metric=metric)
    return dict(corpus=corpus, world=world, workload=wl, queries=queries,
                uids=wl.user_ids, masks=np.ascontiguousarray(
                    world.user_masks[wl.user_ids], np.uint32),
                truth=truth, arena=arena, k=k, ns=ns)
