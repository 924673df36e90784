"""Closed-loop serving sweep on the card: clients against the
micro-batching window, through the BatchingServer.

    python -m vectorsearch_rbac_tpu_torch.bench.serving

The port's runner for scripts/serving_load_1m_r5.py: the SIFT-like corpus
(sift_like_corpus(1,000,000 x 128, 100 blocks a document, seed 0)), the
bench's tree world (100 roles, 10,000 users), rls over flat_approx on the
int8 arena (block_rows 131072, FrameworkConfig's defaults otherwise),
top-10. Each level runs C client threads for a window of 15 s; a client
submits one query at a time (a held-out pool vector and a uniform user,
from its own default_rng) and waits for it. The levels: C in {64, 256,
512, 1024} at max_wait_ms 3, 10 and 25, C 2048 at 10 and 25, and C 1, 4
and 16 at 3 (beside the reference's round-4 record). Every served row is
checked readable by its user.

Prints a line a level (QPS, p50/p95/p99 ms, the average device batch,
dispatches) and one JSON line: the levels, the knee at each window (the
first level past which QPS gains less than 5% while p99 grows), and the
card's nvidia-smi name and power limit. Exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

K = 10
WINDOW_S = 15.0
CELLS = ([(c, 3.0) for c in (1, 4, 16)]
         + [(c, w) for w in (3.0, 10.0, 25.0) for c in (64, 256, 512, 1024)]
         + [(2048, 10.0), (2048, 25.0)])


def knees(levels: Sequence[Dict]) -> Dict[str, int]:
    """max_wait_ms -> the clients of the first level past which QPS gains
    less than 5% while p99 grows (None where the ladder never bends)."""
    out = {}
    for w in sorted({lv["max_wait_ms"] for lv in levels}):
        ladder = sorted((lv for lv in levels if lv["max_wait_ms"] == w),
                        key=lambda lv: lv["clients"])
        out[str(w)] = next(
            (a["clients"] for a, b in zip(ladder, ladder[1:])
             if b["qps"] < 1.05 * a["qps"] and b["p99_ms"] > a["p99_ms"]),
            None)
    return out


def level(searcher, world, pool: np.ndarray, clients: int, wait_ms: float,
          window_s: float) -> Tuple[Dict, np.ndarray, np.ndarray]:
    """One closed-loop level: (its report, the served users, their row
    ids)."""
    from ..serving import BatchingServer, closed_loop

    def draw(r):
        return pool[r.integers(0, len(pool))], int(r.integers(
            0, world.num_users))

    with BatchingServer(searcher, world.user_masks, max_batch=2048,
                        max_wait_ms=wait_ms) as srv:
        rep, served = closed_loop(srv, draw, K, clients, window_s,
                                  seed0=1000 + clients * 7)
    rep.pop("wall_s")
    row = {"clients": clients, "max_wait_ms": wait_ms, **rep}
    users = np.asarray([u for u, _ in served], dtype=np.int64)
    ids = np.stack([i for _, i in served]).astype(np.int64)
    return row, users, ids


def run(device, n: int = 1_000_000, window_s: float = WINDOW_S,
        cells: Sequence[Tuple[int, float]] = CELLS) -> Dict:
    from ..config import FrameworkConfig
    from ..core import build_device_arena
    from ..data import sift_like_corpus
    from ..partition import build_searcher
    from ..rbac import TreeRBACGenerator
    from .evidence import readable_or_raise

    corpus, pool = sift_like_corpus(num_vectors=n, seed=0)
    world = TreeRBACGenerator(num_users=10_000, num_roles=100,
                              num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                              seed=0).generate()
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=131072, dtype="int8")
    cfg = FrameworkConfig()
    cfg.search.block_rows = 131072
    cfg.index.kind = "flat_approx"
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    rng = np.random.default_rng(1)
    searcher.search_batch(pool[rng.choice(len(pool), 2048)],
                          rng.integers(0, world.num_users, 2048),
                          world.user_masks, K)   # warm
    report: Dict = {"n": n, "k": K, "window_s": window_s, "levels": []}
    for clients, wait_ms in cells:
        row, users, ids = level(searcher, world, pool, clients, wait_ms,
                                window_s)
        readable_or_raise(f"C={clients} wait={wait_ms}", ids,
                          world.user_masks[users], arena.host_bits)
        report["levels"].append(row)
        print(f"C={clients:4d} wait={wait_ms:4.0f}ms: {row['qps']:10.1f} QPS"
              f"  p50 {row['p50_ms']:7.2f}  p95 {row['p95_ms']:7.2f}  p99 "
              f"{row['p99_ms']:7.2f} ms  avg_batch {row['avg_batch']:.1f}"
              f"  dispatches {row['dispatches']}", file=sys.stderr,
              flush=True)
    report["knee_clients"] = knees(report["levels"])
    return report


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]
                            ).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench.serving measures the card: no CUDA device",
              file=sys.stderr)
        return 2
    from .evidence import card

    report = run(torch.device("cuda", 0))
    report["card"] = card()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
