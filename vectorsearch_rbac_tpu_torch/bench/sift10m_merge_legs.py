"""The int8 flat path's merges and wires at 10M on the card.

    python -m vectorsearch_rbac_tpu_torch.bench.sift10m_merge_legs
        [--legs pallas_ids pallas_u8 cascade_u8] [--checkpoint PATH]
        [--device cuda|cpu]

The port's runner for scripts/sift10m_r4.py, at its sizes and protocol:
sift_like_corpus(10,000,000 x 128, 100 blocks a document, seed 0), the
tree world of 100 roles and 10,000 users (h 4, b0 3, b1 4, seed 0),
8,192 queries from the held-out pool (zipf 0, seed 1), top-100, l2. The
truth of the first 1,024 queries comes from the exact float32 oracle on
an arena of its own (65,536-row blocks, query batch 512), freed before
serving; serving uses the int8 arena of 131,072-row blocks. Three legs,
each Int8FlatIndex(query_batch 2048, q_tile 2048, wire, merge), under
the record's names:

    pallas_ids   merge "kernel" (the reference's "pallas")   wire ids
    pallas_u8    merge "kernel"                              wire u8
    cascade_u8   merge "cascade"                             wire u8

Each leg searches 2,048 queries, then all 8,192 (the script's two
warm-ups), then 5 passes on the host clock (each ends in its results on
the host), QPS from the median. A leg gives the record's keys (merge,
with the port's name, wire, recall_at_100 on the 1,024-query sample, qps,
pass_walls_ms) and the kernels its timed passes launched; every returned
row must be readable by its user.

Each leg is checkpointed to --checkpoint (state/sift10m_merge_legs.json)
as it is measured, and a rerun skips the measured ones; --legs splits the
run across calls (the set-up is the call's longest part). Prints one JSON
line: the script's keys ("config", "legs"), "protocol" (naming the TPU
record results/sift10m_r4.json) and "hardware" (the card's nvidia-smi
name and power limit). Exits 2 without CUDA unless given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..data import sift_like_corpus
from ..index.flat_int8 import Int8FlatIndex
from . import evidence
from .evidence import free, log
from .ground_truth import compute_recall

N, NQ, K, NS = 10_000_000, 8192, 100, 1024
# leg -> (merge, wire)
LEGS = {"pallas_ids": ("kernel", "ids"),
        "pallas_u8": ("kernel", "u8"),
        "cascade_u8": ("cascade", "u8")}
REFERENCE_RECORD = "results/sift10m_r4.json"
CHECKPOINT = os.path.join("state", "sift10m_merge_legs.json")
CONFIG = ("10M x 128 sift-like, tree RBAC 100 roles, 8192 queries, top-100; "
          "merge + wire legs on one corpus/truth")


def make_data(n: int, nq: int, ns: int, device) -> Dict:
    """The script's set-up (evidence.scene) over sift_like_corpus(n), the
    truth of the first `ns` queries (oracle query batch 512)."""
    corpus, qpool = sift_like_corpus(num_vectors=n, blocks_per_doc=100,
                                     seed=0)
    return evidence.scene(corpus, qpool, nq, K, device, ns=ns,
                          oracle_batch=512)


def make_index(arena, leg: str) -> Int8FlatIndex:
    merge, wire = LEGS[leg]
    return Int8FlatIndex(arena, None, query_batch=2048, q_tile=2048,
                         wire=wire, merge=merge)


def measure(leg: str, data: Dict, passes: int = 5) -> Dict:
    """The script's protocol for one leg."""
    q, masks = data["queries"], data["masks"]
    idx = make_index(data["arena"], leg)
    idx.search(q[:2048], masks[:2048], K)
    idx.search(q, masks, K)
    before = evidence.launch_counts()
    walls = []
    for _ in range(passes):
        t0 = time.perf_counter()
        _, ids = idx.search(q, masks, K)
        walls.append(time.perf_counter() - t0)
    launches = evidence.launches_since(before)
    evidence.readable_or_raise(leg, ids, masks, data["arena"].host_bits)
    merge, wire = LEGS[leg]
    rec = compute_recall(ids[:data["ns"]], data["truth"])
    return {"merge": merge, "wire": wire,
            "recall_at_100": round(float(rec), 4),
            "qps": round(len(q) / float(np.median(walls)), 1),
            "pass_walls_ms": [round(w * 1000, 1) for w in walls],
            "kernels": launches}


def protocol(n: int, nq: int, ns: int) -> Dict:
    return {"n": n, "dim": 128, "queries": nq, "recall_sample": ns,
            "topk": K, "passes": "2 warm-up searches, median of 5",
            "merge_names": "the port's 'kernel' is the reference's 'pallas'",
            "reference_record": REFERENCE_RECORD + " (taken on a TPU v5e)"}


def run(legs: Sequence[str], device, n: int = N, nq: int = NQ,
        ns: int = NS, out: Optional[Dict] = None,
        checkpoint: Optional[str] = None) -> Dict:
    """The record with the legs in `legs` that `out` does not hold yet
    measured and checkpointed one by one."""
    out = out if out is not None else {}
    out.setdefault("config", CONFIG)
    out.setdefault("protocol", protocol(n, nq, ns))
    out.setdefault("hardware", evidence.hardware(device))
    done = out.setdefault("legs", {})
    todo = [leg for leg in LEGS if leg in legs and leg not in done]
    if not todo:
        log("all legs checkpointed: skip")
        return out
    t0 = time.perf_counter()
    data = make_data(n, nq, ns, device)
    log(f"data: {time.perf_counter() - t0:.1f}s")
    for leg in todo:
        row = measure(leg, data)
        row["hardware"] = evidence.hardware(device)
        done[leg] = row
        log(f"[{leg}] " + json.dumps(row))
        evidence.save_checkpoint(checkpoint, out)
        free(device)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", nargs="+", choices=tuple(LEGS),
                    default=list(LEGS), help="the legs to run (default all)")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the legs measured so far (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device,
                                     "bench.sift10m_merge_legs")
    if device is None:
        return 2
    out = evidence.load_checkpoint(args.checkpoint) or {}
    if out.get("legs"):
        log(f"resuming: {sorted(out['legs'])} checkpointed")
    out["hardware"] = evidence.hardware(device)
    out = run(args.legs, device, out=out, checkpoint=args.checkpoint)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
