"""The 768-d cosine flat path's rerank and wire legs at 1M on the card.

    python -m vectorsearch_rbac_tpu_torch.bench.cohere_rerank_legs
        [--checkpoint PATH] [--device cuda|cpu]

The port's runner for scripts/cohere_768d_r5.py, at its sizes and
protocol: the cohere-like corpus (resolve_dataset("cohere"), 1,000,000 x
768, seed 0), the tree world of 100 roles and 10,000 users (h 4, b0 3,
b1 4, seed 0), 16,384 queries from the held-out pool (zipf 0, seed 1),
top-100, cosine. The truth of the first 2,048 queries comes from the
exact float32 oracle on a cosine arena of its own (65,536-row blocks,
query batch 1,024), freed before serving; serving uses the int8 cosine
arena of 131,072-row blocks. Five legs, each
Int8FlatIndex(query_batch 2048, q_tile 2048, rerank_mode, wire), named as
the record names them:

    dequant        dequant    u8
    residual_u8    residual   u8
    residual_ids   residual   ids
    residual4_u8   residual4  u8
    residual4_ids  residual4  ids

Each leg searches one batch of 2,048 queries first (the script's
compile), then 5 rounds of one pass a leg, in turns, on the host clock
(each pass ends in its results on the host). A leg gives recall_at_100
(the last pass's, on the first 2,048 queries), qps_median, qps_best,
pass_walls_ms and the kernels its timed passes launched (K2 on every
pass: the wide scan); every returned row must be readable by its user.
Each pass quantizes its queries on the host (ArenaQuant's numpy
quantizers), which a traced 768-d pass showed as most of its wall; the
runner records the walls as they are.

The legs run in turns, so the run is one unit: the record is
checkpointed when it is whole, to --checkpoint
(state/cohere_rerank_legs.json), and a rerun with it there builds
nothing. Prints one JSON line: the script's keys ("config", "legs"),
"protocol" (naming the TPU record results/cohere_768d_1m_r5.json) and
"hardware" (the card's nvidia-smi name and power limit). Exits 2 without
CUDA unless given --device cpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np

from ..data import resolve_dataset
from ..index.flat_int8 import Int8FlatIndex
from . import evidence
from .evidence import log
from .ground_truth import compute_recall

N, NQ, K, NS, REPS = 1_000_000, 16384, 100, 2048, 5
METRIC = "cosine"
# leg -> (rerank_mode, wire)
LEGS = {"dequant": ("dequant", "u8"),
        "residual_u8": ("residual", "u8"),
        "residual_ids": ("residual", "ids"),
        "residual4_u8": ("residual4", "u8"),
        "residual4_ids": ("residual4", "ids")}
REFERENCE_RECORD = "results/cohere_768d_1m_r5.json"
CHECKPOINT = os.path.join("state", "cohere_rerank_legs.json")
CONFIG = ("cohere/wikipedia-shaped 1M x 768-d unit-normalized, tree RBAC 100 "
          "roles, 16384 queries, top-100, cosine; legs INTERLEAVED per round")


def make_data(n: int, nq: int, ns: int, device) -> Dict:
    """The script's set-up (evidence.scene) over the cohere-like corpus,
    cosine, the truth of the first `ns` queries."""
    corpus, qpool = resolve_dataset("cohere", num_vectors=n, seed=0)
    return evidence.scene(corpus, qpool, nq, K, device, ns=ns, metric=METRIC)


def make_index(arena, leg: str) -> Int8FlatIndex:
    mode, wire = LEGS[leg]
    return Int8FlatIndex(arena, None, query_batch=2048, q_tile=2048,
                         wire=wire, rerank_mode=mode)


def run_legs(data: Dict, reps: int = REPS) -> Dict:
    """The script's protocol: each leg compiled on one batch, then `reps`
    rounds of one pass a leg, in turns."""
    q, masks = data["queries"], data["masks"]
    idxs = {}
    for leg in LEGS:
        idxs[leg] = make_index(data["arena"], leg)
        idxs[leg].search(q[:2048], masks[:2048], K)
        log(f"[{leg}] compiled")
    walls = {leg: [] for leg in LEGS}
    launches = {leg: {} for leg in LEGS}
    last = {}
    for rep in range(reps):
        for leg, idx in idxs.items():
            before = evidence.launch_counts()
            t0 = time.perf_counter()
            last[leg] = idx.search(q, masks, K)[1]
            walls[leg].append(time.perf_counter() - t0)
            for name, v in evidence.launches_since(before).items():
                launches[leg][name] = launches[leg].get(name, 0) + v
        log(f"round {rep}: " + "  ".join(
            f"{leg} {walls[leg][-1] * 1000:,.0f}ms" for leg in LEGS))
    out = {}
    for leg, (mode, wire) in LEGS.items():
        evidence.readable_or_raise(leg, last[leg], masks,
                                   data["arena"].host_bits)
        w = walls[leg]
        rec = compute_recall(last[leg][:data["ns"]], data["truth"])
        out[leg] = {"rerank_mode": mode, "wire": wire,
                    "recall_at_100": round(float(rec), 4),
                    "qps_median": round(len(q) / float(np.median(w)), 1),
                    "qps_best": round(len(q) / float(np.min(w)), 1),
                    "pass_walls_ms": [round(x * 1000, 1) for x in w],
                    "kernels": launches[leg]}
    return out


def protocol(n: int, nq: int, ns: int) -> Dict:
    return {"n": n, "dim": 768, "queries": nq, "recall_sample": ns,
            "topk": K, "metric": METRIC,
            "passes": f"1 batch of 2048 a leg, then {REPS} rounds in turns",
            "reference_record": REFERENCE_RECORD + " (taken on a TPU v5e)"}


def run(device, n: int = N, nq: int = NQ, ns: int = NS,
        out: Optional[Dict] = None, checkpoint: Optional[str] = None
        ) -> Dict:
    out = out if out is not None else {}
    out.setdefault("config", CONFIG)
    out.setdefault("protocol", protocol(n, nq, ns))
    out.setdefault("hardware", evidence.hardware(device))
    if all(leg in out.get("legs", {}) for leg in LEGS):
        log("every leg is checkpointed: skip")
        return out
    t0 = time.perf_counter()
    data = make_data(n, nq, ns, device)
    log(f"data: {time.perf_counter() - t0:.1f}s")
    out["legs"] = run_legs(data)
    evidence.save_checkpoint(checkpoint, out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the record once measured (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device,
                                     "bench.cohere_rerank_legs")
    if device is None:
        return 2
    out = evidence.load_checkpoint(args.checkpoint) or {}
    out["hardware"] = evidence.hardware(device)
    out = run(device, out=out, checkpoint=args.checkpoint)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
