"""The binary-quantized index at 1M on the card: pgvector's
bit(d)/binary_quantize recipe on RBAC-filtered corpora.

    python -m vectorsearch_rbac_tpu_torch.bench.binary_1m
        [--legs sift128_l2 cohere768_cosine] [--mults M [M ...]]
        [--checkpoint PATH] [--device cuda|cpu]

The port's runner for scripts/binary_1m.py (run_leg :215-276, main
:279-305), both legs as written: "sift128_l2", the 1M SIFT twin
(resolve_dataset("sift1m"), seed 0) in l2 at rerank multipliers 4 and
16, and "cohere768_cosine", the 1M x 768 cohere twin
(resolve_dataset("cohere"), seed 0) in cosine at 2 and 4; --mults sets
the 768-d leg's multipliers (item 12's sweep is --mults 2 4 8). Each leg:
the tree world (10,000 users, 100 roles, h 4, b0 3, b1 4, seed 0), 8,192
queries from the pool (zipf 0, seed 1), of which the first 2,048 are
graded against the exact float32 oracle (its own arena, freed before
serving); a bfloat16 arena of 32,768-row blocks and, for each
multiplier, BinaryQuantIndex(block_rows 32768, query_batch 512, rerank
on): median sign bits, the SWAR popcount scan keeping multiplier x 100
hamming candidates, the rerank from the arena. One warm pass of 512
queries, then 3 passes of all 8,192 on the host clock (each ends in its
copy to the host); QPS from the fastest. Every returned row must be
readable by its user. No CUDA kernel of the port is on this path. The
script's mode="approx" (approx_min_k over the bit distances) is not
carried: the port's bit scan keeps the exact candidates.

Each (leg, multiplier) is checkpointed to --checkpoint
(state/binary_1m.json), and a rerun skips the measured ones (a leg whose
multipliers are all measured builds nothing); --legs runs some legs only.
Prints one JSON line: the keys of the script's record ("config",
"hardware" holding the card's nvidia-smi name and power limit, "legs").
Exits 2 without CUDA unless given --device cpu.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core import build_device_arena
from ..data import resolve_dataset
from ..index.binary import BinaryQuantIndex
from ..rbac import TreeRBACGenerator
from . import evidence
from .ground_truth import GroundTruthOracle
from .queries import QueryWorkload, generate_query_workload

N, NQ, K, NS = 1_000_000, 8192, 100, 2048
# leg -> (dataset, metric, rerank multipliers)
LEGS = {"sift128_l2": ("sift1m", "l2", (4, 16)),
        "cohere768_cosine": ("cohere", "cosine", (2, 4))}
CONFIG = ("binary_quantize + shared-arena rerank (pgvector bit recipe): "
          "median-threshold sign bits, exact hamming candidates "
          f"(rerank_mult*k wide), bf16 rerank; {NQ} queries, top-{K}, tree "
          "RBAC 100 roles")
CHECKPOINT = os.path.join("state", "binary_1m.json")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_index(arena, mult: int) -> BinaryQuantIndex:
    return BinaryQuantIndex(arena, None, block_rows=32768, query_batch=512,
                            rerank=True, rerank_mult=mult)


def leg_world(corpus):
    return TreeRBACGenerator(num_users=10_000, num_roles=100,
                             num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                             seed=0).generate()


def run_leg(corpus, query_pool, metric: str, nq: int, k: int, ns: int,
            mults: Sequence[int], device, leg: str = "",
            rows: Optional[Dict] = None,
            checkpoint: Optional[str] = None, out: Optional[Dict] = None
            ) -> Dict:
    """The leg's rows ({"mult<m>": row}) for the multipliers not yet in
    `rows`, each checkpointed with `out` as it is measured."""
    rows = {} if rows is None else rows
    todo = [m for m in mults if f"mult{m}" not in rows]
    if not todo:
        log(f"[{leg}] all multipliers checkpointed: skip")
        return rows
    world = leg_world(corpus)
    workload = generate_query_workload(corpus, world, num_queries=nq,
                                       topk=k, zipf_param=0,
                                       query_pool=query_pool, seed=1)
    sub = QueryWorkload(vectors=workload.vectors[:ns],
                        user_ids=workload.user_ids[:ns], topk=k,
                        selectivities=workload.selectivities[:ns],
                        repetitions=workload.repetitions[:ns])
    gt_arena = build_device_arena(corpus, world, device=device,
                                  block_rows=65536, dtype="float32",
                                  metric=metric)
    t0 = time.perf_counter()
    truth = GroundTruthOracle(gt_arena, block_rows=65536,
                              query_batch=1024).compute(corpus, world, sub, k)
    log(f"[{leg}] ground truth: {time.perf_counter() - t0:.1f}s")
    del gt_arena
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    arena = build_device_arena(corpus, world, device=device,
                               block_rows=32768, dtype="bfloat16",
                               metric=metric)
    masks = world.user_masks[workload.user_ids].astype(np.uint32)
    for mult in todo:
        t0 = time.perf_counter()
        idx = make_index(arena, mult)
        build_s = time.perf_counter() - t0
        idx.search(workload.vectors[:512], masks[:512], k)  # warm
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            d, ids = idx.search(workload.vectors, masks, k)
            walls.append(time.perf_counter() - t0)
        evidence.readable_or_raise(f"binary {leg} x{mult}", ids, masks,
                                   arena.host_bits)
        wall = min(walls)
        hits = tot = 0
        for qi in range(ns):
            ref = set(int(r) for r in truth[qi] if r >= 0)
            got = set(int(r) for r in ids[qi] if r >= 0)
            hits += len(ref & got)
            tot += len(ref)
        st = idx.storage_bytes()
        row = {"rerank_mult": mult,
               "recall_at_100": round(hits / max(tot, 1), 4),
               "qps": round(nq / wall, 1),
               "pass_walls_s": [round(w, 3) for w in walls],
               "build_s": round(build_s, 1),
               "bits_mb": round(idx._bits.numel() * 4 / 1e6, 1),
               "index_mb": round(st["index"] / 1e6, 1),
               "vector_copy_mb": st["vectors"] / 1e6}
        rows[f"mult{mult}"] = row
        log(f"[{leg}] " + json.dumps(row))
        if out is not None:
            out["legs"][leg] = rows
            evidence.save_checkpoint(checkpoint, out)
        del idx
        gc.collect()
    del arena
    gc.collect()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--legs", nargs="+", choices=tuple(LEGS),
                    default=list(LEGS), help="the legs to run (default both)")
    ap.add_argument("--mults", type=int, nargs="+", default=None,
                    help="the 768-d leg's rerank multipliers (default 2 4)")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the rows measured so far (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device, "bench.binary_1m")
    if device is None:
        return 2
    out = {"config": CONFIG, "hardware": evidence.hardware(device),
           "legs": {}}
    prev = evidence.load_checkpoint(args.checkpoint)
    if prev:
        out["legs"] = prev.get("legs", {})
        log(f"resuming: {sum(map(len, out['legs'].values()))} rows "
            "checkpointed")
    for leg in args.legs:
        dataset, metric, mults = LEGS[leg]
        if leg == "cohere768_cosine" and args.mults:
            mults = tuple(args.mults)
        if all(f"mult{m}" in out["legs"].get(leg, {}) for m in mults):
            log(f"[{leg}] all multipliers checkpointed: skip")
            continue
        corpus, qpool = resolve_dataset(dataset, num_vectors=N, seed=0)
        out["legs"][leg] = run_leg(corpus, qpool, metric, NQ, K, NS, mults,
                                   device, leg, out["legs"].get(leg),
                                   args.checkpoint, out)
        del corpus, qpool
        gc.collect()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
