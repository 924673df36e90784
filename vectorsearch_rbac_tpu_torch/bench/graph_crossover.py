"""Graph against flat on the card: the crossover grid.

    python -m vectorsearch_rbac_tpu_torch.bench.graph_crossover
        [--n N [N ...]] [--d 128|768] [--big] [--checkpoint PATH]
        [--device cuda|cpu]

The port's runner for scripts/graph_crossover.py: where, if anywhere,
does the HNSW search beat the int8 flat scan on one index of n rows at a
within-index selectivity? Its grid (:10-12, :208-229): d 128 at n
131,072, 262,144, 524,288 and 1,000,000, selectivity 1.0, and at 1M also
0.005, 0.036 and 0.2; d 768 at n 131,072 and 262,144, selectivity 0.036
and 1.0; --big adds 2,000,000 x 128 at 1.0. One world of 4 roles, user u
holding role u alone, role 3 reading every document and roles 2, 1, 0
each document with probability 0.2, 0.036, 0.005 (make_world, :49-58), so
a query's user sets its selectivity. The corpus is sift_like_corpus at d
128 and the script's clustered, integer-quantized 768-d corpus at d 768
(corpus_for, :60-79). Top-10 over 4,096 queries drawn by default_rng(7)
from the pool (measure_case, :81-185):

- the exact float32 oracle on its own arena (TF32 off), freed before the
  serving arena is built;
- flat: Int8FlatIndex(query_batch 2048, q_tile 2048, block_rows 8192,
  group 1 << min(7, max(3, log2(n // 8192))), the script's bf16 result
  wire) with the user table resident: K1 (K2 at d 768), K3 and K4;
- graph: HNSWIndex(m 16, ef_construction 64, ef_search 40, query_batch
  1024, builder "auto": the IVF-assisted kNN above 200,000 rows) through
  the ef ladder 40 / 80 / 160 / 320 from sampled entries with max_steps
  4 ef, stopping at recall >= 0.99, and where the selectivity is at most
  0.2 the 2-hop harvest legs at ef 40 and 80: the fused search, the
  harvest on the step loop (KS6, KS7);
- the graph's point is its fastest leg with recall >= 0.95, else its leg
  of best recall; the winner is the graph where that point is faster
  than flat and holds 0.95.

A pass is timed on the host clock and ends in the copy of its results to
the host: one warm pass, then 3 (flat) or 2 (graph) timed ones. Every
returned row must be readable by its user. --n and --d select grid rows,
so that the grid runs as three calls (d 128 up to 524,288; 1M; d 768).
Each cell is checkpointed to --checkpoint (state/graph_crossover.json) as
it is measured, and a rerun resumes there: measured cells are kept as
they are and their builds skipped (:197-206).

Prints one JSON line: the keys of results/graph_crossover.json and
"hardware" (the card's nvidia-smi name and power limit). Beside the
script's keys, a cell carries the builder "auto" took and the kernels
the flat passes launched, and a ladder leg the kernels it launched (which
says whether the fused search or the step loop ran). Exits 2 without
CUDA unless given --device cpu.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import Corpus, build_device_arena
from ..data import sift_like_corpus
from ..index.flat import FlatIndex
from ..index.flat_int8 import Int8FlatIndex
from ..index.hnsw import HNSWIndex
from ..rbac import RBACWorld
from . import evidence
from .ground_truth import compute_recall

TOPK = 10
NQ = 4096
SELS = {0: 0.005, 1: 0.036, 2: 0.2, 3: 1.0}
EFS = (40, 80, 160, 320)       # the graph's ef ladder
HARVEST_EFS = (40, 80)         # the 2-hop harvest legs, at sel <= 0.2
CONFIG = (f"top-{TOPK}, {NQ} queries, slab-batched HNSW (sampled entries + "
          "iterative rescan) vs fused int8 flat scan; within-index "
          "selectivity via 4-role world")
CHECKPOINT = os.path.join("state", "graph_crossover.json")
# the script's grid: (n, d, corpus seed, world seed, {user: selectivity})
GRID = ([(n, 128, 0, 1, SELS if n == 1_000_000 else {3: 1.0})
         for n in (131072, 262144, 524288, 1_000_000)]
        + [(n, 768, 2, 3, {1: 0.036, 3: 1.0}) for n in (131072, 262144)])
BIG = (2_000_000, 128, 4, 5, {3: 1.0})


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_world(num_docs: int, seed: int) -> RBACWorld:
    rng = np.random.default_rng(seed)
    role_to_docs = {3: frozenset(range(num_docs))}
    for role, p in ((2, 0.2), (1, 0.036), (0, 0.005)):
        role_to_docs[role] = frozenset(
            np.flatnonzero(rng.random(num_docs) < p).tolist())
    return RBACWorld(num_users=4, num_roles=4, num_docs=num_docs,
                     user_to_roles={u: (u,) for u in range(4)},
                     role_to_docs=role_to_docs)


def corpus_for(n: int, d: int, seed: int) -> Tuple[Corpus, np.ndarray]:
    if d == 128:
        return sift_like_corpus(num_vectors=n, blocks_per_doc=100,
                                seed=seed)
    # 768-d: clustered unit-ball corpus, SIFT-style integer quantized so
    # the int8 path is lossless and both engines face identical data
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((256, d)).astype(np.float32) * 0.5
    assign = rng.integers(0, 256, n)
    v = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    v = np.clip(np.rint(v * 24 + 128), 0, 255).astype(np.float32)
    qpool = v[rng.choice(n, 8192, replace=False)] + rng.standard_normal(
        (8192, d)).astype(np.float32) * 2
    qpool = np.clip(np.rint(qpool), 0, 255).astype(np.float32)
    doc_ids = (np.arange(n) // 100).astype(np.int32)
    block_ids = (np.arange(n) % 100).astype(np.int32)
    return Corpus(vectors=v, doc_ids=doc_ids, block_ids=block_ids), qpool


def group_for(n: int) -> int:
    """The flat index's group width at n rows (powers of two only)."""
    return 1 << min(7, max(3, (n // 8192).bit_length() - 1))


def build_engines(corpus: Corpus, world: RBACWorld, device):
    """(int8 arena, flat index, graph, graph build seconds)."""
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=65536, dtype="int8")
    flat = Int8FlatIndex(arena, None, query_batch=2048, q_tile=2048,
                         block_rows=8192, group=group_for(corpus.n),
                         wire="bf16")
    flat.set_user_table(world.user_masks)
    t0 = time.perf_counter()
    graph = HNSWIndex(arena, None, m=16, ef_construction=64, ef_search=40,
                      query_batch=1024)
    return arena, flat, graph, time.perf_counter() - t0


def ladder_legs(sel: float, efs: Sequence[int] = EFS
                ) -> List[Tuple[int, bool]]:
    """(ef, harvest) legs in the order the ladder runs them."""
    legs = [(ef, False) for ef in efs]
    if sel <= 0.2:
        legs += [(ef, True) for ef in HARVEST_EFS]
    return legs


def graph_kwargs(ef: int, harvest: bool) -> Dict:
    """HNSWIndex.search's arguments for a ladder leg."""
    return dict(ef_search=ef, sampled_entry=True, max_steps=4 * ef,
                harvest_2hop=harvest)


def crossover_queries(qpool: np.ndarray, nq: int = NQ) -> np.ndarray:
    rng = np.random.default_rng(7)
    return qpool[rng.choice(len(qpool), nq, replace=False)].astype(
        np.float32)


def _timed(fn: Callable, passes: int):
    """(seconds a pass, the last pass's ids) after one warm pass."""
    fn()
    t = time.perf_counter()
    for _ in range(passes):
        _, ids = fn()
    return (time.perf_counter() - t) / passes, ids


def measure_case(corpus: Corpus, qpool: np.ndarray, world: RBACWorld,
                 sels: Dict[int, float], out: Dict, device,
                 efs: Sequence[int] = EFS, nq: int = NQ,
                 checkpoint: Optional[str] = None, tag: str = "") -> None:
    """Measure the cells (corpus.n, corpus.dim, sel) not yet in
    out["cases"] and append them, checkpointing after each."""
    n, d = corpus.n, corpus.dim
    done = {(c["n"], c["d"], c["selectivity"]) for c in out["cases"]}
    sels = {u: s for u, s in sels.items() if (n, d, s) not in done}
    if not sels:
        log(f"[{tag}] all cells checkpointed: skip")
        return
    queries = crossover_queries(qpool, nq)

    t0 = time.perf_counter()
    gt_arena = build_device_arena(corpus, world, device=device,
                                  block_rows=65536, dtype="float32")
    oracle = FlatIndex(gt_arena, None, block_rows=65536, mode="exact",
                       query_batch=1024)
    truth = {uid: oracle.search(queries, world.user_masks[np.full(nq, uid)],
                                TOPK)[1] for uid in sels}
    del oracle, gt_arena
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[{tag}] ground truth {time.perf_counter() - t0:.1f}s")

    arena, flat, graph, build_s = build_engines(corpus, world, device)
    log(f"[{tag}] hnsw build ({graph.builder}) {build_s:.1f}s")
    for uid, sel in sels.items():
        masks = world.user_masks[np.full(nq, uid)]
        ti = truth[uid]
        before = evidence.launch_counts()
        wall_f, fi = _timed(lambda: flat.search(queries, masks, TOPK), 3)
        flat_kernels = evidence.launches_since(before)
        evidence.readable_or_raise(f"flat n={n} d={d} sel={sel}", fi, masks,
                                   arena.host_bits)
        rec_f = compute_recall(fi, ti)
        ladder = []
        for ef, harv in ladder_legs(sel, efs):
            before = evidence.launch_counts()
            wall_g, gi = _timed(lambda kw=graph_kwargs(ef, harv):
                                   graph.search(queries, masks, TOPK, **kw),
                                   2)
            evidence.readable_or_raise(
                f"graph n={n} d={d} sel={sel} ef={ef} harvest={harv}", gi,
                masks, arena.host_bits)
            rec_g = compute_recall(gi, ti)
            ladder.append({"ef": ef, "harvest": harv,
                           "qps": round(nq / wall_g, 1),
                           "recall": round(rec_g, 4),
                           "kernels": evidence.launches_since(before)})
            if rec_g >= 0.99 and not harv:
                break
        ok = [p for p in ladder if p["recall"] >= 0.95]
        best_g = (max(ok, key=lambda p: p["qps"]) if ok
                  else max(ladder, key=lambda p: p["recall"]))
        row = {
            "n": n, "d": d, "selectivity": sel,
            "flat_qps": round(nq / wall_f, 1),
            "flat_recall": round(rec_f, 4),
            "graph_qps": best_g["qps"],
            "graph_recall": best_g["recall"],
            "graph_ef": best_g["ef"],
            "graph_harvest": best_g["harvest"],
            "graph_ladder": ladder,
            "graph_build_s": round(build_s, 1),
            "winner": "graph" if (best_g["qps"] > nq / wall_f
                                  and best_g["recall"] >= 0.95) else "flat",
            "graph_builder": graph.builder,
            "flat_kernels": flat_kernels,
        }
        out["cases"].append(row)
        log(f"[{tag}] sel={sel}: flat {row['flat_qps']} QPS "
            f"@{row['flat_recall']} | graph {row['graph_qps']} QPS "
            f"@{row['graph_recall']} (ef={row['graph_ef']}) -> "
            f"{row['winner']}; ladder "
            + json.dumps([{k: p[k] for k in ("ef", "harvest", "qps",
                                             "recall")} for p in ladder]))
        evidence.save_checkpoint(checkpoint, out)
    del arena, flat, graph
    gc.collect()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=None,
                    help="only the grid rows of these sizes")
    ap.add_argument("--d", type=int, choices=(128, 768), default=None,
                    help="only the grid rows of this width")
    ap.add_argument("--big", action="store_true",
                    help="include the 2M x 128 point")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the cells measured so far (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device, "bench.graph_crossover")
    if device is None:
        return 2
    out = {"config": CONFIG, "cases": []}
    prev = evidence.load_checkpoint(args.checkpoint)
    if prev:
        out["cases"] = prev.get("cases", [])
        log(f"resuming: {len(out['cases'])} cells checkpointed")
    for n, d, cseed, wseed, sels in GRID + ([BIG] if args.big else []):
        done = {(c["n"], c["d"], c["selectivity"]) for c in out["cases"]}
        if ((args.n and n not in args.n) or (args.d and d != args.d)
                or all((n, d, s) in done for s in sels.values())):
            continue
        corpus, qpool = corpus_for(n, d, seed=cseed)
        world = make_world(corpus.num_docs, seed=wseed)
        measure_case(corpus, qpool, world, sels, out, device,
                     checkpoint=args.checkpoint, tag=f"{n // 1000}k x {d}")
        del corpus, qpool
        gc.collect()
    out["hardware"] = evidence.hardware(device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
