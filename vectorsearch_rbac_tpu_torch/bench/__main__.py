"""Benchmark entry of the port: RBAC-filtered vector search QPS on one GPU.

    python -m vectorsearch_rbac_tpu_torch.bench [--smoke] [--queries N] ...

The counterpart of the repository's bench.py, with the same flags, the
same defaults and the same single JSON line on stdout:
  {"metric": ..., "value": N, "unit": "qps", "vs_baseline": N}
The port serves --strategy rls, role, user, dynamic (AnonySys, the
planner at cfg.optimizer's defaults) and qdtree (built as bench.py builds
it: no workload, so the tree samples the first 64 role combinations and
routes by the margin rule) over --dataset sift1m, sift10m (the
SIFT-like twin at --n 10000000), cohere or synthetic,
--metric l2, ip, cosine or l1 (l1 not on --dtype int8, as bench.py) and
--dtype int8, bfloat16 or float32, with --index flat_approx, flat, ivf,
binary or hnsw (the partitioned strategies' flat kinds take the
TiledSearcher on an int8 l2 arena and the PackedSearcher on any other;
ivf builds an IVFIndex a partition, binary a BinaryQuantIndex, hnsw an
HNSW graph over the arena (rls) or a partition, the IVF-assisted kNN
above 200,000 rows). Only l1 on the int8 arena is refused, with the
reference's reason. It needs a CUDA device and exits non-zero without one.

Scenario: by default a SIFT1M-shaped corpus (1M x 128-d, 100 blocks/doc);
with --dataset cohere the cohere-like 1M x 768 unit-normalized corpus,
served through the wide scan kernel and the float32 rerank tier
(`--dataset cohere --metric cosine --queries 16384` is the reference's
768-d headline). Tree RBAC (100 roles, 10k users), 32,768 queries,
top-100. The exact float32 oracle runs on the card first, on its own
arena, which is freed before the int8 serving arena is built; recall must
stay >= 0.95 for the headline number to count.
"""

import argparse
import gc
import json
import sys
import time

import numpy as np

BASELINE_QPS = 1000.0 / 0.118  # ~8474 QPS, physical role partition, CPU
PORTED = {"strategy": ("rls", "role", "user", "dynamic", "qdtree"),
          "index": ("flat", "flat_approx", "ivf", "hnsw", "binary"),
          "dtype": ("int8", "bfloat16", "float32"),
          "dataset": ("sift1m", "sift10m", "cohere", "synthetic"),
          "metric": ("l2", "ip", "cosine", "l1")}


def refusal(args):
    """Why the port cannot serve these flags, or None."""
    off = {f: getattr(args, f) for f, v in PORTED.items()
           if getattr(args, f) not in v}
    if off:
        return (f"not ported: {off}; the port serves "
                + " ".join(f"--{f} {'|'.join(v)}" for f, v in PORTED.items()))
    if args.metric == "l1" and args.dtype == "int8":
        return ("--metric l1 --dtype int8: l1 cannot ride the int8 path (it "
                "has no dot-product form); use --dtype float32 or bfloat16")
    return None


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m vectorsearch_rbac_tpu_torch.bench")
    ap.add_argument("--smoke", action="store_true", help="tiny fast run")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--strategy", default="rls",
                    choices=["rls", "role", "user", "dynamic", "qdtree"])
    ap.add_argument("--index", default="flat_approx",
                    choices=["flat", "flat_approx", "ivf", "hnsw", "binary"])
    ap.add_argument("--dtype", default="int8")
    ap.add_argument("--block-rows", type=int, default=131072)
    ap.add_argument("--dataset", default="sift1m",
                    choices=["sift1m", "sift10m", "cohere", "synthetic"])
    ap.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "cosine", "l1"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0,
                    help="serving query batch (0 = strategy default)")
    ap.add_argument("--wire", default="",
                    choices=["", "ids", "u8", "bf16", "f32"],
                    help="the rls index's result wire: ids, u8, bf16 or f32 "
                         "(default: 'ids' for rls; 'u8' otherwise, which "
                         "partition tiers never read: they carry f32 "
                         "distances)")
    ap.add_argument("--per-query", default="",
                    help="write per-query JSON records to this path")
    args = ap.parse_args(argv)
    why = refusal(args)
    if why:
        ap.error(why)
    if args.smoke:
        args.n = min(args.n, 100_000)
        args.queries = min(args.queries, 256)
    return args


def main(argv=None):
    args = parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the GPU port and does "
            "not run on the CPU")
        return 2

    from vectorsearch_rbac_tpu_torch.bench import (
        GroundTruthOracle, compute_truth_sample, make_scenario, run_benchmark,
        serving_config)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    device = torch.device("cuda", 0)
    log(f"device: {torch.cuda.get_device_name(device)}")

    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(
        n=args.n, num_queries=args.queries, topk=args.topk, seed=args.seed,
        dataset=args.dataset)
    log(f"corpus: {corpus.n} x {corpus.dim} ({corpus.num_docs} docs), "
        f"world: {world.num_roles} roles, {len(world.combs)} combs, "
        f"{workload.num_queries} queries in {time.perf_counter() - t0:.1f}s")
    cfg = serving_config(seed=args.seed, block_rows=args.block_rows,
                         batch=args.batch, topk=args.topk, wire=args.wire,
                         index=args.index, dtype=args.dtype,
                         strategy=args.strategy)

    # phase A: exact ground truth on the float32 oracle arena, then free it
    gt_rows = min(args.block_rows, 65536)
    t0 = time.perf_counter()
    gt_arena = build_device_arena(corpus, world, device=device,
                                  block_rows=gt_rows, dtype="float32",
                                  metric=args.metric)
    oracle = GroundTruthOracle(gt_arena, cache_dir="artifacts",
                               block_rows=gt_rows, query_batch=1024)
    truth = compute_truth_sample(oracle, corpus, world, workload, args.topk,
                                 recall_sample=None)
    log(f"ground truth ({len(truth)} queries, exact): "
        f"{time.perf_counter() - t0:.1f}s")
    del oracle, gt_arena
    gc.collect()
    torch.cuda.empty_cache()

    # phase B: the serving arena
    t0 = time.perf_counter()
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=args.block_rows, dtype=args.dtype,
                               metric=args.metric)
    build_s = time.perf_counter() - t0
    log(f"arena upload: {build_s:.2f}s ({arena.n_padded} rows)")
    t0 = time.perf_counter()
    searcher = build_searcher(args.strategy, corpus, world, arena, cfg)
    strat_build_s = time.perf_counter() - t0
    log(f"strategy '{args.strategy}' build: {strat_build_s:.2f}s")

    res = run_benchmark(searcher, corpus, world, workload, None,
                        k=args.topk, warmup_runs=2,
                        timed_batches=8 if args.smoke else 256,
                        build_time_s=build_s + strat_build_s,
                        recall_sample=None, truth=truth,
                        per_query_path=args.per_query or None)
    log(res.to_json())
    log("DETAIL " + json.dumps({
        "recall": res.avg_recall, "qps": res.qps,
        "avg_ms": res.avg_query_time_ms, "p95_ms": res.p95_ms,
        "storage_mb": res.storage["total_mb"],
        "build_s_per_1m": (build_s + strat_build_s)
        * (1_000_000 / max(corpus.n, 1)),
        "strategy": args.strategy, "index": args.index, "n": corpus.n,
        "n_padded": arena.n_padded, "truth_max_id": int(truth.max()),
        "truth_ids_past_2^23": float(np.mean(truth >= 1 << 23)),
        "device": res.extra["device"],
    }))

    ok = res.avg_recall >= 0.95
    print(json.dumps({
        "metric": (f"qps_per_chip_at_recall0.95_rbac_filtered_"
                   f"{args.dataset}_{args.metric}_n{corpus.n}_top{args.topk}"
                   if (args.dataset, args.metric, corpus.n, args.topk)
                   != ("sift1m", "l2", 1_000_000, 100)
                   else "qps_per_chip_at_recall0.95_rbac_filtered_sift1m_top100"),
        "value": round(res.qps, 1) if ok else 0.0,
        "unit": "qps",
        "vs_baseline": round(res.qps / BASELINE_QPS, 2) if ok else 0.0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
