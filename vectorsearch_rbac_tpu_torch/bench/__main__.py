"""Benchmark entry of the port: RBAC-filtered vector search QPS on one GPU.

    python -m vectorsearch_rbac_tpu_torch.bench [--smoke] [--queries N] ...

The counterpart of the repository's bench.py, with the same flags, the
same defaults and the same single JSON line on stdout:
  {"metric": ..., "value": N, "unit": "qps", "vs_baseline": N}
The port serves one combination so far, bench.py's default:
--strategy rls --index flat_approx --dtype int8 --metric l2; any other
combination is refused. It needs a CUDA device and exits non-zero
without one.

Scenario: SIFT1M-shaped corpus (1M x 128-d, 100 blocks/doc), tree RBAC
(100 roles, 10k users), 32,768 queries, top-100. The exact float32
oracle runs on the card first, on its own arena, which is freed before
the int8 serving arena is built; recall must stay >= 0.95 for the
headline number to count.
"""

import argparse
import gc
import json
import sys
import time

BASELINE_QPS = 1000.0 / 0.118  # ~8474 QPS, physical role partition, CPU
PORTED = {"strategy": "rls", "index": "flat_approx", "dtype": "int8",
          "metric": "l2"}


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
                    help="result wire coding (default: 'ids' for rls)")
    ap.add_argument("--per-query", default="",
                    help="write per-query JSON records to this path")
    args = ap.parse_args(argv)
    off = {f: getattr(args, f) for f, v in PORTED.items()
           if getattr(args, f) != v}
    if off:
        ap.error(f"not ported: {off}; the port serves "
                 + " ".join(f"--{f} {v}" for f, v in PORTED.items()))
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
                         batch=args.batch or 2048, topk=args.topk,
                         wire=args.wire or "ids", index=args.index,
                         dtype=args.dtype)

    # phase A: exact ground truth on the float32 oracle arena, then free it
    gt_rows = min(args.block_rows, 65536)
    t0 = time.perf_counter()
    gt_arena = build_device_arena(corpus, world, device=device,
                                  block_rows=gt_rows, dtype="float32")
    oracle = GroundTruthOracle(gt_arena, cache_dir="artifacts",
                               block_rows=gt_rows, query_batch=1024)
    truth = compute_truth_sample(oracle, corpus, world, workload, args.topk,
                                 recall_sample=None)
    log(f"ground truth ({len(truth)} queries, exact): "
        f"{time.perf_counter() - t0:.1f}s")
    del oracle, gt_arena
    gc.collect()
    torch.cuda.empty_cache()

    # phase B: the int8 serving arena
    t0 = time.perf_counter()
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=args.block_rows, dtype=args.dtype)
    build_s = time.perf_counter() - t0
    log(f"arena upload: {build_s:.2f}s ({arena.n_padded} rows)")
    t0 = time.perf_counter()
    searcher = build_searcher(args.strategy, corpus, world, arena, cfg)
    strat_build_s = time.perf_counter() - t0

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
