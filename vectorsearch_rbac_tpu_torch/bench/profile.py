"""Where a serving pass spends its time, on the card.

    python -m vectorsearch_rbac_tpu_torch.bench.profile [--n N] [--queries Q]
        [--dataset sift1m|sift10m|cohere|synthetic]
        [--metric l2|ip|cosine|l1]
        [--strategy rls|role|user|dynamic|qdtree]
        [--index flat_approx|flat|ivf|hnsw|hybrid|binary] [--filtered]
        [--dtype int8|bfloat16|float32]
        [--alpha A] [--topk K] [--batch B]

Builds bench's world for the dataset and metric (tree RBAC with 100 roles
and 10k users, an int8, bfloat16 or float32 arena) and the strategy at
bench's
serving configuration, runs two warm passes, times three untraced passes, then
traces one pass with torch.profiler. It prints the untraced and traced
pass walls (their difference is the tracing cost), the spans of the
searcher and index layers with their host time and the device time of
the kernels and copies that ran inside them (nested spans included), the
device time by kernel and copy, and the device's busy and idle share of
the untraced pass (busy = the summed device time of kernels and copies,
which run one after another on the one stream). The spans split a pass:

- rls: flat_int8.dedup, .quantize_upload, .enqueue (per batch .scan,
  .merge, .rerank, .wire) and .fetch_unpack; on a bfloat16 or float32
  arena (the flat index) or with --index binary no span: the pass is the
  index's scan, split by device op;
- role, user, dynamic, qdtree on an int8 l2 arena: tiled.route (host),
  tiled.big_enqueue (the big tier's scans and merges, flat_int8.*
  inside), tiled.chunk_scan (the chunk engine), tiled.big_fetch and
  tiled.merge (the host's fan-out merge);
- the same on any other arena (the PackedSearcher): packed.route (host),
  packed.scan (every bucket's probed scan, enqueue and fetch) and
  packed.merge (the host's fan-out merge);
- --index ivf: partitioned.route, partitioned.enqueue (every IVF index's
  routing and probed scans) and partitioned.merge; rls's one index has no
  span of its own (the pass is its scan);
- --index hnsw (an HNSW graph over the arena or each partition; the
  bench's default search, the fixed-budget beam): per expansion
  graph.beam.expand (pop, neighbour gather, dedup against beam and
  history), graph.beam.score (the candidates' rows and scores) and
  graph.beam.merge (beam and results); with --filtered (rls only) a
  second pass follows, the ACORN filtered traversal, per expansion
  graph.filtered.navigate (the one-hop beam update) and
  graph.filtered.harvest (the 2-hop ring's scores and the result merge);
- dynamic --index hybrid (the hybrid executor: HNSW graphs where the
  combs' selectivity holds, the int8 scan on the remainder):
  partitioned.route, partitioned.enqueue (the flat partitions' scans,
  flat_int8.* inside), partitioned.graph (the graph batcher: graph.search,
  the fused search kernel, one a chunk; on the step loop (the 2-hop
  harvest) per step graph.step, inside it graph.dedup (pop, neighbour
  gather, dedup against beam and history), graph.score (the packed-row
  score kernel) and graph.merge (the merge kernel); graph.drain the host's
  id mapping) and partitioned.merge.

Needs a CUDA device.
"""

import argparse
import sys
import time

SPAN_PREFIXES = ("flat_int8.", "tiled.", "packed.", "partitioned.",
                 "graph.")


def profile_pass(one_pass):
    """Trace one call of one_pass() (which must end in a device sync) ->
    (wall ms, {span: (host ms, device ms)}, [(device ms, count, kernel)]
    sorted by device time, device busy ms). A span's device ms is the
    summed time of the kernels and copies that ran inside its range on
    the device's timeline or inside the range of a span nested in it on
    the host, each counted once (a big tier's flat_int8.scan counts in
    tiled.big_enqueue too). The kernels launched through ctypes belong to
    no torch op, so the range is what ties them to the span that launched
    them; and a span that launches nothing itself, only through nested
    spans, gets no range of its own on the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        wall_ms = (time.perf_counter() - t0) * 1000.0
    spans, host_ranges, ranges, work = {}, [], [], []
    for ev in prof.events():
        named = ev.name.startswith(SPAN_PREFIXES)
        tr = ev.time_range
        if ev.device_type == DeviceType.CPU and named:
            host, dev = spans.get(ev.name, (0.0, 0.0))
            spans[ev.name] = (host + ev.cpu_time_total / 1000.0, dev)
            host_ranges.append((ev.name, tr.start, tr.end))
        elif ev.device_type == DeviceType.CUDA:
            (ranges if named else work).append((ev.name, tr.start, tr.end))
    # span -> itself and every span that ran inside it on the host
    within = {name: {name} for name in spans}
    for outer, s0, e0 in host_ranges:
        within[outer].update(n for n, s, e in host_ranges
                             if s0 <= s and e <= e0)
    for _, start, end in work:
        inside = {n for n, s, e in ranges if s <= start and end <= e}
        for name, names in within.items():
            if inside & names:
                host, dev = spans[name]
                spans[name] = (host, dev + (end - start) / 1000.0)
    rows = [(ev.self_device_time_total / 1000.0, ev.count, ev.key)
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total
            and not ev.key.startswith(SPAN_PREFIXES)]
    rows.sort(reverse=True)
    return wall_ms, spans, rows, sum(r[0] for r in rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vectorsearch_rbac_tpu_torch.bench.profile")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0,
                    help="serving query batch (0 = the strategy's default)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="sift1m",
                    choices=["sift1m", "sift10m", "cohere", "synthetic"])
    ap.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "cosine", "l1"])
    ap.add_argument("--strategy", default="rls",
                    choices=["rls", "role", "user", "dynamic", "qdtree"])
    ap.add_argument("--index", default="flat_approx",
                    choices=["flat_approx", "flat", "ivf", "hnsw", "hybrid",
                             "binary"],
                    help="hybrid: the dynamic strategy's hybrid executor")
    ap.add_argument("--filtered", action="store_true",
                    help="rls --index hnsw: after the fixed-budget beam's "
                         "pass, time and trace the ACORN filtered "
                         "traversal's over the same queries")
    ap.add_argument("--dtype", default="int8",
                    choices=["int8", "bfloat16", "float32"])
    ap.add_argument("--alpha", type=float, default=0.0,
                    help="AnonySys storage budget (0 = the config's 1.5)")
    args = ap.parse_args(argv)
    if args.index == "hybrid" and (args.strategy, args.metric) != (
            "dynamic", "l2"):
        ap.error("--index hybrid is the dynamic strategy's executor, on l2")
    if args.filtered and (args.strategy, args.index) != ("rls", "hnsw"):
        ap.error("--filtered is the rls HNSW index's traversal")
    if args.metric == "l1" and args.dtype == "int8":
        ap.error("l1 cannot ride the int8 path; use --dtype float32 or "
                 "bfloat16")

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the profile is of the GPU port",
              file=sys.stderr)
        return 2

    from vectorsearch_rbac_tpu_torch.bench import make_scenario, serving_config
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    device = torch.device("cuda", 0)
    corpus, world, workload = make_scenario(
        n=args.n, num_queries=args.queries, topk=args.topk, seed=args.seed,
        dataset=args.dataset)
    cfg = serving_config(seed=args.seed, batch=args.batch, topk=args.topk,
                         strategy=args.strategy)
    cfg.index.kind = args.index
    if args.alpha:
        cfg.optimizer.storage_alpha = args.alpha
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=cfg.search.block_rows,
                               dtype=args.dtype, metric=args.metric)
    t0 = time.perf_counter()
    searcher = build_searcher(args.strategy, corpus, world, arena, cfg,
                              **({"packed": False} if args.index == "hybrid"
                                 else {}))
    build_s = time.perf_counter() - t0
    if args.index == "hybrid":
        rep = searcher.storage_report()
        n_graph = len(searcher.graph_batcher.pids)
        shape = (f"{n_graph} graph + {rep['num_partitions'] - n_graph} flat "
                 f"partitions, {rep['total_mb']:.1f} MB, build "
                 f"{build_s:.2f} s (graphs {searcher.graph_build_s:.2f} s)")
    elif args.index == "hnsw":
        ixs = [p.index for p in searcher.partitions.values()]
        shape = (f"{len(ixs)} HNSW graphs of {min(ix.n_rows for ix in ixs)}"
                 f"-{max(ix.n_rows for ix in ixs)} rows (builders "
                 f"{sorted({ix.builder for ix in ixs})}), ef_search "
                 f"{ixs[0].ef_search}, build {build_s:.2f} s")
    elif args.index == "ivf":
        ivfs = [p.index for p in searcher.partitions.values()]
        shape = (f"{len(ivfs)} IVF indexes, nlist "
                 f"{sorted({ix.nlist for ix in ivfs})[-1]}, nprobe "
                 f"{ivfs[0].nprobe}, l_pad {max(ix.l_pad for ix in ivfs)}, "
                 f"build {build_s:.2f} s")
    elif args.strategy == "rls":
        index = searcher.partitions[0].index
        shape = (f"{type(index).__name__}"
                 + (f", group {index.group}, rerank "
                    f"{index.rerank_mode if index.rerank else None}"
                    if hasattr(index, "group") else ""))
    elif hasattr(searcher, "buckets"):
        rep = searcher.storage_report()
        shape = (f"{rep['num_partitions']} partitions in buckets (P, L_pad) "
                 f"{searcher.bucket_shapes}, {rep['total_mb']:.1f} MB, build "
                 f"{build_s:.2f} s")
    else:
        rep = searcher.storage_report()
        shape = (f"{rep['num_partitions']} partitions "
                 f"({len(searcher._big)} big tier), "
                 f"{rep['total_mb']:.1f} MB, build {build_s:.2f} s")

    def report(label, run):
        for _ in range(2):
            run()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append((time.perf_counter() - t0) * 1000.0)
        untraced_ms = sum(walls) / len(walls)
        wall_ms, spans, rows, busy_ms = profile_pass(run)
        print(f"{torch.cuda.get_device_name(device)}: {label}"
              f"{args.dataset} {args.metric} {args.dtype} {args.strategy}, "
              f"pass of {args.queries} queries x {arena.n_padded} rows x d "
              f"{arena.dim}, top-{args.topk}, {shape}; wall untraced "
              f"{untraced_ms:.3f} ms (passes "
              f"{', '.join(f'{w:.3f}' for w in walls)}), traced "
              f"{wall_ms:.3f} ms; device busy {busy_ms:.3f} ms, idle share "
              f"of the untraced pass "
              f"{max(0.0, 1 - busy_ms / untraced_ms):.3f}")
        for key, (host, dev) in sorted(spans.items(),
                                       key=lambda kv: -kv[1][0]):
            print(f"  span {key:26s} host {host:10.3f} ms, device "
                  f"{dev:10.3f} ms")
        dev = {k: v[1] for k, v in spans.items()}
        if args.index == "hybrid":
            flat = (dev.get("partitioned.enqueue", 0.0)
                    + dev.get("flat_int8.fetch_unpack", 0.0))
            print(f"  device: graph {dev.get('partitioned.graph', 0.0):.3f}"
                  f" ms (fused search {dev.get('graph.search', 0.0):.3f}; "
                  f"step loop: score {dev.get('graph.score', 0.0):.3f}, "
                  f"merge {dev.get('graph.merge', 0.0):.3f}, dedup "
                  f"{dev.get('graph.dedup', 0.0):.3f}), flat remainder "
                  f"{flat:.3f} ms")
        elif hasattr(searcher, "buckets"):
            print(f"  device: packed scan {dev.get('packed.scan', 0.0):.3f}"
                  " ms")
        elif args.strategy != "rls" and args.index not in ("ivf", "hnsw"):
            chunk = dev.get("tiled.chunk_scan", 0.0)
            big = (dev.get("tiled.big_enqueue", 0.0)
                   + dev.get("tiled.big_fetch", 0.0))
            print(f"  device: chunk engine {chunk:.3f} ms, big tier "
                  f"{big:.3f} ms")
        for ms, count, key in rows[:20]:
            print(f"  device {ms:10.3f} ms {count:6d}x  {key[:80]}")

    def one_pass():
        searcher.search_batch(workload.vectors, workload.user_ids,
                              world.user_masks, args.topk)
        torch.cuda.synchronize()

    def filtered_pass():
        searcher.partitions[0].index.search(
            workload.vectors, world.user_masks[workload.user_ids],
            args.topk, filtered_traversal=True)
        torch.cuda.synchronize()

    passes = [("", one_pass)]
    if args.filtered:
        passes.append(("the filtered traversal's ", filtered_pass))
    for label, run in passes:
        report(label, run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
