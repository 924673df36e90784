"""Where a serving pass spends its time, on the card.

    python -m vectorsearch_rbac_tpu_torch.bench.profile [--n N] [--queries Q]
        [--dataset sift1m|cohere] [--metric l2|ip|cosine]

Builds bench's world for the dataset and metric (tree RBAC with 100 roles
and 10k users, int8 arena, rls, ids wire, batch 2048, top-100), runs two
warm passes, times three untraced passes, then traces one pass with
torch.profiler. It prints the untraced and traced pass walls (their
difference is the tracing cost), the spans of the index layer with their
host time and the device time of the kernels launched inside them (the
per-batch stages scan, merge, rerank and wire split a pass), the device
time by kernel and copy, and the device's busy and idle share of the
untraced pass (busy = the summed device time of kernels and copies, which
run one after another on the one stream). Needs a CUDA device.
"""

import argparse
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m vectorsearch_rbac_tpu_torch.bench.profile")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=32768)
    ap.add_argument("--topk", type=int, default=100)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dataset", default="sift1m",
                    choices=["sift1m", "cohere"])
    ap.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "cosine"])
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    cfg = serving_config(seed=args.seed, batch=args.batch, topk=args.topk)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=cfg.search.block_rows, dtype="int8",
                               metric=args.metric)
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    index = searcher.partitions[0].index

    def one_pass():
        searcher.search_batch(workload.vectors, workload.user_ids,
                              world.user_masks, args.topk)

    for _ in range(2):
        one_pass()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1000.0)
    untraced_ms = sum(walls) / len(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1000.0

    # a span appears twice: its host range (CPU) and, where it enqueued
    # device work, its range on the device's timeline (CUDA)
    rows, spans = [], {}
    for ev in prof.key_averages():
        if ev.key.startswith("flat_int8."):
            host, dev = spans.get(ev.key, (0.0, 0.0))
            if ev.device_type == DeviceType.CUDA:
                dev = ev.device_time_total / 1000.0
            else:
                host = ev.cpu_time_total / 1000.0
            spans[ev.key] = (host, dev)
        elif ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            rows.append((ev.self_device_time_total / 1000.0, ev.count,
                         ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"{torch.cuda.get_device_name(device)}: {args.dataset} "
          f"{args.metric}, pass of {args.queries} queries x "
          f"{arena.n_padded} rows x d_pad {arena.quant.d_pad}, group "
          f"{index.group}, rerank {index.rerank_mode if index.rerank else None}"
          f"; wall untraced {untraced_ms:.3f}"
          f" ms (passes {', '.join(f'{w:.3f}' for w in walls)}), traced "
          f"{wall_ms:.3f} ms; device busy {busy_ms:.3f} ms, idle share of "
          f"the untraced pass {max(0.0, 1 - busy_ms / untraced_ms):.3f}")
    for key, (host, dev) in sorted(spans.items(), key=lambda kv: -kv[1][0]):
        print(f"  span {key:26s} host {host:10.3f} ms, device {dev:10.3f} ms")
    for ms, count, key in rows[:20]:
        print(f"  device {ms:10.3f} ms {count:6d}x  {key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
