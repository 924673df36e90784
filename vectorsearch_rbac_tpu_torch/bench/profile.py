"""Where a serving pass spends its time, on the card.

    python -m vectorsearch_rbac_tpu_torch.bench.profile [--n N] [--queries Q]

Builds bench's main-path world (SIFT-like corpus, tree RBAC with 100 roles
and 10k users, int8 arena, rls, ids wire, batch 2048, top-100), runs two
warm passes, times three untraced passes, then traces one pass with
torch.profiler. It prints the untraced and traced pass walls (their
difference is the tracing cost), the host spans of the index layer, the
device time by kernel and copy, and the device's busy and idle share of
the untraced pass (busy = the summed device time of kernels and copies,
which run one after another on the one stream). Needs a CUDA device.
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
        n=args.n, num_queries=args.queries, topk=args.topk, seed=args.seed)
    cfg = serving_config(seed=args.seed, batch=args.batch, topk=args.topk)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=cfg.search.block_rows, dtype="int8")
    searcher = build_searcher("rls", corpus, world, arena, cfg)

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

    rows, spans = [], []
    for ev in prof.key_averages():
        if ev.key.startswith("flat_int8."):
            spans.append((ev.cpu_time_total / 1000.0, ev.key))
        elif ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
            rows.append((ev.self_device_time_total / 1000.0, ev.count,
                         ev.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"{torch.cuda.get_device_name(device)}: pass of {args.queries} "
          f"queries x {arena.n_padded} rows; wall untraced {untraced_ms:.3f}"
          f" ms (passes {', '.join(f'{w:.3f}' for w in walls)}), traced "
          f"{wall_ms:.3f} ms; device busy {busy_ms:.3f} ms, idle share of "
          f"the untraced pass {max(0.0, 1 - busy_ms / untraced_ms):.3f}")
    for ms, key in sorted(spans, reverse=True):
        print(f"  host span {ms:10.3f} ms  {key}")
    for ms, count, key in rows[:20]:
        print(f"  device {ms:10.3f} ms {count:6d}x  {key[:80]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
