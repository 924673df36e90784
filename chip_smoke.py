#!/usr/bin/env python3
"""Smoke run of the GPU port (vectorsearch_rbac_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. It needs no arguments and no network, and it exits non-zero
without a CUDA device or without the port's package beside it. Phases:

1. the card's name and power limit, and the torch / CUDA versions;
2. the kernel build (nvcc, csrc/ -> build/kernels/), timed, with ptxas's
   register report;
3. each kernel against its plain PyTorch version at main-path geometry
   (a 2048-query batch against the 1M-row arena, group 128): the scan must
   be bit-identical; the merge stages must give identical values and
   identical positions on the non-empty slots. Times come from CUDA events;
4. the main path at full size: a 1M x 128 SIFT-like corpus (seed 0) with
   bench.py's tree RBAC world (100 roles, 10k users), 8192 queries drawn
   from the corpus's held-out pool as bench.py draws them, top-100,
   through build_searcher("rls") and run_benchmark against the exact
   float32 oracle. Recall must reach 0.95, every returned row must be
   readable by its user, and each kernel's launch count must rise.

Neither jax nor the JAX package (vectorsearch_rbac_tpu) is imported; the
run fails if either was loaded.

Its last lines are one JSON object of per-kernel results, the card's
nvidia-smi line, and {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_ROWS = 1_000_000
N_QUERIES = 8192
TOPK = 100
BATCH = 2048          # the main path's query batch
BLOCK_ROWS = 131072   # bench.py's default arena padding
RECALL_FLOOR = 0.95


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max().item())


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run measures the GPU port")
    try:
        import vectorsearch_rbac_tpu_torch as port
    except ImportError as e:
        fail(f"the port's package is not importable here: {e}")
    if not os.path.abspath(port.__file__).startswith(HERE + os.sep):
        fail(f"the port's package was found outside this checkout "
             f"({port.__file__})")

    # ---- 1. the card
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi did not report the card: {e}")
    device = torch.device("cuda", 0)
    say(f"card: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(device)} x {torch.cuda.device_count()}")

    # ---- 2. the kernel build
    from vectorsearch_rbac_tpu_torch.ops import _build

    t0 = time.perf_counter()
    so, log = _build.build()
    _build.lib()
    say(f"kernel build: {time.perf_counter() - t0:.2f} s -> "
        f"{os.path.relpath(so, HERE)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say(f"  ptxas: {line.strip()}")

    # ---- data at full size (host), shared by phases 3 and 4
    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import (
        GroundTruthOracle, compute_truth_sample, make_scenario, run_benchmark,
        serving_config)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.ops import merge, scan_int8
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(n=N_ROWS, num_queries=N_QUERIES,
                                            topk=TOPK, seed=0)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=BLOCK_ROWS, dtype="int8")
    say(f"data: {corpus.n} x {corpus.dim}, {world.num_roles} roles, "
        f"{world.num_users} users, {N_QUERIES} queries, arena "
        f"{arena.n_padded} rows: {time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels against their plain versions, main-path geometry
    quant = arena.quant
    group = 128
    q8, _ = quant.quantize_queries(workload.vectors[:BATCH],
                                   with_norms=False)
    q8 = torch.from_numpy(q8).to(device)
    qbits = torch.from_numpy(np.ascontiguousarray(
        world.user_masks[workload.user_ids[:BATCH]]).view(np.int32)).to(device)
    scan_args = (q8, quant.vectors_q, quant.norms_q, arena.role_bits, qbits,
                 group, "l2", quant.score_shift)
    nsub, t = 32, 16
    n_groups = arena.n_padded // group
    if not merge.merge_supported(n_groups, TOPK, nsub, t):
        fail(f"the merge gate refuses the main-path shape ({n_groups} "
             f"groups, k {TOPK})")
    keep = 8 * ((TOPK + 7) // 8)
    packed = scan_int8.int8_group_minima(*scan_args)
    packed_plain = scan_int8.int8_group_minima_plain(*scan_args)
    y, meta = merge.extract_pairs(packed, nsub, t)
    y_plain, meta_plain = merge.extract_pairs_plain(packed, nsub, t)
    ys, gs = merge.bitonic_pairs(y, meta, keep)
    ys_plain, gs_plain = merge.bitonic_pairs_plain(y, meta, keep)
    torch.cuda.synchronize()

    empty = scan_int8.EMPTY_I32
    checks = {
        "scan_int8": torch.equal(packed, packed_plain),
        "merge_extract": torch.equal(y, y_plain) and torch.equal(
            meta[y < empty], meta_plain[y < empty]),
        "merge_bitonic": torch.equal(ys, ys_plain) and torch.equal(
            gs[ys < empty], gs_plain[ys < empty]),
    }
    errs = {
        "scan_int8": max_abs_err(packed, packed_plain),
        "merge_extract": max_abs_err(y, y_plain),
        "merge_bitonic": max_abs_err(ys, ys_plain),
    }
    t_kernel = {
        "scan_int8": cuda_ms(lambda: scan_int8.int8_group_minima(*scan_args), 10),
        "merge_extract": cuda_ms(lambda: merge.extract_pairs(packed, nsub, t), 10),
        "merge_bitonic": cuda_ms(lambda: merge.bitonic_pairs(y, meta, keep), 10),
    }
    t_plain = {
        "scan_int8": cuda_ms(
            lambda: scan_int8.int8_group_minima_plain(*scan_args), 3),
        "merge_extract": cuda_ms(
            lambda: merge.extract_pairs_plain(packed, nsub, t), 3),
        "merge_bitonic": cuda_ms(
            lambda: merge.bitonic_pairs_plain(y, meta, keep), 3),
    }
    say(f"kernel vs plain at Q={BATCH} x {arena.n_padded} rows, group "
        f"{group}, nsub {nsub}, t {t}, keep {keep} ({smi}); tolerance 0: "
        "values bit-identical, merge positions identical where the value "
        "is a candidate:")
    for name in checks:
        say(f"  {name:14s} identical={checks[name]} max_abs_err="
            f"{errs[name]} kernel {t_kernel[name]:.3f} ms, plain "
            f"{t_plain[name]:.3f} ms")
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    del packed_plain, y_plain, meta_plain, ys_plain, gs_plain
    torch.cuda.empty_cache()

    # ---- 4. the main path at full size
    t0 = time.perf_counter()
    gt_arena = build_device_arena(corpus, world, device=device,
                                  block_rows=65536, dtype="float32")
    oracle = GroundTruthOracle(gt_arena, block_rows=65536, query_batch=1024)
    truth = compute_truth_sample(oracle, corpus, world, workload, TOPK,
                                 recall_sample=None)
    say(f"exact oracle ({len(truth)} queries, float32 on the card): "
        f"{time.perf_counter() - t0:.1f} s")
    del oracle, gt_arena
    torch.cuda.empty_cache()

    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=BATCH,
                         topk=TOPK)

    _build.reset_launches()
    t0 = time.perf_counter()
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=2, timed_batches=64, timed_passes=8,
                        recall_sample=None, truth=truth)
    launches = dict(_build.LAUNCHES)
    say(f"main path ({time.perf_counter() - t0:.1f} s, {smi}): recall@{TOPK} "
        f"{res.avg_recall}, {res.qps} QPS over {N_QUERIES} queries, "
        f"batch-1 p50 {res.p50_ms} ms p95 {res.p95_ms} ms, group "
        f"{searcher.partitions[0].index.group}, launches {launches}")
    if res.avg_recall < RECALL_FLOOR:
        fail(f"recall {res.avg_recall:.4f} < {RECALL_FLOOR}")
    if searcher.partitions[0].index.group != group:
        fail(f"the index chose group {searcher.partitions[0].index.group}, "
             f"not the main path's {group}")
    idle = [name for name, n in launches.items() if n == 0]
    if idle:
        fail(f"the main path never launched {idle}")

    # every returned row exists and is readable by the querying user
    _, ids = searcher.search_batch(workload.vectors[:BATCH],
                                   workload.user_ids[:BATCH],
                                   world.user_masks, TOPK)
    if ids.shape != (BATCH, TOPK) or ids.min() < -1 or ids.max() >= corpus.n:
        fail(f"result ids out of range: shape {ids.shape}, "
             f"[{ids.min()}, {ids.max()}]")
    masks = world.user_masks[workload.user_ids[:BATCH]]
    rows = arena.host_bits[np.maximum(ids, 0)]
    readable = (rows & masks[:, None, :]).any(axis=2) | (ids < 0)
    if not readable.all():
        fail(f"{int((~readable).sum())} returned rows are not readable by "
             "their users")
    say(f"permissions: all {int((ids >= 0).sum())} returned rows readable")
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "vectorsearch_rbac_tpu")]
    if loaded:
        fail(f"jax or the JAX package was imported: {sorted(loaded)[:5]}")

    sources = {
        "scan_int8": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
                      "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:40"),
        "merge_extract": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                          "vectorsearch_rbac_tpu/ops/pallas_merge.py:55"),
        "merge_bitonic": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                          "vectorsearch_rbac_tpu/ops/pallas_merge.py:79"),
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": t_kernel[name], "plain_ms": t_plain[name]}
        for name, (src, rep) in sources.items()]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
