#!/usr/bin/env python3
"""Smoke run of the GPU port (vectorsearch_rbac_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit. It needs no arguments and no network, and it exits non-zero
without a CUDA device or without the port's package beside it. Phases:

1. the card's name and power limit, and the torch / CUDA versions;
2. the kernel build (one nvcc per csrc/*.cu, all at once, then a link into
   build/kernels/), timed, with ptxas's register report;
3. the narrow scan and the merge kernels against their plain PyTorch
   versions at the SIFT path's geometry (a 2048-query batch against the
   1M-row arena, group 128, k 100): the scan must be bit-identical; the
   merge stages must give identical values and identical positions on the
   non-empty slots. Times come from CUDA events;
3c. the narrow scan's admit-dedup slot form against its plain version at
   the same geometry with group 32: a 2048-query batch whose 100 distinct
   masks fill 128 slots of 16, in the contiguous layout the index uses and
   the interleaved one of the TPU kernel, bit-identical; beside them the
   per-query form's time on the same masks;
4. the SIFT path at full size: a 1M x 128 SIFT-like corpus (seed 0) with
   bench.py's tree RBAC world (100 roles, 10k users), 8192 queries drawn
   from the corpus's held-out pool as bench.py draws them, top-100, L2,
   through build_searcher("rls") and run_benchmark against the exact
   float32 oracle; then admit-dedup on and off in turns on that path
   (pass walls, identical results);
4c. the partitioned strategies on the same corpus and arena: ROLE, USER
   and AnonySys (dynamic, storage alpha 2.0, the port's own planner), each
   over the first 4096 queries, top-10, batch 1024, against the exact
   top-10 oracle, with recall, QPS, batch-1 latency, partitions, storage,
   build time and the device time of the chunk engine against the big
   tier from one traced pass; over the phase the narrow scan, its slot
   form and the merge kernels must have launched, and admit-dedup must
   have grouped a big-tier pass; then admit-dedup on and off in turns on
   the AnonySys path;
3b. the wide scan against its plain version at the 768-d path's geometry
   (a 2048-query batch against the 1,048,576-row cosine arena, ip kernel
   metric, score shift 3, group 128), bit-identical, then the merge
   kernels on its minima at kk = 100 + 32 (keep 136);
4b. the 768-d path at full size: the cohere-like 1M x 768 corpus (seed 0),
   the same world, 8192 queries, top-100, cosine, residual4 rerank,
   through build_searcher("rls") and run_benchmark against the exact
   cosine oracle.
On each path recall must reach 0.95, every returned row must be readable
by its user, and each kernel of the path must have launched while it ran
(the counts are set to 0 just before it; "scan_int8" counts every launch
of the narrow scan, "scan_int8_slots" those of its slot form). Each path
prints short content hashes of its workload (query vectors and user ids)
and of its ground truth, so that a change of recall can be traced to the
input that moved.

Neither jax nor the JAX package (vectorsearch_rbac_tpu) is imported; the
run fails if either was loaded.

Its last lines are one JSON object of per-kernel results, the card's
nvidia-smi line, and {"ok": true, "device": {...}}.
"""

import gc
import hashlib
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
GROUP = 128           # the group width both paths' indexes pick at 1M
RERANK_MARGIN = 32    # kk = TOPK + 32 on the 768-d path
SLOT_SB = 16          # admit-dedup slot width (index/flat_int8.py MASK_SB)
SLOT_GROUP = 32       # the big tier's group width (phase 3c's geometry)
PART_QUERIES = 4096   # the strategy compare's workload (4c)
PART_TOPK = 10
PART_ALPHA = 2.0      # AnonySys storage budget (scripts/strategy_compare_1m)


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


def digest(*arrays) -> str:
    """Short content hash of numpy arrays (dtype, shape and bytes)."""
    import numpy as np

    h = hashlib.blake2b(digest_size=8)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def report(title, rows) -> None:
    """Print kernel-vs-plain rows and fail on any disagreement."""
    say(title)
    for name, (ok, err, ms, plain_ms) in rows.items():
        say(f"  {name:14s} identical={ok} max_abs_err={err} kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
    bad = [name for name, row in rows.items() if not row[0]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")


def check_merge(packed, k, nsub=32, t=16):
    """The merge kernels against their plain versions on packed minima:
    (ok, max_abs_err, kernel ms, plain ms) per stage, and the inputs."""
    import torch

    from vectorsearch_rbac_tpu_torch.ops import merge, scan_int8

    keep = 8 * ((k + 7) // 8)
    y, meta = merge.extract_pairs(packed, nsub, t)
    y_plain, meta_plain = merge.extract_pairs_plain(packed, nsub, t)
    ys, gs = merge.bitonic_pairs(y, meta, keep)
    ys_plain, gs_plain = merge.bitonic_pairs_plain(y, meta, keep)
    torch.cuda.synchronize()
    empty = scan_int8.EMPTY_I32
    out = {
        "merge_extract": (
            torch.equal(y, y_plain)
            and torch.equal(meta[y < empty], meta_plain[y < empty]),
            max_abs_err(y, y_plain),
            cuda_ms(lambda: merge.extract_pairs(packed, nsub, t), 10),
            cuda_ms(lambda: merge.extract_pairs_plain(packed, nsub, t), 3)),
        "merge_bitonic": (
            torch.equal(ys, ys_plain)
            and torch.equal(gs[ys < empty], gs_plain[ys < empty]),
            max_abs_err(ys, ys_plain),
            cuda_ms(lambda: merge.bitonic_pairs(y, meta, keep), 10),
            cuda_ms(lambda: merge.bitonic_pairs_plain(y, meta, keep), 3)),
    }
    return out, keep


def drive_path(name, searcher, corpus, world, workload, truth, arena,
               kernels, smi):
    """Run one path through run_benchmark with every launch count set to 0
    just before, and check it: recall, group, readable rows, launches.
    Returns the launch counts of the run."""
    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import run_benchmark
    from vectorsearch_rbac_tpu_torch.ops import _build

    index = searcher.partitions[0].index
    _build.reset_launches()
    t0 = time.perf_counter()
    res = run_benchmark(searcher, corpus, world, workload, None, k=TOPK,
                        warmup_runs=2, timed_batches=64, timed_passes=8,
                        recall_sample=None, truth=truth)
    launches = dict(_build.LAUNCHES)
    say(f"{name} path ({time.perf_counter() - t0:.1f} s, {smi}): "
        f"recall@{TOPK} {res.avg_recall}, {res.qps} QPS over "
        f"{workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms, group {index.group}, rerank "
        f"{index.rerank_mode if index.rerank else None}, launches {launches}")
    if res.avg_recall < RECALL_FLOOR:
        fail(f"{name}: recall {res.avg_recall:.4f} < {RECALL_FLOOR}")
    if index.group != GROUP:
        fail(f"{name}: the index chose group {index.group}, not {GROUP}")
    idle = [k for k in kernels if launches[k] == 0]
    if idle:
        fail(f"{name}: the path never launched {idle}")

    _, ids = searcher.search_batch(workload.vectors[:BATCH],
                                   workload.user_ids[:BATCH],
                                   world.user_masks, TOPK)
    check_readable(name, ids, workload.user_ids[:BATCH], TOPK, corpus, world,
                   arena)
    return launches


def check_readable(name, ids, users, k, corpus, world, arena) -> None:
    """Every returned row exists and is readable by the querying user."""
    import numpy as np

    if ids.shape != (len(users), k) or ids.min() < -1 \
            or ids.max() >= corpus.n:
        fail(f"{name}: result ids out of range: shape {ids.shape}, "
             f"[{ids.min()}, {ids.max()}]")
    masks = world.user_masks[users]
    rows = arena.host_bits[np.maximum(ids, 0)]
    readable = (rows & masks[:, None, :]).any(axis=2) | (ids < 0)
    if not readable.all():
        fail(f"{name}: {int((~readable).sum())} returned rows are not "
             "readable by their users")
    say(f"{name} permissions: all {int((ids >= 0).sum())} returned rows "
        "readable")


def ab_dedup(name, indexes, one_pass, smi) -> None:
    """Admit-dedup on and off in turns (on, off, off, on, three times) over
    full passes of one path, after one warm pass each: host-clock walls
    (each pass ends in the host copy of its results) and results that must
    not change."""
    import numpy as np
    import torch

    walls, out, fired = {True: [], False: []}, {}, False
    for flag in (True, False, *(True, False, False, True) * 3):
        for ix in indexes:
            ix.mask_dedup = flag
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = one_pass()
        ms = (time.perf_counter() - t0) * 1000.0
        if flag in out:           # the first pass of each is the warm one
            walls[flag].append(ms)
        out.setdefault(flag, res)
        fired |= flag and any(ix._last_dedup for ix in indexes)
    for ix in indexes:
        ix.mask_dedup = True
    same = all(np.array_equal(a, b) for a, b in zip(out[True], out[False]))
    say(f"admit-dedup A/B on the {name} path ({smi}): on "
        f"{[round(w, 3) for w in walls[True]]} ms (median "
        f"{float(np.median(walls[True])):.3f}), off "
        f"{[round(w, 3) for w in walls[False]]} ms (median "
        f"{float(np.median(walls[False])):.3f}); grouped {fired}; results "
        f"identical {same}")
    if not same:
        fail(f"{name}: admit-dedup changed the results")
    if not fired:
        fail(f"{name}: admit-dedup never grouped a pass")


def check_slot_form(arena, workload, world, device, smi):
    """Phase 3c: the slot form against its plain version in both layouts,
    at 2048 queries x the arena, group 32; 128 slots of 16 queries carry
    the world's 100 distinct masks (slot s the (s % 100)-th). Returns
    (ok, max_abs_err, kernel ms, plain ms) for the contiguous layout the
    index uses."""
    import numpy as np
    import torch

    from vectorsearch_rbac_tpu_torch.ops import scan_int8

    quant = arena.quant
    q8, _ = quant.quantize_queries(workload.vectors[:BATCH], with_norms=False)
    distinct = np.unique(world.user_masks, axis=0)
    slots = distinct[np.arange(BATCH // SLOT_SB) % len(distinct)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    args = (t(q8), quant.vectors_q, quant.norms_q, arena.role_bits)
    slot_bits = t(slots.view(np.int32))
    kw = dict(group=SLOT_GROUP, metric="l2", score_shift=quant.score_shift,
              mask_sub_block=SLOT_SB)
    rows, errs, ms = {}, [], {}
    for layout, tile in (("contiguous", 0), ("interleaved", BATCH)):
        got = scan_int8.int8_group_minima(*args, slot_bits, slot_tile=tile,
                                          **kw)
        want = scan_int8.int8_group_minima_plain(*args, slot_bits,
                                                 slot_tile=tile, **kw)
        torch.cuda.synchronize()
        rows[layout] = torch.equal(got, want)
        errs.append(max_abs_err(got, want))
        ms[layout] = cuda_ms(lambda: scan_int8.int8_group_minima(
            *args, slot_bits, slot_tile=tile, **kw), 10)
        del got, want
    per_query = t(slots[np.arange(BATCH) // SLOT_SB].view(np.int32))
    kw_q = dict(group=SLOT_GROUP, metric="l2", score_shift=quant.score_shift)
    ms["per-query"] = cuda_ms(lambda: scan_int8.int8_group_minima(
        *args, per_query, **kw_q), 10)
    plain_ms = cuda_ms(lambda: scan_int8.int8_group_minima_plain(
        *args, slot_bits, slot_tile=0, **kw), 3)
    say(f"slot form vs plain at Q={BATCH} x {arena.n_padded} rows, "
        f"{len(distinct)} distinct masks in {BATCH // SLOT_SB} slots of "
        f"{SLOT_SB}, group {SLOT_GROUP} ({smi}); tolerance 0: contiguous "
        f"identical={rows['contiguous']} {ms['contiguous']:.3f} ms, "
        f"interleaved identical={rows['interleaved']} "
        f"{ms['interleaved']:.3f} ms, plain {plain_ms:.3f} ms; the "
        f"per-query form on the same masks {ms['per-query']:.3f} ms")
    if not all(rows.values()):
        fail(f"the slot form disagrees with its plain version: {rows}")
    return True, max(errs), ms["contiguous"], plain_ms


def drive_partitioned(name, searcher, build_s, corpus, world, workload,
                      truth, arena, smi):
    """One strategy of phase 4c through run_benchmark, its launch counts
    set to 0 just before and read just after (with the final full pass
    that checks permissions); then one traced pass for the device time of
    the chunk engine and of the big tier. Returns (launches, whether a
    big-tier pass grouped by mask)."""
    import torch

    from vectorsearch_rbac_tpu_torch.bench import run_benchmark
    from vectorsearch_rbac_tpu_torch.bench.profile import profile_pass
    from vectorsearch_rbac_tpu_torch.ops import _build

    _build.reset_launches()
    res = run_benchmark(searcher, corpus, world, workload, None, k=PART_TOPK,
                        warmup_runs=1, timed_batches=32, timed_passes=5,
                        recall_sample=None, truth=truth)
    _, ids = searcher.search_batch(workload.vectors, workload.user_ids,
                                   world.user_masks, PART_TOPK)
    launches = dict(_build.LAUNCHES)
    grouped = {pid: ix._last_dedup for pid, ix in searcher._big.items()}
    check_readable(name, ids, workload.user_ids, PART_TOPK, corpus, world,
                   arena)

    def one_pass():
        searcher.search_batch(workload.vectors, workload.user_ids,
                              world.user_masks, PART_TOPK)
        torch.cuda.synchronize()

    wall, spans, _, busy = profile_pass(one_pass)
    chunk = spans.get("tiled.chunk_scan", (0.0, 0.0))[1]
    big = sum(spans.get(k, (0.0, 0.0))[1]
              for k in ("tiled.big_enqueue", "tiled.big_fetch"))
    share = (f"{chunk / (chunk + big):.3f}" if chunk + big
             else "not measured")
    rep = res.storage
    fired = {k: launches[k] > 0 for k in
             ("scan_int8", "scan_int8_slots", "merge_extract",
              "merge_bitonic")}
    say(f"{name} ({smi}): recall@{PART_TOPK} {res.avg_recall}, {res.qps} "
        f"QPS over {workload.num_queries} queries (pass walls ms "
        f"{[round(w, 3) for w in res.extra['pass_walls_ms']]}), batch-1 p50 "
        f"{res.p50_ms} ms p95 {res.p95_ms} ms, {rep['num_partitions']} "
        f"partitions ({len(searcher._big)} big tier), {rep['total_mb']:.1f} "
        f"MB, build {build_s:.2f} s; traced pass {wall:.3f} ms, device busy "
        f"{busy:.3f} ms: chunk engine {chunk:.3f} ms, big tier {big:.3f} "
        f"ms, chunk-engine share {share}; fired {fired}, big tier grouped "
        f"by mask {grouped}; launches {launches}")
    if res.avg_recall < RECALL_FLOOR:
        fail(f"{name}: recall {res.avg_recall:.4f} < {RECALL_FLOOR}")
    return launches, any(grouped.values())


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

    import numpy as np

    from vectorsearch_rbac_tpu_torch.bench import (
        GroundTruthOracle, QueryWorkload, compute_truth_sample, make_scenario,
        serving_config)
    from vectorsearch_rbac_tpu_torch.core import build_device_arena
    from vectorsearch_rbac_tpu_torch.ops import scan_int8
    from vectorsearch_rbac_tpu_torch.ops.merge import merge_supported
    from vectorsearch_rbac_tpu_torch.partition import build_searcher

    cfg = serving_config(seed=0, block_rows=BLOCK_ROWS, batch=BATCH,
                         topk=TOPK)
    result = {}          # kernel -> (ok, max_abs_err, ms, plain_ms)

    def oracle_truth(corpus, world, workload, metric, part_workload=None):
        """Exact top-TOPK of the workload (and top-PART_TOPK of
        part_workload) on a float32 arena, freed after."""
        t0 = time.perf_counter()
        gt_arena = build_device_arena(corpus, world, device=device,
                                      block_rows=65536, dtype="float32",
                                      metric=metric)
        oracle = GroundTruthOracle(gt_arena, block_rows=65536,
                                   query_batch=1024)
        truth = compute_truth_sample(oracle, corpus, world, workload, TOPK,
                                     recall_sample=None)
        part = (None if part_workload is None else compute_truth_sample(
            oracle, corpus, world, part_workload, PART_TOPK,
            recall_sample=None))
        say(f"exact {metric} oracle ({len(truth)} queries, float32 on the "
            f"card): {time.perf_counter() - t0:.1f} s")
        del oracle, gt_arena
        torch.cuda.empty_cache()
        return truth if part_workload is None else (truth, part)

    def batch_operands(arena, workload, world, metric):
        quant = arena.quant
        qv = workload.vectors[:BATCH]
        if metric == "l2":
            q8, _ = quant.quantize_queries(qv, with_norms=False)
        else:
            q8, _, _ = quant.quantize_queries_ip(
                qv, cosine=metric == "cosine")
        qbits = np.ascontiguousarray(
            world.user_masks[workload.user_ids[:BATCH]]).view(np.int32)
        return (torch.from_numpy(q8).to(device), quant.vectors_q,
                quant.norms_q, arena.role_bits,
                torch.from_numpy(qbits).to(device))

    # ---- the SIFT path: data, phase 3, phase 4
    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(n=N_ROWS, num_queries=N_QUERIES,
                                            topk=TOPK, seed=0)
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=BLOCK_ROWS, dtype="int8")
    say(f"SIFT data: {corpus.n} x {corpus.dim}, {world.num_roles} roles, "
        f"{world.num_users} users, {N_QUERIES} queries, arena "
        f"{arena.n_padded} rows: {time.perf_counter() - t0:.1f} s; workload "
        f"hash {digest(workload.vectors, workload.user_ids)}")

    scan_args = (*batch_operands(arena, workload, world, "l2"), GROUP, "l2",
                 arena.quant.score_shift)
    n_groups = arena.n_padded // GROUP
    if not merge_supported(n_groups, TOPK):
        fail(f"the merge gate refuses the SIFT path's shape ({n_groups} "
             f"groups, k {TOPK})")
    packed = scan_int8.int8_group_minima(*scan_args)
    packed_plain = scan_int8.int8_group_minima_plain(*scan_args)
    torch.cuda.synchronize()
    result["scan_int8"] = (
        torch.equal(packed, packed_plain), max_abs_err(packed, packed_plain),
        cuda_ms(lambda: scan_int8.int8_group_minima(*scan_args), 10),
        cuda_ms(lambda: scan_int8.int8_group_minima_plain(*scan_args), 3))
    del packed_plain
    merges, keep = check_merge(packed, TOPK)
    result.update(merges)
    report(f"kernel vs plain at Q={BATCH} x {arena.n_padded} rows x d_pad "
           f"128, group {GROUP}, nsub 32, t 16, keep {keep} ({smi}); "
           "tolerance 0: values bit-identical, merge positions identical "
           "where the value is a candidate:",
           {k: result[k] for k in ("scan_int8", *merges)})
    del packed
    torch.cuda.empty_cache()
    result["scan_int8_slots"] = check_slot_form(arena, workload, world,
                                                device, smi)
    torch.cuda.empty_cache()

    part_workload = QueryWorkload(
        vectors=workload.vectors[:PART_QUERIES],
        user_ids=workload.user_ids[:PART_QUERIES], topk=PART_TOPK,
        selectivities=workload.selectivities[:PART_QUERIES],
        repetitions=workload.repetitions[:PART_QUERIES])
    truth, part_truth = oracle_truth(corpus, world, workload, "l2",
                                     part_workload)
    say(f"SIFT ground-truth hash {digest(truth)}, top-{PART_TOPK} over the "
        f"first {PART_QUERIES} queries {digest(part_truth)}")
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    launches_sift = drive_path(
        "SIFT (1M x 128, l2)", searcher, corpus, world, workload, truth,
        arena, ("scan_int8", "merge_extract", "merge_bitonic"), smi)
    ab_dedup("SIFT rls", [searcher.partitions[0].index],
             lambda: searcher.search_batch(workload.vectors,
                                           workload.user_ids,
                                           world.user_masks, TOPK), smi)
    del searcher
    gc.collect()
    torch.cuda.empty_cache()

    # ---- phase 4c: the partitioned strategies on the same corpus and arena
    launches_part = {k: 0 for k in launches_sift}
    grouped = False
    for name in ("role", "user", "dynamic"):
        pcfg = serving_config(seed=0, block_rows=BLOCK_ROWS, topk=PART_TOPK,
                              strategy=name)
        pcfg.optimizer.storage_alpha = PART_ALPHA
        pcfg.optimizer.topk = PART_TOPK
        t0 = time.perf_counter()
        searcher = build_searcher(name, corpus, world, arena, pcfg)
        build_s = time.perf_counter() - t0
        launches, g = drive_partitioned(
            f"{name} (1M x 128, l2, batch {pcfg.search.batch_size})",
            searcher, build_s, corpus, world, part_workload, part_truth,
            arena, smi)
        grouped |= g
        for k in launches_part:
            launches_part[k] += launches[k]
        if name == "dynamic":
            ab_dedup("AnonySys", list(searcher._big.values()),
                     lambda: searcher.search_batch(
                         part_workload.vectors, part_workload.user_ids,
                         world.user_masks, PART_TOPK), smi)
        del searcher
        gc.collect()
        torch.cuda.empty_cache()
    idle = [k for k in ("scan_int8", "scan_int8_slots", "merge_extract",
                        "merge_bitonic") if launches_part[k] == 0]
    if idle:
        fail(f"the partitioned strategies never launched {idle}")
    if not grouped:
        fail("admit-dedup grouped no big-tier pass of the partitioned path")
    # free the SIFT arrays before the 768-d corpus (3 GB of float32)
    del corpus, world, workload, arena, truth, part_truth, scan_args
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the 768-d path: data, phase 3b, phase 4b
    t0 = time.perf_counter()
    corpus, world, workload = make_scenario(n=N_ROWS, num_queries=N_QUERIES,
                                            topk=TOPK, seed=0,
                                            dataset="cohere")
    t_data = time.perf_counter() - t0
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=BLOCK_ROWS, dtype="int8",
                               metric="cosine")
    shift = arena.quant.score_shift
    say(f"cohere data: {corpus.n} x {corpus.dim}, {N_QUERIES} queries: "
        f"{t_data:.1f} s; cosine int8 arena {arena.n_padded} rows x d_pad "
        f"{arena.quant.d_pad}, score shift {shift}: "
        f"{time.perf_counter() - t0 - t_data:.1f} s; workload hash "
        f"{digest(workload.vectors, workload.user_ids)}")
    if shift != 3:
        fail(f"score shift {shift} at d_pad {arena.quant.d_pad}, not 3")

    wide_args = (*batch_operands(arena, workload, world, "cosine"), GROUP,
                 "ip", shift)
    kk = TOPK + RERANK_MARGIN
    if not merge_supported(arena.n_padded // GROUP, kk):
        fail(f"the merge gate refuses the 768-d path's shape (k {kk})")
    packed = scan_int8.int8_group_minima_wide(*wide_args)
    packed_plain = scan_int8.int8_group_minima_wide_plain(*wide_args)
    torch.cuda.synchronize()
    result["scan_int8_wide"] = (
        torch.equal(packed, packed_plain), max_abs_err(packed, packed_plain),
        cuda_ms(lambda: scan_int8.int8_group_minima_wide(*wide_args), 10),
        cuda_ms(lambda: scan_int8.int8_group_minima_wide_plain(*wide_args),
                3))
    del packed_plain
    merges_kk, keep = check_merge(packed, kk)
    report(f"kernel vs plain at Q={BATCH} x {arena.n_padded} rows x d_pad "
           f"{arena.quant.d_pad}, ip, shift {shift}, group {GROUP}; merge at "
           f"kk {kk}, keep {keep} ({smi}); tolerance 0 as above:",
           {"scan_int8_wide": result["scan_int8_wide"], **merges_kk})
    for k, (ok, err, _, _) in merges_kk.items():    # one row per kernel
        result[k] = (result[k][0] and ok, max(result[k][1], err),
                     *result[k][2:])
    del packed, wide_args
    torch.cuda.empty_cache()

    truth = oracle_truth(corpus, world, workload, "cosine")
    say(f"cohere ground-truth hash {digest(truth)}")
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    mode = searcher.partitions[0].index.rerank_mode
    if mode != "residual4":
        fail(f"the 768-d index reranks with {mode!r}, not 'residual4'")
    launches_wide = drive_path(
        "768-d (1M x 768, cosine)", searcher, corpus, world, workload, truth,
        arena, ("scan_int8_wide", "merge_extract", "merge_bitonic"), smi)
    launches = {k: launches_sift[k] + launches_part[k] + launches_wide[k]
                for k in launches_sift}

    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "vectorsearch_rbac_tpu")]
    if loaded:
        fail(f"jax or the JAX package was imported: {sorted(loaded)[:5]}")

    sources = {
        "scan_int8": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
                      "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:40"),
        "scan_int8_slots": (
            "vectorsearch_rbac_tpu_torch/csrc/scan_int8.cu",
            "scripts/r4_admit_lab.py:98 (and vectorsearch_rbac_tpu/ops/"
            "pallas_scan_int8.py:40 with mask_sub_block)"),
        "scan_int8_wide": ("vectorsearch_rbac_tpu_torch/csrc/scan_int8_wide.cu",
                           "vectorsearch_rbac_tpu/ops/pallas_scan_int8.py:295"),
        "merge_extract": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                          "vectorsearch_rbac_tpu/ops/pallas_merge.py:55"),
        "merge_bitonic": ("vectorsearch_rbac_tpu_torch/csrc/merge.cu",
                          "vectorsearch_rbac_tpu/ops/pallas_merge.py:79"),
    }
    say(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": result[name][1],
         "ms": result[name][2], "plain_ms": result[name][3]}
        for name, (src, rep) in sources.items()]}))
    say(smi)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
