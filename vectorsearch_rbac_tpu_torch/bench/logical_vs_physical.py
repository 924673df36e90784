"""Logical (no-copy) against physical partition serving at 1M on the card:
the reference's central memory-sharing experiment.

    python -m vectorsearch_rbac_tpu_torch.bench.logical_vs_physical
        [--arms role_logical role_physical dynamic_logical
         dynamic_physical] [--checkpoint PATH] [--device cuda|cpu]

The port's runner for scripts/logical_vs_physical.py, with its sizes and
protocol: sift_like_corpus(1,000,000 x 128, 100 blocks a document, seed
0); the tree world of 100 roles and 10,000 users (h 4, b0 3, b1 4, seed
0); 1,024 queries, default_rng(1) users and pool rows drawn with
replacement; top-10, ef 48, HNSW M 16 and ef_construction 64 on the int8
arena of 131,072-row blocks; truth from the exact float32 oracle (its own
arena, freed before serving). Four arms:

- role_logical: a graph a role (seed = the role), the iterative search
  with sampled entries as probe parameters, the partitions logical and
  served by the GraphProbeBatcher (which, as the reference's, takes the
  graph's entry and a 256-step budget and ignores sampled_entry);
- role_physical: the same graphs, each with its own copy of its rows
  (HNSWIndex logical=False), dispatched a (comb, partition) group at a
  time with sampled entries;
- dynamic_logical: AnonySys at storage alpha 1.5 with index kind
  "hybrid" (packed=False): logical graph partitions under the batcher,
  the flat partitions as logical Int8FlatIndex (query_batch 2,048,
  block_rows 8,192, f32 distances);
- dynamic_physical: the same plan, its graph partitions rebuilt as copies
  from graph_state() (seed = the partition), the batcher dropped, the
  flat partitions keeping their gathered copies.

The script builds the role graphs twice with the same seeds, once a
mode; the builders are deterministic, so both builds give the same
graphs (tests/test_torch_physical.py holds that), and this runner builds
them once (the physical indexes) and makes the logical twins from each
graph_state(); likewise one AnonySys build serves both dynamic arms. An
arm's build_s is the shared build's seconds plus its own assembly's.

Each arm: one warm pass, then 3 passes of the 1,024 queries on the host
clock (each ends in its results on the host), QPS from the median, as the
script measures; recall@10 against the oracle; every returned row must be
readable by its user. Each gives the record's keys (recall_at_10, qps,
avg_latency_ms, storage {shared_vector_mb, partition_vector_mb,
partition_index_mb, total_mb}, num_partitions, build_s), the storage's
graph-batcher share (graph_slab_mb, packed_rows_mb: the port counts the
batcher's slabs and packed rows, the reference does not) and the kernels
the timed passes launched. A physical partition's copy on this arena is
its packed-row table (148 bytes a row at d 128 and 100 roles) where the
reference's is bfloat16 rows (256 bytes) beside their norms and bitsets
(20 bytes).

Each arm is checkpointed to --checkpoint (state/logical_vs_physical.json)
as it is measured, and a rerun skips the measured ones (a layout whose
arms are all measured builds nothing); --arms splits the run across
calls. Prints one JSON line: "protocol" (naming the reference's record,
results/logical_vs_physical.json, whose numbers were taken on a TPU),
"hardware" (the card's nvidia-smi name and power limit) and the arms.
Exits 2 without CUDA unless given --device cpu.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import FrameworkConfig
from ..core import build_device_arena
from ..data import sift_like_corpus
from ..index.flat_int8 import Int8FlatIndex
from ..index.hnsw import CLASSIC_MAX_ROWS, HNSWIndex
from ..partition.base import BuiltPartition, PartitionedSearcher
from ..partition.dynamic import build_dynamic_searcher
from ..partition.graph_batch import GraphProbeBatcher
from ..rbac import TreeRBACGenerator
from . import evidence
from .ground_truth import GroundTruthOracle, compute_recall
from .queries import QueryWorkload

N, NQ, K, EF = 1_000_000, 1024, 10, 48
ARMS = ("role_logical", "role_physical", "dynamic_logical",
        "dynamic_physical")
REFERENCE_RECORD = "results/logical_vs_physical.json"
CHECKPOINT = os.path.join("state", "logical_vs_physical.json")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def protocol(n: int, nq: int) -> Dict:
    return {"n": n, "dim": 128, "queries": nq, "topk": K, "ef": EF,
            "world": "tree RBAC 100 roles / 10k users",
            "reference_mirror": "logical_partition_benchmark/benchmark/src/"
                                "{role,physical_role,dynamic,"
                                "physical_dynamic}_partition_results.json",
            "reference_record": REFERENCE_RECORD + " (taken on a TPU)"}


def make_data(n: int, nq: int, device):
    """The script's corpus, world, queries and users, the int8 arena and
    the exact top-K truth."""
    corpus, qpool = sift_like_corpus(num_vectors=n, blocks_per_doc=100,
                                     seed=0)
    world = TreeRBACGenerator(num_users=10_000, num_roles=100,
                              num_docs=corpus.num_docs, h=4, b0=3, b1=4,
                              seed=0).generate()
    rng = np.random.default_rng(1)
    uids = rng.integers(0, 10_000, size=nq)
    queries = qpool[rng.choice(len(qpool), nq, replace=True)].astype(
        np.float32)
    wl = QueryWorkload(vectors=queries, user_ids=uids, topk=K,
                       selectivities=np.zeros(nq), repetitions=np.ones(nq))
    gt = build_device_arena(corpus, world, device=device, block_rows=65536,
                            dtype="float32")
    truth = GroundTruthOracle(gt, block_rows=65536,
                              query_batch=1024).compute(corpus, world, wl, K)
    del gt
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=131072, dtype="int8")
    return dict(corpus=corpus, world=world, queries=queries, uids=uids,
                truth=truth, arena=arena)


def _role_probe(uid, pid):
    return {"iterative": True, "ef_search": EF, "sampled_entry": True}


def build_role_graphs(data) -> Dict[int, BuiltPartition]:
    """A physical graph a role with rows (seed = the role), in role
    order. Graphs the native builder builds (up to CLASSIC_MAX_ROWS rows)
    build in a thread pool, as partition/base.py build_partition_indexes
    builds them (each is seeded and independent, so the graphs equal a
    one-thread build); the device-built ones in turn."""
    corpus, arena = data["corpus"], data["arena"]
    role_rows = {}
    for role, docs in sorted(data["world"].role_to_docs.items()):
        rows = corpus.rows_for_docs(
            np.fromiter(docs, dtype=np.int64, count=len(docs)))
        if len(rows):
            role_rows[role] = rows

    def build(role):
        return HNSWIndex(arena, role_rows[role], m=16, ef_construction=64,
                         ef_search=EF, query_batch=1024, seed=role,
                         logical=False)

    pooled = [r for r, rows in role_rows.items()
              if len(rows) <= CLASSIC_MAX_ROWS]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        built = dict(zip(pooled, pool.map(build, pooled)))
    return {role: BuiltPartition(pid=role, rows=rows, label=f"role_{role}",
                                 index=built.get(role) or build(role))
            for role, rows in role_rows.items()}


def role_searcher(data, physical: Dict[int, BuiltPartition],
                  logical: bool) -> PartitionedSearcher:
    """The script's build_role_graph_searcher over the shared graphs: the
    physical partitions as they are, or their logical twins under the
    batcher."""
    arena = data["arena"]
    parts = physical
    if logical:
        parts = {pid: BuiltPartition(
            pid=pid, rows=p.rows, label=p.label, index=HNSWIndex(
                arena, p.rows, m=16, ef_search=EF, query_batch=1024,
                graph_state=p.index.graph_state(), logical=True))
            for pid, p in physical.items()}
    u2r = data["world"].user_to_roles

    def router(uid):
        return tuple(r for r in u2r.get(uid, ()) if r in parts)

    s = PartitionedSearcher(arena, parts, router, name="role_hnsw_"
                            + ("logical" if logical else "physical"))
    s.probe_params = _role_probe
    if logical:
        s.graph_batcher = GraphProbeBatcher(
            arena, {pid: p.index for pid, p in parts.items()})
    return s


def dynamic_base(data) -> PartitionedSearcher:
    """The script's AnonySys build (kind hybrid, alpha 1.5, packed=False)."""
    cfg = FrameworkConfig(seed=0)
    cfg.index.kind = "hybrid"
    cfg.index.hnsw_m = 16
    cfg.index.hnsw_ef_construction = 64
    cfg.search.ef_search = EF
    cfg.optimizer.storage_alpha = 1.5
    cfg.optimizer.topk = K
    return build_dynamic_searcher(data["corpus"], data["world"],
                                  data["arena"], cfg, packed=False)


def dynamic_searcher(data, base: PartitionedSearcher,
                     logical: bool) -> PartitionedSearcher:
    """The script's build_dynamic_graph_searcher arms over one build:
    logical (flat partitions as logical Int8FlatIndex, the batcher kept)
    or physical (graph partitions as copies from graph_state(), no
    batcher)."""
    arena = data["arena"]
    parts = {}
    for pid, p in base.partitions.items():
        idx = p.index
        if logical and isinstance(idx, Int8FlatIndex) and not idx.logical \
                and p.rows is not None:
            idx = Int8FlatIndex(arena, p.rows, query_batch=2048,
                                block_rows=8192, logical=True)
        elif not logical and isinstance(idx, HNSWIndex) and idx.logical:
            idx = HNSWIndex(arena, p.rows, m=16, ef_construction=64,
                            ef_search=EF, query_batch=1024, seed=pid,
                            logical=False, graph_state=idx.graph_state())
        parts[pid] = BuiltPartition(pid=pid, rows=p.rows, index=idx,
                                    label=p.label)
    s = PartitionedSearcher(arena, parts, base.router,
                            name="dynamic_" + ("logical" if logical
                                               else "physical"))
    s.plan = base.plan
    s.probe_params = base.probe_params
    if logical and getattr(base, "graph_batcher", None) is not None:
        s.graph_batcher = base.graph_batcher
    return s


def measure(name: str, searcher, data, build_s: float) -> Dict:
    """The script's measure(): a warm pass, 3 timed passes (median), the
    recall, the storage split; the kernels the timed passes launched and
    the readable check on their ids."""
    q, uids = data["queries"], data["uids"]
    masks = data["world"].user_masks
    searcher.search_batch(q, uids, masks, K)
    before = evidence.launch_counts()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, ids = searcher.search_batch(q, uids, masks, K)
        walls.append(time.perf_counter() - t0)
    launches = evidence.launches_since(before)
    evidence.readable_or_raise(name, ids, masks[uids],
                               data["arena"].host_bits)
    wall = float(np.median(walls))
    st = searcher.storage_report()
    return {
        f"recall_at_{K}": round(compute_recall(ids, data["truth"]), 4),
        "qps": round(len(q) / wall, 1),
        "avg_latency_ms": round(wall / len(q) * 1000, 4),
        "pass_walls_s": [round(w, 4) for w in walls],
        "storage": {
            "shared_vector_mb": round(st["arena_vectors_mb"]
                                      + st["arena_aux_mb"], 1),
            "partition_vector_mb": round(st["partition_vectors_mb"], 1),
            "partition_index_mb": round(st["partition_index_mb"], 1),
            "graph_slab_mb": round(st["graph_slab_mb"], 1),
            "packed_rows_mb": round(st["packed_rows_mb"], 1),
            "total_mb": round(st["total_mb"], 1),
        },
        "num_partitions": st["num_partitions"],
        "build_s": round(build_s, 1),
        "kernels": launches,
    }


def run(arms: Sequence[str], device, n: int = N, nq: int = NQ,
        out: Optional[Dict] = None, checkpoint: Optional[str] = None
        ) -> Dict:
    """The record with the arms in `arms` that `out` does not hold yet
    measured and checkpointed one by one."""
    out = out if out is not None else {}
    out.setdefault("protocol", protocol(n, nq))
    out.setdefault("hardware", evidence.hardware(device))
    todo = [a for a in ARMS if a in arms and a not in out]
    if not todo:
        log("all arms checkpointed: skip")
        return out
    t0 = time.perf_counter()
    data = make_data(n, nq, device)
    log(f"data: {time.perf_counter() - t0:.1f}s")
    for layout in ("role", "dynamic"):
        mine = [a for a in todo if a.startswith(layout)]
        if not mine:
            continue
        t0 = time.perf_counter()
        if layout == "role":
            base = build_role_graphs(data)
        else:
            base = dynamic_base(data)
        shared_s = time.perf_counter() - t0
        log(f"[{layout}] shared build: {shared_s:.1f}s")
        for arm in mine:
            logical = arm.endswith("logical")
            t0 = time.perf_counter()
            s = (role_searcher(data, base, logical) if layout == "role"
                 else dynamic_searcher(data, base, logical))
            row = measure(arm, s, data, shared_s + time.perf_counter() - t0)
            row["hardware"] = evidence.hardware(device)
            out[arm] = row
            log(f"[{arm}] " + json.dumps(row))
            evidence.save_checkpoint(checkpoint, out)
            del s
            gc.collect()
        del base
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", nargs="+", choices=ARMS, default=list(ARMS),
                    help="the arms to run (default all four)")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the arms measured so far (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device,
                                     "bench.logical_vs_physical")
    if device is None:
        return 2
    out = evidence.load_checkpoint(args.checkpoint) or {}
    if out:
        log(f"resuming: {sorted(a for a in ARMS if a in out)} checkpointed")
    out["hardware"] = evidence.hardware(device)
    out = run(args.arms, device, out=out, checkpoint=args.checkpoint)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
