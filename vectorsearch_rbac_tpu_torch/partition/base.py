"""Partitioned search: partitions as data and a batched multi-tenant engine.

Counterpart of vectorsearch_rbac_tpu/partition/base.py: the index factory
and the PartitionedSearcher a strategy returns. A strategy is partitions
over the shared arena plus a router from user to partition ids; the engine
groups a query batch by partition so that each index scans all of its
queries at once, enqueues every partition's scans before the first sync
(deferred dispatch), and merges a query's partitions on the host with
row-id dedupe, once per tuple of partitions. A strategy may expose
`probe_params(uid, pid)` (per-(user, partition) search kwargs: the hybrid
and HNSW AnonySys executors' iterative-rescan budgets and entries), whose
queries then sub-group by those kwargs, and a `graph_batcher`
(partition/graph_batch.py) that serves the probe groups of its logical HNSW
partitions in slab dispatches; physical HNSW partitions (each with its own
copy of its rows) serve their probe groups one (comb, partition) group
after another, as the reference's do. A searcher's StageTimer (`.timer`)
keeps the reference's stages (route, device_scan, merge) beside the
profiler spans partitioned.*.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from torch.profiler import record_function

from ..config import FrameworkConfig
from ..core import DeviceArena
from ..index.flat import FlatIndex
from ..index.flat_int8 import Int8FlatIndex
from ..ops.topk import merge_topk_host
from ..rbac import query_masks_for
from ..utils.tracing import StageTimer


def make_partition_index(arena: DeviceArena, rows: Optional[np.ndarray],
                         cfg: FrameworkConfig):
    """Index factory over the whole arena (rows=None) or a partition's
    rows, the reference's: "flat_approx" on a quantized arena is the int8
    fused scan (the configured wire on the global index; "f32" on
    partitions, whose results are merged across partitions and must keep
    their distances); "flat" and "flat_approx" otherwise a FlatIndex in
    exact or approx mode; "ivf" an IVFIndex over the rows
    (cfg.index.ivf_nlist lists, cfg.search.nprobe probes); "binary" a
    BinaryQuantIndex (cfg.index.binary_*); "hnsw" an HNSWIndex over the
    rows (the ACORN builder where cfg.index.hnsw_m_beta is set), with its
    own copy of the rows unless cfg.index.hnsw_logical. "hybrid"
    is the AnonySys graph executor's (partition/dynamic/materialize.py),
    an unknown kind here, as in the reference."""
    kind = cfg.index.kind
    if kind == "flat_approx" and arena.quant is not None:
        return Int8FlatIndex(arena, rows, query_batch=cfg.search.batch_size,
                             block_rows=min(cfg.search.block_rows, 8192),
                             wire=cfg.search.wire_dist if rows is None
                             else "f32")
    if kind in ("flat", "flat_approx"):
        return FlatIndex(arena, rows, block_rows=cfg.search.block_rows,
                         mode="exact" if kind == "flat" else "approx",
                         query_batch=cfg.search.batch_size)
    if kind == "ivf":
        from ..index.ivf import IVFIndex
        return IVFIndex(arena, rows, nlist=cfg.index.ivf_nlist,
                        nprobe=cfg.search.nprobe,
                        kmeans_iters=cfg.index.ivf_kmeans_iters,
                        query_batch=cfg.search.batch_size, seed=cfg.seed)
    if kind == "binary":
        from ..index.binary import BinaryQuantIndex
        return BinaryQuantIndex(arena, rows,
                                query_batch=cfg.search.batch_size,
                                rerank_mult=cfg.index.binary_rerank_mult,
                                rerank=cfg.index.binary_rerank,
                                bit_metric=cfg.index.binary_bit_metric)
    if kind == "hnsw":
        from ..index.hnsw import HNSWIndex
        return HNSWIndex(arena, rows, m=cfg.index.hnsw_m,
                         ef_construction=cfg.index.hnsw_ef_construction,
                         ef_search=cfg.search.ef_search,
                         query_batch=cfg.search.batch_size,
                         builder="acorn" if cfg.index.hnsw_m_beta else "auto",
                         m_beta=cfg.index.hnsw_m_beta or 64,
                         logical=cfg.index.hnsw_logical)
    raise ValueError(f"unknown index kind {kind!r}")


def build_partition_indexes(arena: DeviceArena,
                            partition_rows: Dict[int, np.ndarray],
                            cfg: FrameworkConfig) -> Dict[int, object]:
    """make_partition_index over each partition's rows, in partition_rows'
    order: the strategies' and the graph executor's one builder. HNSW
    partitions that the native builders build (the classic one up to
    CLASSIC_MAX_ROWS rows, or the ACORN one) build in a thread pool: each
    build is seeded and independent and the native call releases the GIL,
    so the graphs equal a one-thread build. Every other index builds in
    turn, device-built HNSW graphs included: their kNN runs inside
    exact_f32_matmul, which sets and restores torch's process-wide matmul
    precision, so two such builds in threads could restore each other's
    setting mid-build."""
    from ..index.hnsw import CLASSIC_MAX_ROWS

    def build(pid):
        return make_partition_index(arena, partition_rows[pid], cfg)

    native = [pid for pid, rows in partition_rows.items()
              if cfg.index.kind == "hnsw" and (
                  cfg.index.hnsw_m_beta or len(rows) <= CLASSIC_MAX_ROWS)]
    out = {}
    if len(native) > 1:
        workers = min(len(native), os.cpu_count() or 1)
        with ThreadPoolExecutor(max_workers=workers) as pool:
            out = dict(zip(native, pool.map(build, native)))
    return {pid: out[pid] if pid in out else build(pid)
            for pid in partition_rows}


@dataclass
class BuiltPartition:
    pid: int
    rows: Optional[np.ndarray]   # arena row ids; None = whole arena
    index: object
    label: str = ""


class PartitionedSearcher:
    """A strategy instance: partitions + a user -> partitions router.
    router None (the global strategy) sends every query to the one
    partition without a per-query routing loop.

    A strategy that routes by query vector as well (QDTree) sets
    `batch_router(queries, user_ids)` -> one tuple of partition ids a
    query, and `vector_router(uid, qvec)` -> a query's tuple; a pass asks
    the batch router first, then the vector router, then the user
    router, as the reference's TiledSearcher does."""

    def __init__(self, arena: DeviceArena,
                 partitions: Dict[int, BuiltPartition],
                 router: Optional[Callable[[int], Sequence[int]]],
                 name: str):
        if router is None and len(partitions) != 1:
            raise ValueError("only a one-partition searcher may go without "
                             "a router")
        self.arena = arena
        self.partitions = partitions
        self.router = router
        self.name = name
        self.batch_router: Optional[Callable] = None
        self.vector_router: Optional[Callable] = None
        self.timer = StageTimer()

    def search_batch(self, queries: np.ndarray, user_ids: np.ndarray,
                     user_masks: np.ndarray,
                     k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (dists (Q, k), arena_row_ids (Q, k)); -1/inf pads. The
        span partitioned.search_batch covers the whole call, finalize()
        included: the root of a request's spans."""
        with record_function("partitioned.search_batch"):
            return self.search_batch_deferred(queries, user_ids, user_masks,
                                              k)()

    def search_batch_deferred(self, queries: np.ndarray,
                              user_ids: np.ndarray, user_masks: np.ndarray,
                              k: int):
        """Enqueue a pass and return finalize() -> (dists, ids). Without a
        router the one partition takes every query and its index's
        finalize is returned as is: an index with a user table
        (Int8FlatIndex) keeps `user_masks` resident and takes the 2-byte
        user ids, as the reference's global path does; otherwise every
        touched partition's scans are enqueued here and finalize() drains
        them and merges."""
        queries = np.asarray(queries, dtype=np.float32)
        user_ids = np.asarray(user_ids)
        if self.router is None:
            (part,) = self.partitions.values()
            if hasattr(part.index, "set_user_table"):
                part.index.set_user_table(user_masks)
                if part.index._user_table is not None:
                    return part.index.search_deferred(queries, None, k,
                                                      user_ids=user_ids)
            return part.index.search_deferred(
                queries, query_masks_for(user_masks, user_ids), k)
        qmasks = query_masks_for(user_masks, user_ids)

        nq = queries.shape[0]
        pid_to_queries: Dict[int, List[int]] = {}
        per_query_pids: List[Sequence[int]] = []
        with record_function("partitioned.route"), self.timer.stage("route"):
            routed = route_batch(self, queries, user_ids)
            for qi, pids in enumerate(routed):
                per_query_pids.append(pids)
                for pid in pids:
                    pid_to_queries.setdefault(pid, []).append(qi)
        probe_params = getattr(self, "probe_params", None)
        batcher = getattr(self, "graph_batcher", None)
        deferred, part_results, graph_jobs = {}, {}, []
        with record_function("partitioned.enqueue"), \
                self.timer.stage("device_scan"):
            for pid, qidx in pid_to_queries.items():
                part = self.partitions[pid]
                # probe kwargs sub-group the partition's queries; None for a
                # (user, partition) pair means a plain scan (the hybrid's
                # flat partitions)
                by_kw = None
                if probe_params is not None:
                    by_kw = {}
                    for qi in qidx:
                        kw = probe_params(int(user_ids[qi]), pid)
                        key = None if kw is None else tuple(sorted(kw.items()))
                        by_kw.setdefault(key, []).append(qi)
                    if set(by_kw) == {None}:
                        by_kw = None
                if by_kw is None:
                    deferred[pid] = part.index.search_deferred(
                        queries[qidx], qmasks[qidx], k)
                    continue
                pos = {qi: j for j, qi in enumerate(qidx)}
                d = np.full((len(qidx), k), np.inf, dtype=np.float32)
                i = np.full((len(qidx), k), -1, dtype=np.int64)
                part_results[pid] = (d, i, pos)
                for kw_items, qsub in by_kw.items():
                    kw = dict(kw_items) if kw_items else {}
                    if batcher is not None and pid in batcher.pids:
                        graph_jobs.append((pid, qsub, kw))
                        continue
                    dd, ii = part.index.search(queries[qsub], qmasks[qsub],
                                               k, **kw)
                    rows = [pos[qi] for qi in qsub]
                    d[rows], i[rows] = dd, ii
        if graph_jobs:
            with record_function("partitioned.graph"), \
                    self.timer.stage("device_scan"):
                for (pid, qsub, _), (dd, ii) in zip(
                        graph_jobs,
                        batcher.run(queries, qmasks, graph_jobs, k)):
                    d, i, pos = part_results[pid]
                    rows = [pos[qi] for qi in qsub]
                    d[rows], i[rows] = dd, ii

        def finalize():
            with self.timer.stage("device_scan"):
                for pid, fin in deferred.items():
                    d, i = fin()
                    pos = {qi: j for j, qi in enumerate(pid_to_queries[pid])}
                    part_results[pid] = (d, i, pos)
            with self.timer.stage("merge"):
                return _merge_partitions(part_results, per_query_pids, nq, k)

        return finalize

    def search_user(self, user_id: int, query: np.ndarray,
                    user_masks: np.ndarray, k: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """One query of one user: (dists (k,), arena row ids (k,))."""
        d, i = self.search_batch(
            np.asarray(query, dtype=np.float32)[None, :],
            np.array([user_id]), user_masks, k)
        return d[0], i[0]

    def storage_report(self) -> Dict[str, float]:
        """MB accounting: the shared arena plus per-partition structures,
        and the graph batcher's own device copies (its graph and row-map
        slabs, and the packed rows it scores from). The reference leaves
        the batcher out; the port counts it (ROADMAP queue 3)."""
        a = self.arena
        arena_vec = a.n_padded * a.dim * a.vectors.element_size()
        arena_aux = a.n_padded * (4 + 4 * a.role_bits.shape[1])
        part_vec = part_idx = 0
        for p in self.partitions.values():
            sb = p.index.storage_bytes()
            part_vec += sb["vectors"]
            part_idx += sb["index"]
        batcher = getattr(self, "graph_batcher", None)
        gb = ({"graph_slabs": 0, "packed_rows": 0} if batcher is None
              else batcher.storage_bytes())
        mb = 1024 * 1024
        return {
            "arena_vectors_mb": arena_vec / mb,
            "arena_aux_mb": arena_aux / mb,
            "partition_vectors_mb": part_vec / mb,
            "partition_index_mb": part_idx / mb,
            "graph_slab_mb": gb["graph_slabs"] / mb,
            "packed_rows_mb": gb["packed_rows"] / mb,
            "total_mb": (arena_vec + arena_aux + part_vec + part_idx
                         + gb["graph_slabs"] + gb["packed_rows"]) / mb,
            "num_partitions": len(self.partitions),
        }


def route_batch(searcher, queries: np.ndarray, user_ids: np.ndarray
                ) -> List[Sequence[int]]:
    """Each query's partition ids: the searcher's batch_router where it
    has one, else its vector_router query by query, else its user
    router."""
    if searcher.batch_router is not None:
        return list(searcher.batch_router(queries, user_ids))
    if searcher.vector_router is not None:
        return [searcher.vector_router(int(u), q)
                for u, q in zip(user_ids, queries)]
    return [searcher.router(int(u)) for u in user_ids]


def _merge_partitions(part_results, per_query_pids, nq: int, k: int):
    """Per-query merge across partitions with row-id dedupe: a query of one
    partition copies its rows; queries of several group by their tuple of
    partitions (the queries of one comb route alike), so the merge runs
    once per tuple over stacked rows."""
    out_d = np.full((nq, k), np.inf)
    out_i = np.full((nq, k), -1, dtype=np.int64)
    with record_function("partitioned.merge"):
        single_by_pid: Dict[int, List[int]] = {}
        multi_by_pids: Dict[tuple, List[int]] = {}
        for qi, pids in enumerate(per_query_pids):
            if len(pids) == 1:
                single_by_pid.setdefault(pids[0], []).append(qi)
            elif pids:
                multi_by_pids.setdefault(tuple(pids), []).append(qi)
        for pid, qis in single_by_pid.items():
            d, i, pos = part_results[pid]
            rows = [pos[qi] for qi in qis]
            out_d[qis] = d[rows]
            out_i[qis] = i[rows]
        for pids, qis in multi_by_pids.items():
            ds, is_ = [], []
            for pid in pids:
                d, i, pos = part_results[pid]
                rows = [pos[qi] for qi in qis]
                ds.append(d[rows])
                is_.append(i[rows])
            out_d[qis], out_i[qis] = merge_topk_host(ds, is_, k)
    return out_d, out_i
