"""Materialize a PartitionPlan into a searcher (the AnonySys strategy).

Counterpart of vectorsearch_rbac_tpu/partition/dynamic/materialize.py:
planning (greedy split, heavy-partition refinement, renumbering, the
coverage check), then the plan's partitions over the shared arena with the
comb -> partitions router. Every partition scan checks permissions in the
fused scan, so a partition that also holds rows a comb may not read needs
nothing more. The packed layout (index kind flat or flat_approx) is the
TiledSearcher on an int8 l2 arena and the PackedSearcher on any other;
packed=False, or index kind "ivf", builds one index per partition
(make_partition_index: an Int8FlatIndex, or an IVFIndex).

Index kind "hybrid" (the reference's hybrid executor) serves a partition
from a logical HNSW graph when every comb routed to it keeps
within-partition selectivity >= cfg.index.hybrid_sel_threshold, and from
the int8 flat scan otherwise (the mixed alpha-budget remainder); "hnsw"
serves every partition from a graph. Both are the unpacked layout, with
per-(comb, partition) probe parameters (iterative-rescan budget, ef,
2-hop harvest, the admissible entry nearest the comb's centroid) and the
GraphProbeBatcher over the graph partitions (given a device mesh, the
ShardedGraphSearcher across its devices). The graphs are built in a
thread pool (each build is seeded and independent, and the native builder
releases the GIL), so they equal a one-thread build.

apply_plan_update puts a plan changed by a role insert or delete
(maintenance.py) on the device: the one-index-a-partition layout rebuilds
only the partitions whose documents changed and keeps the others' index
objects; the TiledSearcher and PackedSearcher layouts and the hybrid
executor are rebuilt whole, as in the reference.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional, Set, Tuple

import numpy as np
from torch.profiler import record_function

from ...config import FrameworkConfig, get_logger
from ...core import Corpus, DeviceArena
from ...models.cost import CostModelParams
from ...rbac import Comb, RBACWorld
from ..base import (BuiltPartition, PartitionedSearcher,
                    build_partition_indexes, make_partition_index)
from ..strategies import packed_searcher, unpacked_searcher
from .optimizer import PartitionPlan, PlannerInputs, split_comb_roles
from .refine import rebalance_heavy_partition

logger = get_logger("dynamic.materialize")


def clean_and_reindex(plan: PartitionPlan) -> PartitionPlan:
    """Drop empty partitions and renumber 0..c-1, remapping tracker pids."""
    non_empty = {pid: docs for pid, docs in plan.assignment.items() if docs}
    mapping = {old: new for new, old in enumerate(sorted(non_empty))}
    assignment = {mapping[old]: docs for old, docs in non_empty.items()}
    trackers = {}
    for comb, parts in plan.trackers.items():
        trackers[comb] = {mapping[pid]: roles for pid, roles in parts.items()
                          if pid in mapping and roles}
    return PartitionPlan(assignment=assignment, trackers=trackers,
                         split_log=plan.split_log)


def validate_partition_coverage(plan: PartitionPlan,
                                inputs: PlannerInputs) -> None:
    """Every comb's documents must be covered by its tracked partitions."""
    for comb, parts in plan.trackers.items():
        docs = inputs.comb_docs(comb)
        covered: Set[int] = set()
        for pid in parts:
            covered |= plan.assignment.get(pid, set())
        missing = docs - covered
        assert not missing, (
            f"comb {comb}: {len(missing)} documents uncovered by partitions "
            f"{sorted(parts)}")


def plan_dynamic_partitions(world: RBACWorld, inputs: PlannerInputs,
                            refine_heavy: bool = True) -> PartitionPlan:
    """Greedy split -> heavy-partition refinement -> cleanup/renumber ->
    coverage validation, under the span dynamic.plan (its children
    dynamic.split and dynamic.refine)."""
    with record_function("dynamic.plan"):
        t0 = time.perf_counter()
        with record_function("dynamic.split"):
            plan = split_comb_roles(inputs)
        logger.info("split_comb_roles: %d partitions, %d splits, %.2fs",
                    len(plan.assignment), len(plan.split_log),
                    time.perf_counter() - t0)
        if refine_heavy and plan.assignment:
            largest = max(plan.assignment,
                          key=lambda pid: len(plan.assignment[pid]))
            if len(plan.assignment[largest]) > 0:
                with record_function("dynamic.refine"):
                    plan = rebalance_heavy_partition(plan, inputs,
                                                     target_pid=largest)
        plan = clean_and_reindex(plan)
        validate_partition_coverage(plan, inputs)
    logger.info("plan_dynamic_partitions: %d partitions, load %d, %.2fs",
                len(plan.assignment), sum(plan.loads.values()),
                time.perf_counter() - t0)
    return plan


def planner_inputs(corpus: Corpus, world: RBACWorld, cfg: FrameworkConfig,
                   comb_weights=None, single_role_weights=None
                   ) -> PlannerInputs:
    """The planner's inputs from the world and cfg.optimizer (the
    reference's defaults: the world's comb weights, uniform single-role
    weights)."""
    o = cfg.optimizer
    return PlannerInputs(
        role_to_docs=world.role_to_docs,
        combs=world.combs,
        comb_weights=comb_weights or world.comb_weights,
        single_role_weights=single_role_weights or {
            r: 1.0 / max(world.num_roles, 1) for r in range(world.num_roles)},
        params=CostModelParams(
            k=o.recall_k, beta=o.recall_beta, a=o.qps_a, b=o.qps_b,
            join_time=o.join_time, ef_offset=o.ef_offset, n_ref=o.n_ref,
            gamma_n=o.gamma_n),
        alpha=o.storage_alpha,
        topk=o.topk,
        target_recall=o.target_recall,
        avg_blocks_per_doc=corpus.avg_blocks_per_doc,
    )


def _plan_router(plan: PartitionPlan, world: RBACWorld, pids):
    """The plan's user router: a user's comb goes to the partitions its
    tracker names (those in `pids`); an unseen comb to the union of its
    single roles' partitions."""
    comb_to_pids: Dict[Comb, Tuple[int, ...]] = {
        comb: tuple(sorted(p for p in parts if p in pids))
        for comb, parts in plan.trackers.items()
    }
    user_to_roles = world.user_to_roles

    def router(uid: int):
        comb = tuple(user_to_roles.get(uid, ()))
        found = comb_to_pids.get(comb)
        if found:
            return found
        acc = []
        for r in comb:
            acc.extend(comb_to_pids.get((r,), ()))
        return tuple(sorted(set(acc)))

    return router


def build_dynamic_searcher(
    corpus: Corpus,
    world: RBACWorld,
    arena: DeviceArena,
    cfg: FrameworkConfig,
    plan: Optional[PartitionPlan] = None,
    inputs: Optional[PlannerInputs] = None,
    comb_weights: Optional[Dict[Comb, float]] = None,
    single_role_weights: Optional[Dict[int, float]] = None,
    packed: bool = True,
    mesh=None,
):
    """Build the AnonySys searcher; plans first if no plan is given (a plan
    from the JAX package comes in through plan_from_reference). The
    searcher keeps its plan as `.plan`.

    mesh: a device mesh (parallel/mesh.py). The graph executors' logical
    HNSW partitions are then placed across its devices (graph slabs per
    device; parallel/graph_sharded.py ShardedGraphSearcher) in place of
    the one-device GraphProbeBatcher; probe routing and merging are the
    same (the two share run()). Other index kinds ignore it, as in the
    reference."""
    if plan is None:
        if inputs is None:
            inputs = planner_inputs(corpus, world, cfg, comb_weights,
                                    single_role_weights)
        plan = plan_dynamic_partitions(world, inputs)

    partition_rows: Dict[int, np.ndarray] = {}
    for pid, docs in sorted(plan.assignment.items()):
        rows = corpus.rows_for_docs(np.fromiter(docs, dtype=np.int64,
                                                count=len(docs)))
        if len(rows):
            partition_rows[pid] = rows

    router = _plan_router(plan, world, partition_rows)
    if cfg.index.kind not in ("hnsw", "hybrid"):
        if packed and cfg.index.kind in ("flat", "flat_approx"):
            searcher = packed_searcher(arena, partition_rows, router,
                                       "dynamic", cfg,
                                       big_logical=cfg.index.big_logical)
        else:
            searcher = unpacked_searcher(arena, partition_rows, router,
                                         "dynamic", cfg)
        searcher.plan = plan
        return searcher
    return _graph_searcher(corpus, world, arena, cfg, plan, partition_rows,
                           router, mesh)


def hybrid_graph_pids(world: RBACWorld, plan: PartitionPlan,
                      partition_rows: Dict[int, np.ndarray],
                      threshold: float) -> Set[int]:
    """The partitions the hybrid executor serves from graphs: those where
    every comb routed to them keeps within-partition selectivity (its
    documents in the partition over the partition's documents) >=
    threshold."""
    sel_min = {pid: 1.0 for pid in partition_rows}
    for comb, parts in plan.trackers.items():
        cdocs: Set[int] = set()
        for r in comb:
            cdocs.update(world.role_to_docs.get(r, ()))
        for pid in parts:
            pdocs = plan.assignment.get(pid, set())
            if pid in sel_min and pdocs:
                sel_min[pid] = min(sel_min[pid],
                                   len(cdocs & pdocs) / len(pdocs))
    return {pid for pid, s in sel_min.items() if s >= threshold}


def _graph_searcher(corpus, world, arena, cfg, plan, partition_rows, router,
                    mesh=None):
    """The hybrid and HNSW executors (the reference's :175-327):
    per-partition indexes, probe parameters and the graph batcher, or with
    a mesh the sharded graph searcher."""
    from ...index.hnsw import HNSWIndex
    from ..graph_batch import GraphProbeBatcher

    hybrid = cfg.index.kind == "hybrid"
    cfg_flat = copy.deepcopy(cfg)
    cfg_flat.index.kind = "flat_approx"
    graph_pids = (hybrid_graph_pids(world, plan, partition_rows,
                                    cfg.index.hybrid_sel_threshold)
                  if hybrid else set(partition_rows))
    if hybrid:
        logger.info("hybrid dynamic: %d/%d partitions serve graphs (min "
                    "comb sel >= %.2f)", len(graph_pids),
                    len(partition_rows), cfg.index.hybrid_sel_threshold)

    cfg_graph = copy.deepcopy(cfg)
    cfg_graph.index.kind = "hnsw"
    # both executors' graphs serve from the shared arena (logical mode),
    # so that the batcher can stack them (the reference's :205, :213-217)
    cfg_graph.index.hnsw_logical = True
    t0 = time.perf_counter()
    built = build_partition_indexes(
        arena, {pid: partition_rows[pid] for pid in sorted(graph_pids)},
        cfg_graph)
    graph_build_s = time.perf_counter() - t0
    partitions = {
        pid: BuiltPartition(
            pid=pid, rows=rows,
            index=(built[pid] if pid in built
                   else make_partition_index(arena, rows, cfg_flat)),
            label=f"dynamic_{pid}")
        for pid, rows in partition_rows.items()}
    searcher = PartitionedSearcher(arena, partitions, router, name="dynamic")
    searcher.plan = plan
    searcher.graph_build_s = graph_build_s
    searcher.probe_params = _probe_params(corpus, world, cfg, plan,
                                          partition_rows, graph_pids)
    gparts = {pid: p.index for pid, p in partitions.items()
              if isinstance(p.index, HNSWIndex)}
    if gparts and mesh is not None:
        from ...parallel.graph_sharded import ShardedGraphSearcher

        states = {pid: {"neighbors": ix._hgraph, "entry": ix.entry,
                        "row_map": ix._hrmap} for pid, ix in gparts.items()}
        searcher.graph_batcher = ShardedGraphSearcher(
            arena, states, mesh, partition_weights={
                pid: float(len(partitions[pid].rows)) for pid in gparts})
    elif gparts:
        searcher.graph_batcher = GraphProbeBatcher(arena, gparts)
    return searcher


def _probe_params(corpus, world, cfg, plan, partition_rows, graph_pids):
    """probe_params(uid, pid) -> the iterative search's kwargs for a graph
    partition, None for a flat one (the reference's :248-306): ef from
    cfg.search.ef_search, a step budget ~ 4 k / selectivity (power-of-two
    buckets, at most 4096), the 2-hop harvest below selectivity 0.15, and
    the entry at the comb's admissible row nearest their centroid."""
    base_ef = max(cfg.search.ef_search, 16)
    topk = max(cfg.optimizer.topk, 10)
    cache: Dict[tuple, dict] = {}
    user_to_roles = world.user_to_roles

    def _pow2(x: float) -> int:
        return 1 << int(np.ceil(np.log2(max(x, 1))))

    def probe_params(uid: int, pid: int) -> Optional[dict]:
        if pid not in graph_pids:
            return None
        comb = tuple(user_to_roles.get(uid, ()))
        kw = cache.get((comb, pid))
        if kw is None:
            pdocs = plan.assignment.get(pid, set())
            cdocs: Set[int] = set()
            for r in comb:
                cdocs.update(world.role_to_docs.get(r, ()))
            adocs = cdocs & pdocs
            sel = len(adocs) / max(len(pdocs), 1)
            kw = {"iterative": True,
                  "ef_search": min(_pow2(max(base_ef, 2 * topk)), 512),
                  "max_steps": int(min(_pow2(4 * topk / max(sel, 0.01)),
                                       4096)),
                  "harvest_2hop": sel < 0.15}
            rows = partition_rows.get(pid)
            if rows is not None and adocs:
                adm = np.isin(corpus.doc_ids[rows], np.fromiter(
                    adocs, dtype=np.int64, count=len(adocs)))
                local = np.nonzero(adm)[0]
                if len(local):
                    sub = corpus.vectors[rows[local]]
                    mean = sub.mean(axis=0, keepdims=True)
                    kw["entry_local"] = int(
                        local[np.argmin(((sub - mean) ** 2).sum(axis=1))])
            cache[(comb, pid)] = kw
        return kw

    return probe_params


def apply_plan_update(searcher, corpus: Corpus, world: RBACWorld,
                      cfg: FrameworkConfig,
                      new_plan: PartitionPlan) -> PartitionedSearcher:
    """Re-materialize `searcher` (built from its `.plan` on its arena)
    for `new_plan` after a role insert or delete (the reference's
    incremental reload, which skips unchanged partition tables). The
    one-index-a-partition layout keeps each partition whose documents did
    not change (the same index object) and builds the others; the
    TiledSearcher and PackedSearcher layouts (stacked chunks and buckets)
    and the hybrid executor (whose per-partition index kind follows the
    plan) are rebuilt whole through build_dynamic_searcher. As in the
    reference, the partition-by-partition path returns a plain
    PartitionedSearcher: an "hnsw" searcher's probe parameters and graph
    batcher are not carried over."""
    from ..packed import PackedSearcher
    from ..tiled import TiledSearcher

    if isinstance(searcher, (TiledSearcher, PackedSearcher)):
        return build_dynamic_searcher(corpus, world, searcher.arena, cfg,
                                      plan=new_plan, packed=True)
    if cfg.index.kind == "hybrid":
        return build_dynamic_searcher(corpus, world, searcher.arena, cfg,
                                      plan=new_plan, packed=False)
    old_plan: PartitionPlan = searcher.plan
    arena = searcher.arena
    keep: Dict[int, BuiltPartition] = {}
    changed: Dict[int, np.ndarray] = {}
    for pid, docs in sorted(new_plan.assignment.items()):
        if not docs:
            continue
        old = searcher.partitions.get(pid)
        if old is not None and old_plan.assignment.get(pid) == docs:
            keep[pid] = old     # unchanged: the same index object
            continue
        rows = corpus.rows_for_docs(np.fromiter(docs, dtype=np.int64,
                                                count=len(docs)))
        if len(rows):
            changed[pid] = rows
    built = build_partition_indexes(arena, changed, cfg)
    partitions = {pid: keep[pid] if pid in keep else BuiltPartition(
        pid=pid, rows=changed[pid], index=built[pid], label=f"dynamic_{pid}")
        for pid in sorted({*keep, *changed})}
    logger.info("plan update: %d partitions rebuilt, %d reused",
                len(changed), len(keep))

    out = PartitionedSearcher(arena, partitions,
                              _plan_router(new_plan, world, partitions),
                              name="dynamic")
    out.plan = new_plan
    return out
