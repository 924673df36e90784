"""Materialize a PartitionPlan into a searcher (the AnonySys strategy).

Counterpart of vectorsearch_rbac_tpu/partition/dynamic/materialize.py:
planning (greedy split, heavy-partition refinement, renumbering, the
coverage check), then the plan's partitions over the shared arena with the
comb -> partitions router. Every partition scan checks permissions in the
fused scan, so a partition that also holds rows a comb may not read needs
nothing more. On an int8 l2 arena the packed layout is the TiledSearcher;
packed=False builds one Int8FlatIndex per partition. The HNSW and hybrid
executors are ROADMAP slice 4, the incremental plan update
(apply_plan_update) slice 5.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Set, Tuple

import numpy as np

from ...config import FrameworkConfig, get_logger
from ...core import Corpus, DeviceArena
from ...models.cost import CostModelParams
from ...rbac import Comb, RBACWorld
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
    coverage validation."""
    t0 = time.perf_counter()
    plan = split_comb_roles(inputs)
    logger.info("split_comb_roles: %d partitions, %d splits, %.2fs",
                len(plan.assignment), len(plan.split_log),
                time.perf_counter() - t0)
    if refine_heavy and plan.assignment:
        largest = max(plan.assignment,
                      key=lambda pid: len(plan.assignment[pid]))
        if len(plan.assignment[largest]) > 0:
            plan = rebalance_heavy_partition(plan, inputs, target_pid=largest)
    plan = clean_and_reindex(plan)
    validate_partition_coverage(plan, inputs)
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
):
    """Build the AnonySys searcher; plans first if no plan is given (a plan
    from the JAX package comes in through plan_from_reference). The
    searcher keeps its plan as `.plan`."""
    if cfg.index.kind in ("hnsw", "hybrid"):
        raise NotImplementedError(
            f"dynamic partitions with index kind {cfg.index.kind!r}: the "
            "HNSW and hybrid executors are ROADMAP slice 4, not ported")
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

    comb_to_pids: Dict[Comb, Tuple[int, ...]] = {
        comb: tuple(sorted(p for p in parts if p in partition_rows))
        for comb, parts in plan.trackers.items()
    }
    user_to_roles = world.user_to_roles

    def router(uid: int):
        comb = tuple(user_to_roles.get(uid, ()))
        pids = comb_to_pids.get(comb)
        if pids:
            return pids
        # unseen comb: the union of each single role's partitions
        acc = []
        for r in comb:
            acc.extend(comb_to_pids.get((r,), ()))
        return tuple(sorted(set(acc)))

    if packed and cfg.index.kind in ("flat", "flat_approx"):
        searcher = packed_searcher(arena, partition_rows, router, "dynamic",
                                   cfg, big_logical=cfg.index.big_logical)
    else:
        searcher = unpacked_searcher(arena, partition_rows, router,
                                     "dynamic", cfg)
    searcher.plan = plan
    return searcher
