"""Online role insertion and deletion against an AnonySys plan.

A copy of vectorsearch_rbac_tpu/partition/dynamic/maintenance.py
(host-only Python), so that the port maintains plans where the JAX
package is absent; tests/test_torch_maintenance.py holds its plans,
partition choices and orphan sets equal to the reference's.

- Insertion scores every existing partition by delta query time over
  delta storage of absorbing the new role's documents (the
  selectivity-averaged ef before and after), against a fresh dedicated
  partition (selectivity 1), and takes the smallest.
- Deletion removes the role from every tracker, then prunes from each
  partition the documents no remaining tracked role needs, and drops the
  partitions that become empty.

Rollback is keeping the old PartitionPlan: the functions return new plans
and never change the one they are given. apply_plan_update
(materialize.py) puts a changed plan on the device.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np

from ...config import get_logger
from ...models.cost import model_ef_for_recall, model_partition_time
from ...rbac import Comb
from .optimizer import PartitionPlan, PlannerInputs

logger = get_logger("dynamic.maintenance")


def choose_partition_for_new_role(plan: PartitionPlan, inputs: PlannerInputs,
                                  new_role_docs: Set[int]
                                  ) -> Tuple[int, bool]:
    """(partition id, is_new) with the least delta query time over delta
    storage."""
    p = inputs.params
    topk = inputs.topk

    def _ef(sel: float) -> float:
        return model_ef_for_recall(p, None, topk, max(sel, 1e-6))

    # the roles each partition serves now (from the trackers)
    partition_roles: Dict[int, Set[int]] = {}
    for parts in plan.trackers.values():
        for pid, roles in parts.items():
            partition_roles.setdefault(pid, set()).update(roles)

    costs: Dict[int, float] = {}
    for pid, pdocs in plan.assignment.items():
        if not pdocs:
            continue
        existing_sels = [
            len(pdocs & inputs.role_to_docs.get(r, frozenset())) / len(pdocs)
            for r in partition_roles.get(pid, ())]
        new_sel = len(new_role_docs & pdocs) / len(pdocs)
        sel_before = (sum(existing_sels) / len(existing_sels)
                      if existing_sels else 0.0)
        sel_after = ((sum(existing_sels) + new_sel) / (len(existing_sels) + 1)
                     if existing_sels else new_sel)
        qt_before = (model_partition_time(p, len(pdocs), _ef(sel_before))
                     if sel_before > 0 else 0.0)
        n_after = len(pdocs | new_role_docs)
        qt_after = model_partition_time(p, n_after, _ef(sel_after))
        d_storage = n_after - len(pdocs)
        costs[pid] = ((qt_after - qt_before) / d_storage if d_storage > 0
                      else float("inf"))

    new_pid = max(plan.assignment.keys(), default=-1) + 1
    if new_role_docs:
        qt_new = model_partition_time(p, max(len(new_role_docs), 2),
                                      _ef(1.0))
        costs[new_pid] = qt_new / len(new_role_docs)

    best = min(costs, key=costs.get)
    return best, best == new_pid


def insert_role(plan: PartitionPlan, inputs: PlannerInputs, new_role: int,
                new_role_docs: Set[int],
                combs_with_role: Optional[Set[Comb]] = None
                ) -> Tuple[PartitionPlan, int]:
    """Insert a new role; returns (the updated plan, the chosen partition).

    `combs_with_role`: the user role combinations that now include the new
    role (at least the singleton). The planner inputs' role_to_docs must
    already hold the new role."""
    pid, is_new = choose_partition_for_new_role(plan, inputs, new_role_docs)
    assignment = {q: set(d) for q, d in plan.assignment.items()}
    assignment.setdefault(pid, set()).update(new_role_docs)
    trackers = {c: {q: set(rs) for q, rs in parts.items()}
                for c, parts in plan.trackers.items()}
    for comb in (combs_with_role or {(new_role,)}):
        trackers.setdefault(comb, {})
        trackers[comb].setdefault(pid, set()).add(new_role)
        # the comb's other roles keep their old partitions
        for r in comb:
            if r == new_role:
                continue
            if not any(r in rs for rs in trackers[comb].values()):
                # fall back to the singleton's partitions
                for spid, srs in trackers.get((r,), {}).items():
                    if r in srs:
                        trackers[comb].setdefault(spid, set()).add(r)
    logger.info("inserted role %d into %s partition %d (%d docs)", new_role,
                "new" if is_new else "existing", pid, len(new_role_docs))
    return PartitionPlan(assignment=assignment, trackers=trackers,
                         split_log=plan.split_log), pid


def orphaned_docs_after_role_delete(world, role: int) -> Set[int]:
    """The documents only `role` reads: deleting the role strands their
    rows (no remaining role grants them), so the caller tombstones them
    (core.tombstone_rows) and later compacts."""
    others: Set[int] = set()
    for r, docs in world.role_to_docs.items():
        if r != role:
            others.update(docs)
    return set(world.role_to_docs.get(role, ())) - others


def orphaned_rows_after_role_delete(world, doc_ids: np.ndarray,
                                    role: int) -> np.ndarray:
    """The arena rows of orphaned_docs_after_role_delete's documents."""
    docs = orphaned_docs_after_role_delete(world, role)
    if not docs:
        return np.empty(0, dtype=np.int64)
    return np.nonzero(np.isin(doc_ids, np.fromiter(
        docs, dtype=np.int64, count=len(docs))))[0].astype(np.int64)


def delete_role(plan: PartitionPlan, inputs: PlannerInputs,
                role: int) -> PartitionPlan:
    """Remove a role: take it out of every tracker, prune each partition's
    documents to what the remaining tracked roles need, drop the empty
    partitions."""
    trackers: Dict[Comb, Dict[int, Set[int]]] = {}
    for comb, parts in plan.trackers.items():
        if role in comb:
            new_comb = tuple(r for r in comb if r != role)
            if not new_comb:
                continue   # the deleted role's singleton goes
        else:
            new_comb = comb
        target = trackers.setdefault(new_comb, {})
        for pid, roles in parts.items():
            rs = roles - {role}
            if rs:
                target.setdefault(pid, set()).update(rs)

    # each partition's documents pruned to what the tracked roles need
    needed_by_pid: Dict[int, Set[int]] = {}
    for parts in trackers.values():
        for pid, roles in parts.items():
            need = needed_by_pid.setdefault(pid, set())
            for r in roles:
                if r != role:
                    need |= inputs.role_to_docs.get(r, frozenset())
    assignment: Dict[int, Set[int]] = {}
    for pid, docs in plan.assignment.items():
        kept = docs & needed_by_pid.get(pid, set())
        if kept:
            assignment[pid] = kept
    logger.info("deleted role %d: %d partitions remain", role,
                len(assignment))
    return PartitionPlan(assignment=assignment, trackers=trackers,
                         split_log=plan.split_log)
