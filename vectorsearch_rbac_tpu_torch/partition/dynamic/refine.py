"""Heavy-partition refinement: beam search over role-predicate splits.

A copy of vectorsearch_rbac_tpu/partition/dynamic/refine.py (host-only
Python), so that the port plans where the JAX package is absent;
tests/test_torch_host.py holds it equal to the reference.

Re-implements the semantics of the reference's post-pass
(controller/dynamic_partition/hnsw/heavy_partition_refine.py:203
rebalance_heavy_partition): the largest partition is recursively split by
role-subset predicates; states are scored by the per-role probe cost
sum(log(partition_size) / selectivity) (reference :261 _role_cost); a beam
(width 4, depth 3, <=6 candidates per state, reference :336-338) explores
subsets of the top roles; a role may not end up spread over more than 3
partitions. After the split, comb trackers are remapped so every role
tracks exactly the sub-partitions holding its documents — preserving the
coverage invariant.

The search holds documents as the planner's bitsets (optimizer.DocBits);
its states, their order, costs and signatures are the reference's, so the
refined plan is the reference's exactly.
"""

from __future__ import annotations

import functools
import itertools
import math
from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

from ...config import get_logger
from .optimizer import DocBits, PartitionPlan, PlannerInputs, union_bits

logger = get_logger("dynamic.refine")

# tuning knobs (reference heavy_partition_refine.py:220-228, 336-338)
BEAM_WIDTH = 4
MAX_DEPTH = 3
MAX_CANDIDATES_PER_STATE = 6
MAX_SUBSET_SIZE = 3
TOP_ROLE_LIMIT = 8
MAX_PARTITIONS_PER_ROLE = 3
MIN_IMPROVEMENT = 1e-6


def _role_cost(partition_size: int, docs_for_role: int) -> float:
    if partition_size <= 0 or docs_for_role <= 0:
        return 0.0
    sel = max(docs_for_role / partition_size, 1e-9)
    return math.log(max(partition_size, 1)) / sel


def _state_cost(parts: List[Dict[int, int]]) -> float:
    """parts: list of {role -> docs (a bitset) in this sub-partition}."""
    total = 0.0
    for role_map in parts:
        size = union_bits(role_map.values()).bit_count()
        for docs in role_map.values():
            total += _role_cost(size, docs.bit_count())
    return total


@dataclass
class _State:
    remaining: Dict[int, int]                      # role -> docs still in source
    new_parts: List[Dict[int, int]]                # role -> docs per new partition
    cost: float
    depth: int


def _proper_subset_first(a: int, b: int) -> int:
    """The order in which sorted() puts sets: a before b when a < b, which
    for sets is a proper subset."""
    return -1 if a != b and (a & b) == a else 0


def _signature(state: _State) -> Tuple:
    rem = union_bits(state.remaining.values())
    parts = tuple(sorted((union_bits(p.values()) for p in state.new_parts),
                         key=functools.cmp_to_key(_proper_subset_first)))
    return (rem, parts)


def _role_partition_count(role: int, state: _State, external: Dict[int, int]) -> int:
    count = external.get(role, 0)
    if state.remaining.get(role):
        count += 1
    for p in state.new_parts:
        if p.get(role):
            count += 1
    return count


def rebalance_heavy_partition(
    plan: PartitionPlan,
    inputs: PlannerInputs,
    target_pid: int,
) -> PartitionPlan:
    assignment = {pid: set(d) for pid, d in plan.assignment.items()}
    trackers = {c: {pid: set(rs) for pid, rs in parts.items()}
                for c, parts in plan.trackers.items()}

    if not assignment.get(target_pid):
        return plan
    bits = DocBits(inputs.role_to_docs)
    source_docs = bits.of(assignment[target_pid])

    # roles served from the heavy partition, restricted to tracked roles
    allowed_roles: Set[int] = set()
    for parts in trackers.values():
        if target_pid in parts:
            allowed_roles |= parts[target_pid]
    role_docs: Dict[int, int] = {}
    for role in allowed_roles:
        docs = bits.role.get(role, 0) & source_docs
        if docs:
            role_docs[role] = docs
    if len(role_docs) < 2:
        return plan

    # how many partitions outside the target each role already touches
    external_counts: Dict[int, int] = {}
    for role in role_docs:
        n = 0
        for parts in trackers.values():
            for pid, roles in parts.items():
                if pid != target_pid and role in roles:
                    n += 1
                    break
        external_counts[role] = n

    init = _State(
        remaining=dict(role_docs),
        new_parts=[],
        cost=_state_cost([role_docs]),
        depth=0,
    )
    best = init
    beam = [init]
    seen = {_signature(init)}

    while beam:
        next_beam: List[_State] = []
        for state in beam:
            if state.depth >= MAX_DEPTH:
                continue
            # candidate subsets: from the largest remaining roles
            live_roles = sorted(
                state.remaining,
                key=lambda r: -state.remaining[r].bit_count())[:TOP_ROLE_LIMIT]
            candidates = []
            for size in range(1, min(MAX_SUBSET_SIZE, len(live_roles)) + 1):
                candidates.extend(itertools.combinations(live_roles, size))
            everything = union_bits(state.remaining.values())
            scored: List[_State] = []
            for subset in candidates:
                moved = union_bits(state.remaining[r] for r in subset)
                if not moved or moved == everything:
                    continue
                new_remaining = {
                    r: d & ~moved for r, d in state.remaining.items()
                }
                new_remaining = {r: d for r, d in new_remaining.items() if d}
                new_part = {
                    r: (role_docs[r] & moved)
                    for r in role_docs
                    if role_docs[r] & moved
                }
                cand = _State(
                    remaining=new_remaining,
                    new_parts=state.new_parts + [new_part],
                    cost=0.0,
                    depth=state.depth + 1,
                )
                # role-spread budget
                if any(
                    _role_partition_count(r, cand, external_counts) > MAX_PARTITIONS_PER_ROLE
                    for r in role_docs
                ):
                    continue
                cand.cost = _state_cost([cand.remaining] + cand.new_parts)
                sig = _signature(cand)
                if sig in seen:
                    continue
                seen.add(sig)
                scored.append(cand)
            scored.sort(key=lambda s: s.cost)
            next_beam.extend(scored[:MAX_CANDIDATES_PER_STATE])
        next_beam.sort(key=lambda s: s.cost)
        beam = next_beam[:BEAM_WIDTH]
        for s in beam:
            if s.cost < best.cost - MIN_IMPROVEMENT:
                best = s

    if not best.new_parts:
        logger.info("refinement found no improving split for partition %d", target_pid)
        return plan

    # apply: source keeps remaining docs; each new part becomes a partition
    source_size = len(assignment[target_pid])
    next_pid = max(assignment.keys()) + 1
    sub_bits = {target_pid: union_bits(best.remaining.values())}
    assignment[target_pid] = bits.docs(sub_bits[target_pid])
    new_pids: List[int] = []
    for part in best.new_parts:
        sub_bits[next_pid] = union_bits(part.values())
        assignment[next_pid] = bits.docs(sub_bits[next_pid])
        new_pids.append(next_pid)
        next_pid += 1

    # remap trackers: a role tracked at target_pid now tracks every
    # sub-partition holding its documents (preserves coverage exactly)
    sub_pids = [target_pid] + new_pids
    for comb, parts in trackers.items():
        roles_here = parts.pop(target_pid, set())
        for role in roles_here:
            rdocs = bits.role.get(role, 0)
            for pid in sub_pids:
                if rdocs & sub_bits[pid]:
                    parts.setdefault(pid, set()).add(role)

    logger.info(
        "refined partition %d: %d -> %d docs remaining + %s new partitions "
        "(cost %.1f -> %.1f)",
        target_pid, source_size, len(assignment[target_pid]),
        [len(assignment[p]) for p in new_pids], init.cost, best.cost,
    )
    return PartitionPlan(assignment=assignment, trackers=trackers,
                         split_log=plan.split_log)


def remap_comb_role_trackers(
    trackers: Dict, mapping: Dict[int, int]
) -> Dict:
    """Renumber tracker pids (reference heavy_partition_refine.py:765)."""
    out = {}
    for comb, parts in trackers.items():
        out[comb] = {mapping[pid]: roles for pid, roles in parts.items()
                     if pid in mapping}
    return out
