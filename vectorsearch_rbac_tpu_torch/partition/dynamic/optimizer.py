"""AnonySys dynamic-partition planner: greedy storage-budgeted splitting.

The port's copy of vectorsearch_rbac_tpu/partition/dynamic/optimizer.py
(host-only Python), so that the port plans where the JAX package is
absent; tests/test_torch_host.py holds its plans (assignment, trackers,
split log) equal to the reference's, bit for bit.

Re-implements the semantics of the reference's core optimizer
(controller/dynamic_partition/hnsw/AnonySys_dynamic_partition.py:425-667
split_comb_roles) over the framework's array-based world model:

State:
- `assignment`: pid -> set of doc indices materialized in that partition;
- `trackers`: comb -> {pid -> set of roles served from that partition}.

Loop: find the largest partition hosting more than one *fully resident*
role-combination; for each candidate comb propose moving its documents to a
fresh partition; score the move by (relative query-time change) /
(relative storage growth) under the fitted cost models; apply the best
(most negative) move from a heap. Two phases:

- stage 1 ("single-role mode"): only single-role combs split; tracker
  updates forcibly retarget every affected comb's roles to the new
  partition (reference :270-309 update_comb_role_tracker_stage1);
- stage 2 ("combination mode", entered when stage 1 has no improving
  candidate, reference :611-613): any comb may split, and each affected
  comb re-selects its optimal covering subset of candidate partitions by
  exhaustive enumeration (reference :312-422 update_comb_role_tracker_stage2).

The split loop stops when total materialized docs would exceed
alpha * total docs (reference :440) or no improving move exists.

While it plans, a partition's documents are a Python-int bitset (`DocBits`:
bit d is document d), so a union, an intersection or a count is a few word
operations over the whole corpus; a comb's documents are unioned once; a
partition (`_Part`) counts its overlap with each comb once; and a candidate
split shares every partition and tracker it leaves alone with the state it
starts from, so that only its source and target are counted anew. The
candidates, the heap's ties and every float sum keep the reference's
order, so the plan is the reference's exactly. The returned plan holds
sets, as the reference's does.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Set, Tuple

import numpy as np

from ...models.cost import (CostModelParams, model_ef_for_recall,
                            model_partition_time)
from ...rbac import Comb
from ...config import get_logger

logger = get_logger("dynamic.optimizer")

Trackers = Dict[Comb, Dict[int, Set[int]]]


@dataclass
class PlannerInputs:
    role_to_docs: Mapping[int, FrozenSet[int]]   # role -> doc indices
    combs: Sequence[Comb]                        # distinct user role combinations
    comb_weights: Mapping[Comb, float]           # workload weights per comb
    single_role_weights: Mapping[int, float]     # workload weights per role
    params: CostModelParams
    alpha: float = 1.5                           # storage budget multiple
    topk: int = 10
    target_recall: Optional[float] = None
    avg_blocks_per_doc: float = 1.0

    def comb_docs(self, comb: Comb) -> Set[int]:
        docs: Set[int] = set()
        for r in comb:
            docs.update(self.role_to_docs.get(r, ()))
        return docs


@dataclass
class PartitionPlan:
    assignment: Dict[int, Set[int]]
    trackers: Trackers
    split_log: List[Tuple[float, Comb, int]] = field(default_factory=list)

    @property
    def loads(self) -> Dict[int, int]:
        return {pid: len(docs) for pid, docs in self.assignment.items()}

    def comb_to_partitions(self) -> Dict[Comb, Set[int]]:
        """The CombRolePartitions mapping (reference
        load_result_to_database.py:294)."""
        return {comb: set(parts.keys()) for comb, parts in self.trackers.items()}


def plan_from_reference(plan) -> PartitionPlan:
    """The port's PartitionPlan from any plan with `.assignment`,
    `.trackers` and `.split_log` (the JAX package's included), copied so
    that neither side's later edits reach the other: the state a searcher
    is built from carries across, as core.arena_from_reference carries an
    arena."""
    return PartitionPlan(
        assignment={int(pid): set(docs)
                    for pid, docs in plan.assignment.items()},
        trackers={tuple(comb): {int(pid): set(roles)
                                for pid, roles in parts.items()}
                  for comb, parts in plan.trackers.items()},
        split_log=list(plan.split_log))


# ------------------------------------------------------------- documents


def union_bits(bit_sets) -> int:
    """The union of bitsets."""
    out = 0
    for bits in bit_sets:
        out |= bits
    return out


class DocBits:
    """A world's documents as Python-int bitsets, bit d for document d:
    each role's, and each comb's union, made once."""

    def __init__(self, role_to_docs: Mapping[int, FrozenSet[int]]):
        self.n_docs = 1 + max((max(d) for d in role_to_docs.values() if d),
                              default=-1)
        self.role: Dict[int, int] = {r: self.of(d)
                                     for r, d in role_to_docs.items()}
        self._comb: Dict[Comb, int] = {}

    def of(self, docs) -> int:
        """The bitset of a collection of the world's document ids."""
        flags = np.zeros(self.n_docs, dtype=bool)
        flags[np.fromiter(docs, dtype=np.int64, count=len(docs))] = True
        return int.from_bytes(np.packbits(flags, bitorder="little").tobytes(),
                              "little")

    def docs(self, bits: int) -> Set[int]:
        """The set of document ids of a bitset."""
        raw = np.frombuffer(bits.to_bytes((self.n_docs + 7) // 8, "little"),
                            dtype=np.uint8)
        return set(np.flatnonzero(
            np.unpackbits(raw, bitorder="little")).tolist())

    def comb(self, comb: Comb) -> int:
        """The union of a comb's roles' documents."""
        bits = self._comb.get(comb)
        if bits is None:
            bits = self._comb[comb] = union_bits(self.role.get(r, 0)
                                                 for r in comb)
        return bits


class _Part:
    """One partition while the planner runs: its documents (a bitset), their
    count, and their overlap with each comb, counted once. A candidate
    split that leaves the partition alone shares this object."""

    __slots__ = ("docs", "n", "overlap")

    def __init__(self, docs: int):
        self.docs = docs
        self.n = docs.bit_count()
        self.overlap: Dict[Comb, int] = {}


Assignment = Dict[int, _Part]


def _overlap(bits: DocBits, comb: Comb, part: _Part) -> int:
    """|comb's documents ∩ the partition's|."""
    n = part.overlap.get(comb)
    if n is None:
        n = part.overlap[comb] = (bits.comb(comb) & part.docs).bit_count()
    return n


# --------------------------------------------------------------------- cost


def _weight(comb: Comb, weights: Mapping, single: Mapping) -> float:
    """Comb weight with single-role fallback (reference
    AnonySys_dynamic_partition.py:156-158: a zero comb-weight falls back to
    the first role's single-role weight)."""
    w = weights.get(comb, 0.0) if weights else 1.0
    if w == 0:
        w = single.get(comb[0], 1.0) if comb else 0.0
    return w


def compute_sel_whole(
    trackers: Trackers,
    assignment: Assignment,
    bits: DocBits,
    inputs: PlannerInputs,
    combs_to_update: Sequence[Comb],
    weights: Mapping,
) -> float:
    """Weighted average per-comb selectivity over tracked partitions
    (reference :169-211 compute_sel_whole: per comb, mean over its
    partitions of |comb docs ∩ partition| / |partition|)."""
    total_w_sel = 0.0
    total_w = 0.0
    for comb in combs_to_update:
        parts = trackers.get(comb, {})
        sels = []
        for pid in parts:
            part = assignment.get(pid)
            if part is not None and part.n:
                sels.append(_overlap(bits, comb, part) / part.n)
        avg_sel = sum(sels) / len(sels) if sels else 0.0
        w = _weight(comb, weights, inputs.single_role_weights)
        total_w_sel += avg_sel * w
        total_w += w
    return total_w_sel / total_w if total_w > 0 else 0.0


def compute_query_time(
    trackers: Trackers,
    assignment: Assignment,
    sel_whole: float,
    inputs: PlannerInputs,
    combs_to_update: Sequence[Comb],
    weights: Mapping,
) -> float:
    """Weighted total query time (reference :114-166 compute_query_time):
    a single ef is derived from the aggregate selectivity via the inverted
    recall model, then each comb pays sum over its partitions of
    weight * log(n) * (a*ef + b)."""
    p = inputs.params
    ef = model_ef_for_recall(p, inputs.target_recall, inputs.topk,
                             max(sel_whole, 1e-6))
    total = 0.0
    for comb in combs_to_update:
        w = _weight(comb, weights, inputs.single_role_weights)
        for pid in trackers.get(comb, {}):
            part = assignment.get(pid)
            if part is not None and part.n > 0:
                total += w * model_partition_time(
                    p, part.n * inputs.avg_blocks_per_doc + 1e-9, ef)
    return total


# ----------------------------------------------------------- tracker updates
#
# Both updates replace an affected comb's entry with a new dict and never
# edit a set in place, so a candidate's trackers may share the rest with
# the state it starts from.


def update_tracker_stage1(
    comb: Comb, target_pid: int, trackers: Trackers, source_pid: int
) -> None:
    """Move every role of `comb` that any affected comb served from
    `source_pid` to `target_pid` (reference :270-309)."""
    roles = set(comb)
    for other, parts in trackers.items():
        if not roles.intersection(other):
            continue
        new_parts: Dict[int, Set[int]] = {}
        moved: Set[int] = set()
        for pid, prole in parts.items():
            if pid != source_pid:
                new_parts[pid] = prole
                continue
            to_move = prole & roles
            if to_move:
                moved |= to_move
                rest = prole - to_move
                if rest:
                    new_parts[pid] = rest
            else:
                new_parts[pid] = prole
        if moved:
            new_parts[target_pid] = new_parts.get(target_pid, set()) | moved
        trackers[other] = new_parts


def update_tracker_stage2(
    comb: Comb,
    target_pid: int,
    trackers: Trackers,
    assignment: Assignment,
    bits: DocBits,
    inputs: PlannerInputs,
    max_subset_candidates: int = 16,
) -> None:
    """Re-select the optimal covering partition subset for every affected
    comb (reference :312-422): enumerate subsets of (previous partitions +
    target), keep full-coverage ones, score by the query-time model with
    the subset's average selectivity, then assign each role to the smallest
    fully-covering partition of the winner (or all partitions if none)."""
    p = inputs.params
    roles_in_comb = set(comb)
    affected = [c for c in trackers if roles_in_comb.intersection(c)]
    if comb not in affected and comb in trackers:
        affected.append(comb)

    def docs_of(pid: int) -> int:
        part = assignment.get(pid)
        return part.docs if part is not None else 0

    for a_comb in affected:
        a_docs = bits.comb(a_comb)
        original = set(trackers[a_comb].keys())
        if original == {target_pid}:
            continue
        candidates = sorted(original | {target_pid})
        if len(candidates) > max_subset_candidates:
            # bound the exhaustive search; keep the largest-overlap ones
            candidates = sorted(
                candidates,
                key=lambda pid: -(a_docs & docs_of(pid)).bit_count(),
            )[:max_subset_candidates]

        best_subset = None
        best_time = float("inf")
        for r in range(1, len(candidates) + 1):
            for subset in itertools.combinations(candidates, r):
                if a_docs & ~union_bits(docs_of(pid) for pid in subset):
                    continue
                total_sel = 0.0
                for pid in subset:
                    part = assignment[pid]
                    total_sel += _overlap(bits, a_comb, part) / part.n
                avg_sel = total_sel / len(subset)
                ef = model_ef_for_recall(p, None, inputs.topk,
                                         max(avg_sel, 1e-6))
                # sum of per-partition probe times (for the reference
                # family this equals log(prod sizes) * (a*ef + b))
                qt = sum(model_partition_time(p, assignment[pid].n, ef)
                         for pid in subset)
                if qt < best_time:
                    best_time = qt
                    best_subset = subset

        if best_subset is None:
            logger.warning("no covering partition subset for comb %s", a_comb)
            continue

        new_parts: Dict[int, Set[int]] = {pid: set() for pid in best_subset}
        for role in a_comb:
            rdocs = bits.role.get(role, 0)
            covering = [pid for pid in best_subset
                        if (rdocs & assignment[pid].docs) == rdocs]
            if covering:
                pick = min(covering, key=lambda pid: assignment[pid].n)
                new_parts[pick].add(role)
            else:
                for pid in best_subset:
                    new_parts[pid].add(role)
        trackers[a_comb] = {pid: rs for pid, rs in new_parts.items() if rs}


# ----------------------------------------------------------------- planner


def _role_trackers_view(trackers: Trackers) -> Trackers:
    """Single-role sub-view of the comb trackers (reference :470-474), to
    read only."""
    return {comb: parts for comb, parts in trackers.items() if len(comb) == 1}


def _fully_resident_combs(trackers: Trackers, pid: int) -> Set[Comb]:
    """Combs whose every role is served from `pid` (reference :446-449)."""
    return {
        comb for comb, parts in trackers.items()
        if pid in parts and parts[pid] == set(comb)
    }


def _pick_split_partition(
    assignment: Assignment, trackers: Trackers
) -> Tuple[Optional[int], Set[Comb]]:
    """Largest partition hosting >1 fully-resident comb."""
    for pid in sorted(assignment, key=lambda p: assignment[p].n,
                      reverse=True):
        combs = _fully_resident_combs(trackers, pid)
        if len(combs) > 1:
            return pid, combs
    return None, set()


def _shrink_source(
    assignment: Assignment,
    trackers: Trackers,
    source_pid: int,
    bits: DocBits,
) -> None:
    """After a move, keep in the source partition only documents still
    needed by roles that remain there (reference :548-561, :644-657)."""
    remaining_roles: Set[int] = set()
    for parts in trackers.values():
        if source_pid in parts:
            remaining_roles |= parts[source_pid]
    needed = union_bits(bits.role.get(role, 0) for role in remaining_roles)
    docs = assignment[source_pid].docs
    if docs & needed != docs:
        assignment[source_pid] = _Part(docs & needed)


def _load(assignment: Assignment) -> int:
    return sum(part.n for part in assignment.values())


def split_comb_roles(
    inputs: PlannerInputs,
    combination_mode: bool = False,
    max_splits: int = 10000,
) -> PartitionPlan:
    bits = DocBits(inputs.role_to_docs)
    # every comb and every single role is a split candidate (reference
    # :761-785 expands role_combinations with all single roles)
    candidate_combs: Set[Comb] = set(tuple(c) for c in inputs.combs)
    for comb in list(candidate_combs):
        for r in comb:
            candidate_combs.add((r,))

    assignment: Assignment = {0: _Part(union_bits(bits.role.values()))}
    budget = inputs.alpha * assignment[0].n

    trackers: Trackers = {comb: {0: set(comb)} for comb in candidate_combs}
    split_log: List[Tuple[float, Comb, int]] = []

    splits = 0
    while _load(assignment) <= budget and splits < max_splits:
        source_pid, source_combs = _pick_split_partition(assignment, trackers)
        if source_pid is None:
            logger.info("no splittable partition; stopping at %d partitions",
                        len(assignment))
            break

        involved_combs = [c for c, parts in trackers.items() if source_pid in parts]
        role_view = _role_trackers_view(trackers)
        involved_roles = [c for c in role_view if source_pid in role_view[c]]

        sel_comb_before = compute_sel_whole(trackers, assignment, bits, inputs,
                                            involved_combs, inputs.comb_weights)
        qt_comb_before = compute_query_time(trackers, assignment, sel_comb_before,
                                            inputs, involved_combs, inputs.comb_weights)
        sel_role_before = compute_sel_whole(role_view, assignment, bits, inputs,
                                            involved_roles, inputs.single_role_weights)
        qt_role_before = compute_query_time(role_view, assignment, sel_role_before,
                                            inputs, involved_roles, inputs.single_role_weights)
        if qt_comb_before <= 0 or qt_role_before <= 0:
            break

        target_pid = max(assignment.keys()) + 1
        prev_storage = _load(assignment)
        heap: List[Tuple[float, float, float, Comb, int]] = []

        for comb in sorted(source_combs):
            if not combination_mode and len(comb) > 1:
                continue  # stage 1 splits single roles only (reference :513)

            # the candidate's state shares what the move leaves alone
            tmp_assign = dict(assignment)
            tmp_track = dict(trackers)
            tmp_assign[target_pid] = _Part(bits.comb(comb))
            if combination_mode:
                update_tracker_stage2(comb, target_pid, tmp_track, tmp_assign,
                                      bits, inputs)
            else:
                update_tracker_stage1(comb, target_pid, tmp_track, source_pid)
            _shrink_source(tmp_assign, tmp_track, source_pid, bits)

            new_storage = _load(tmp_assign)
            storage_growth = ((new_storage - prev_storage) / prev_storage
                              if prev_storage else 0.0)

            tmp_role_view = _role_trackers_view(tmp_track)
            sel_c = compute_sel_whole(tmp_track, tmp_assign, bits, inputs,
                                      involved_combs, inputs.comb_weights)
            qt_c = compute_query_time(tmp_track, tmp_assign, sel_c, inputs,
                                      involved_combs, inputs.comb_weights)
            sel_r = compute_sel_whole(tmp_role_view, tmp_assign, bits, inputs,
                                      involved_roles, inputs.single_role_weights)
            qt_r = compute_query_time(tmp_role_view, tmp_assign, sel_r, inputs,
                                      involved_roles, inputs.single_role_weights)

            d_comb = (qt_c - qt_comb_before) / qt_comb_before
            d_role = (qt_r - qt_role_before) / qt_role_before
            eps = 1e-10
            storage_flag = -100.0 if storage_growth < 0 else 1.0

            if combination_mode:
                combined = storage_flag * d_comb / (storage_growth + eps)
                if d_comb < 0:
                    heapq.heappush(heap, (combined, d_role, d_comb, comb, target_pid))
            else:
                combined = storage_flag * (d_role + d_comb) / (storage_growth + eps)
                # stage 1 admits a split that helps single-role queries even
                # if comb-level time mildly regresses (reference :607)
                if d_role < 0 and d_comb < 10:
                    heapq.heappush(heap, (combined, d_role, d_comb, comb, target_pid))

        if not heap:
            if not combination_mode:
                combination_mode = True
                logger.info("stage 1 exhausted -> combination mode "
                            "(%d partitions)", len(assignment))
                continue
            logger.info("no improving split; stopping at %d partitions",
                        len(assignment))
            break

        combined, d_role, d_comb, best_comb, tpid = heapq.heappop(heap)
        assignment[tpid] = _Part(bits.comb(best_comb))
        if combination_mode:
            update_tracker_stage2(best_comb, tpid, trackers, assignment, bits,
                                  inputs)
        else:
            update_tracker_stage1(best_comb, tpid, trackers, source_pid)
        _shrink_source(assignment, trackers, source_pid, bits)
        split_log.append((combined, best_comb, tpid))
        splits += 1
        logger.debug("split %s -> partition %d (delta=%.4f, load=%d/%d)",
                     best_comb, tpid, combined, _load(assignment), int(budget))

    return PartitionPlan(
        assignment={pid: bits.docs(part.docs)
                    for pid, part in assignment.items()},
        trackers=trackers, split_log=split_log)
