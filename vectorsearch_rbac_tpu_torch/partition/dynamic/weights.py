"""Workload-derived weights for the dynamic-partition planner.

A copy of vectorsearch_rbac_tpu/partition/dynamic/weights.py (host-only
Python), so that the port plans where the JAX package is absent;
tests/test_torch_host.py holds it equal to the reference.

Mirrors the reference's weight extraction (reference
AnonySys_dynamic_partition.py:69-111 calculate_role_weights_from_queries and
:674-727 calculate_single_role_weights_from_queries): each query contributes
its user's block selectivity as weight, aggregated per role-combination and
per single role; roles never queried get a small default weight.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

from ...bench.queries import QueryWorkload
from ...rbac import Comb, RBACWorld


def comb_weights_from_workload(
    world: RBACWorld, workload: QueryWorkload
) -> Dict[Comb, float]:
    """comb -> summed query selectivity weight (0 for unqueried combs)."""
    user_weight: Dict[int, float] = {}
    for uid, sel in zip(workload.user_ids.tolist(), workload.selectivities.tolist()):
        user_weight[uid] = user_weight.get(uid, 0.0) + sel

    weights: Dict[Comb, float] = {tuple(c): 0.0 for c in world.combs}
    for uid, w in user_weight.items():
        comb = tuple(world.user_to_roles.get(uid, ()))
        if comb:
            weights[comb] = weights.get(comb, 0.0) + w
    return weights


def single_role_weights_from_workload(
    world: RBACWorld, workload: QueryWorkload
) -> Dict[int, float]:
    """role -> aggregated weight across all combs containing it, with a
    1/num_roles default for never-queried roles."""
    comb_w = comb_weights_from_workload(world, workload)
    all_roles = {r for c in world.combs for r in c}
    default = 1.0 / (len(all_roles) + 1e-6)
    weights: Dict[int, float] = {r: default for r in all_roles}
    acc: Dict[int, float] = defaultdict(float)
    for comb, w in comb_w.items():
        for r in comb:
            acc[r] += w
    for r, w in acc.items():
        if w > 0:
            weights[r] = w
    return weights
