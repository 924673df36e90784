"""AnonySys dynamic partitioning: the planner (copies of the reference's
host-only optimizer, refinement and workload weights) and its
materialization into a searcher."""

from .materialize import (build_dynamic_searcher, clean_and_reindex,
                          plan_dynamic_partitions, planner_inputs,
                          validate_partition_coverage)
from .optimizer import (PartitionPlan, PlannerInputs, plan_from_reference,
                        split_comb_roles)
from .weights import (comb_weights_from_workload,
                      single_role_weights_from_workload)

__all__ = [
    "PlannerInputs",
    "PartitionPlan",
    "plan_from_reference",
    "split_comb_roles",
    "comb_weights_from_workload",
    "single_role_weights_from_workload",
    "build_dynamic_searcher",
    "clean_and_reindex",
    "plan_dynamic_partitions",
    "planner_inputs",
    "validate_partition_coverage",
]
