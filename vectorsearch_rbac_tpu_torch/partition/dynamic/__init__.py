"""AnonySys dynamic partitioning: the planner (copies of the reference's
host-only optimizer, refinement, workload weights and role maintenance)
and its materialization into a searcher, whole or as a plan update."""

from .maintenance import (choose_partition_for_new_role, delete_role,
                          insert_role, orphaned_docs_after_role_delete,
                          orphaned_rows_after_role_delete)
from .materialize import (apply_plan_update, build_dynamic_searcher,
                          clean_and_reindex, plan_dynamic_partitions,
                          planner_inputs, validate_partition_coverage)
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
    "insert_role",
    "delete_role",
    "choose_partition_for_new_role",
    "orphaned_docs_after_role_delete",
    "orphaned_rows_after_role_delete",
    "apply_plan_update",
]
