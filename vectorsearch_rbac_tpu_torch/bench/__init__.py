from .ground_truth import (GroundTruthOracle, compute_recall,
                           per_query_recall)
from .harness import BenchmarkResult, compute_truth_sample, run_benchmark
from .queries import (QueryWorkload, generate_query_workload,
                      generate_query_workload_for_roles)
from .scenario import make_scenario, serving_config

__all__ = [
    "QueryWorkload",
    "generate_query_workload",
    "generate_query_workload_for_roles",
    "GroundTruthOracle",
    "compute_recall",
    "per_query_recall",
    "compute_truth_sample",
    "run_benchmark",
    "BenchmarkResult",
    "make_scenario",
    "serving_config",
]
