from .ground_truth import (GroundTruthOracle, compute_recall,
                           per_query_recall)
from .harness import BenchmarkResult, compute_truth_sample, run_benchmark
from .queries import QueryWorkload, generate_query_workload
from .scenario import make_scenario, serving_config

__all__ = [
    "QueryWorkload",
    "generate_query_workload",
    "GroundTruthOracle",
    "compute_recall",
    "per_query_recall",
    "compute_truth_sample",
    "run_benchmark",
    "BenchmarkResult",
    "make_scenario",
    "serving_config",
]
