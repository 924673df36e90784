"""RBAC-filtered vector search on an NVIDIA H100: the PyTorch + CUDA port.

A port of `vectorsearch_rbac_tpu` (JAX/Pallas, written for a TPU), which
stays beside it as the reference. This package serves the RLS strategy over
the int8 arena: the global masked scan, the group-minima merge and the
result wire run on the card, in CUDA C++ kernels written for sm_90a
(`csrc/`, built with nvcc at first use) wherever the reference runs a
Pallas kernel. The package imports neither jax nor the reference package:
the host layers the main path needs (corpus, quantizer, RBAC world, the
SIFT-like data, config) are copies, held equal to the reference by tests.

Layer map:
    config      serving config + logger          (reference utils/)
    rbac        RBAC world + tree generator      (reference rbac/)
    data        the SIFT-like corpus             (reference data/)
    core        corpus, quantizer, device arena  (reference core.py)
    ops/        oracle scan, int8 scan, merge    (reference ops/)
    csrc/       the CUDA kernels                 (reference Pallas kernels)
    index/      exact flat + int8 flat indexes   (reference index/)
    partition/  the global (RLS) strategy        (reference partition/)
    bench/      workload, oracle, harness, CLI   (reference bench/, bench.py)
"""

from .config import FrameworkConfig
from .core import (ArenaQuant, Corpus, DeviceArena, arena_from_reference,
                   build_device_arena)
from .data import resolve_dataset, sift_like_corpus
from .rbac import RBACWorld, TreeRBACGenerator
from .partition import build_global_searcher, build_searcher
from .bench import (GroundTruthOracle, generate_query_workload,
                    run_benchmark)

__version__ = "0.1.0"

__all__ = [
    "FrameworkConfig", "ArenaQuant", "Corpus", "DeviceArena",
    "arena_from_reference", "build_device_arena", "resolve_dataset",
    "sift_like_corpus", "RBACWorld", "TreeRBACGenerator",
    "build_global_searcher", "build_searcher", "GroundTruthOracle",
    "generate_query_workload", "run_benchmark",
]
