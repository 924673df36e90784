"""RBAC-filtered vector search on an NVIDIA H100: the PyTorch + CUDA port.

A port of `vectorsearch_rbac_tpu` (JAX/Pallas, written for a TPU), which
stays beside it as the reference. This package serves the RLS strategy over
int8 arenas for l2, ip and cosine and over float32 and bfloat16 arenas for
those and l1 (the flat index, exact or on the augmented layout), the
partitioned strategies ROLE, USER, AnonySys (`dynamic`) and QDTree on every
arena (the chunk engine on an int8 l2 arena, the PackedSearcher elsewhere,
or a flat index a partition), the IVF, binary and sparse indexes, and
AnonySys's graph executors (HNSW graphs where selectivity holds and the
int8 scan on the remainder, or a graph on every partition): the global
masked scan (narrow and wide rows, and the admit-dedup slot form), the
group-minima merge, the float32 rerank, the result wire, the chunk engine
of the partitions, the packed and IVF probed scans and the HNSW graph
step run on the card, in CUDA C++ kernels written for sm_90a (`csrc/`, built
with nvcc at first use) wherever the reference runs a Pallas kernel, and
in PyTorch where it leaves the work to XLA. The HNSW graphs are built by
a copy of the reference's native builder (`native/`, g++ at first use). The
package imports neither jax nor the reference package: the host layers
it needs (corpus, quantizers, RBAC world, the SIFT-like and cohere-like
data, config, the planner and its cost model) are copies, held equal to
the reference by tests. Around the engines: arena and tiled-engine
snapshots for a cold start, the micro-batching serving front-end, the
cost models' fitting, and the CLI (`python -m
vectorsearch_rbac_tpu_torch.cli`), whose searching subcommands run on the
card unless given `--device cpu`.

Layer map:
    cli         the ten subcommands, --device    (reference cli.py)
    config      serving config + logger          (reference utils/)
    rbac        RBAC world + the generators      (reference rbac/)
    data/       SIFT-like, cohere-like,          (reference data/)
                synthetic and sparse corpora,
                dataset-file readers, text
                ingestion
    core        corpus, quantizers, device arena (reference core.py)
    models/     the planner's cost models, their (reference models/)
                fitting and validation
    utils/      snapshots and persistence,       (reference utils/)
                stage timers and traces
    serving/    the micro-batching front-end     (reference serving/)
    ops/        flat scans, int8 scans, merge,   (reference ops/)
                rerank, chunk engine, graph
                search and step, k-means, IVF
                probed scan, binary and sparse
                scans, host merge
    csrc/       the CUDA kernels                 (reference Pallas kernels)
    native/     the HNSW graph builder (C++)     (reference native/)
    index/      the index contract; flat, int8   (reference index/)
                flat, HNSW, IVF, binary, sparse
    partition/  RLS, ROLE, USER, AnonySys,       (reference partition/)
                QDTree, tiled and packed
    bench/      workload, oracle, harness,       (reference bench/, bench.py,
                result cache, the bench and its  scripts/)
                cells' runners
"""

from .config import FrameworkConfig
from .core import (ArenaQuant, Corpus, DeviceArena, arena_from_reference,
                   build_device_arena)
from .data import cohere_like_corpus, resolve_dataset, sift_like_corpus
from .rbac import RBACWorld, TreeRBACGenerator
from .partition import build_global_searcher, build_searcher
from .bench import (GroundTruthOracle, generate_query_workload,
                    run_benchmark)

__version__ = "0.1.0"

__all__ = [
    "FrameworkConfig", "ArenaQuant", "Corpus", "DeviceArena",
    "arena_from_reference", "build_device_arena", "cohere_like_corpus",
    "resolve_dataset", "sift_like_corpus", "RBACWorld", "TreeRBACGenerator",
    "build_global_searcher", "build_searcher", "GroundTruthOracle",
    "generate_query_workload", "run_benchmark",
]
