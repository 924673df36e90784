"""The benchmark scenario: bench.py's world and serving configuration.

One place for what bench.py builds by default, so the port's bench entry,
its profile and chip_smoke.py run the same scenario: a SIFT-shaped corpus
(the seeded `sift_like_corpus` twin when no SIFT file is present), the
tree RBAC world of bench.py:128 (100 roles, 10k users), uniform queries
drawn from the corpus's held-out pool, and the rls / flat_approx / int8
serving configuration with the ids wire.
"""

from __future__ import annotations

from typing import Tuple

from ..config import FrameworkConfig
from ..core import Corpus
from ..data import resolve_dataset
from ..rbac import RBACWorld, TreeRBACGenerator
from .queries import QueryWorkload, generate_query_workload


def make_scenario(n: int = 1_000_000, num_queries: int = 32768,
                  topk: int = 100, seed: int = 0, dataset: str = "sift1m"
                  ) -> Tuple[Corpus, RBACWorld, QueryWorkload]:
    """(corpus, world, workload) as bench.py builds them."""
    corpus, pool = resolve_dataset(dataset, num_vectors=n, seed=seed)
    world = TreeRBACGenerator(
        num_users=10_000, num_roles=100, num_docs=corpus.num_docs,
        h=4, b0=3, b1=4, seed=seed).generate()
    workload = generate_query_workload(
        corpus, world, num_queries=num_queries, topk=topk, zipf_param=0,
        query_pool=pool, seed=seed + 1)
    return corpus, world, workload


def serving_config(seed: int = 0, block_rows: int = 131072,
                   batch: int = 2048, topk: int = 100, wire: str = "ids",
                   index: str = "flat_approx",
                   dtype: str = "int8") -> FrameworkConfig:
    """bench.py's serving configuration for the rls strategy."""
    cfg = FrameworkConfig(seed=seed)
    cfg.search.block_rows = block_rows
    cfg.search.batch_size = batch
    cfg.search.topk = topk
    cfg.search.dtype = dtype
    cfg.search.wire_dist = wire
    cfg.index.kind = index
    return cfg
