"""The benchmark scenario: bench.py's world and serving configuration.

One place for what bench.py builds, so the port's bench entry, its profile
and chip_smoke.py run the same scenario: the dataset's seeded twin
(`sift_like_corpus` for sift1m, `cohere_like_corpus` for cohere,
`synthetic_corpus` for synthetic, as the reference resolves them when no
file is present), the tree RBAC world of
bench.py:128 (100 roles, 10k users), uniform queries drawn from the
corpus's held-out pool, and bench.py's serving configuration: flat_approx
over the int8 arena, batch 2048 and the ids wire for rls, batch 1024 and
the "u8" wire setting for the partitioned strategies (whose partition
tiers always carry f32 distances, so the setting is never read there).
"""

from __future__ import annotations

from typing import Tuple

from ..config import FrameworkConfig
from ..core import Corpus
from ..data import resolve_dataset
from ..rbac import RBACWorld, TreeRBACGenerator
from .queries import QueryWorkload, generate_query_workload


def make_scenario(n: int = 1_000_000, num_queries: int = 32768,
                  topk: int = 100, seed: int = 0, dataset: str = "sift1m",
                  num_roles: int = 100
                  ) -> Tuple[Corpus, RBACWorld, QueryWorkload]:
    """(corpus, world, workload) as bench.py builds them; num_roles other
    than bench.py's 100 grows the same tree generator's world (roles the
    tree of height 4 cannot absorb hang off its root)."""
    corpus, pool = resolve_dataset(dataset, num_vectors=n, seed=seed)
    world = TreeRBACGenerator(
        num_users=10_000, num_roles=num_roles, num_docs=corpus.num_docs,
        h=4, b0=3, b1=4, seed=seed).generate()
    workload = generate_query_workload(
        corpus, world, num_queries=num_queries, topk=topk, zipf_param=0,
        query_pool=pool, seed=seed + 1)
    return corpus, world, workload


def serving_config(seed: int = 0, block_rows: int = 131072,
                   batch: int = 0, topk: int = 100, wire: str = "",
                   index: str = "flat_approx", dtype: str = "int8",
                   strategy: str = "rls") -> FrameworkConfig:
    """bench.py's serving configuration for a strategy (bench.py:136-145);
    batch 0 and wire "" take the strategy's defaults."""
    cfg = FrameworkConfig(seed=seed)
    cfg.search.block_rows = block_rows
    cfg.search.batch_size = batch or (2048 if strategy == "rls" else 1024)
    cfg.search.topk = topk
    cfg.search.dtype = dtype
    cfg.search.wire_dist = wire or ("ids" if strategy == "rls" else "u8")
    cfg.index.kind = index
    return cfg
