"""Query-workload generation.

A copy of vectorsearch_rbac_tpu/bench/queries.py `generate_query_workload`
(the port does not import the reference package). It must give identical
arrays for the same seed; a test holds it to that. Each query is an existing corpus block (or a pool vector) sampled
zipf- or uniformly, issued by a user drawn uniformly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..core import Corpus
from ..rbac import RBACWorld


@dataclass
class QueryWorkload:
    vectors: np.ndarray        # (Q, d) float32
    user_ids: np.ndarray       # (Q,) int64
    topk: int
    selectivities: np.ndarray  # (Q,) float64 — user block selectivity
    repetitions: np.ndarray    # (Q,) int32 — 0 unless a cache workload

    @property
    def num_queries(self) -> int:
        return len(self.user_ids)


def user_block_selectivity(corpus: Corpus, world: RBACWorld,
                           user_id: int) -> float:
    """Fraction of corpus blocks readable by the user."""
    docs = world.user_docs(user_id)
    if not docs:
        return 0.0
    offs = corpus.doc_row_offsets
    idx = np.fromiter(docs, dtype=np.int64, count=len(docs))
    blocks = int(np.sum(offs[idx + 1] - offs[idx]))
    return blocks / corpus.n


def generate_query_workload(
    corpus: Corpus,
    world: RBACWorld,
    num_queries: int = 1000,
    topk: int = 10,
    zipf_param: float = 3.0,     # 0 = uniform block sampling
    repetitions: int = 1,        # >1 = cache workload
    query_pool: Optional[np.ndarray] = None,  # external queries
    seed: int = 0,
) -> QueryWorkload:
    rng = np.random.default_rng(seed)
    n_unique = num_queries
    if query_pool is not None:
        pool = np.asarray(query_pool, dtype=np.float32)
        sel_idx = rng.choice(len(pool), size=n_unique,
                             replace=n_unique > len(pool))
        qvecs = pool[sel_idx]
    else:
        if zipf_param and zipf_param > 1:
            block_idx = rng.zipf(zipf_param, size=n_unique) % corpus.n
        else:
            block_idx = rng.choice(corpus.n, size=n_unique, replace=True)
        qvecs = corpus.vectors[block_idx]

    users = rng.choice(world.num_users, size=n_unique, replace=True)

    # memoize selectivity per user (many queries share users)
    sel_cache: Dict[int, float] = {}
    sels = np.empty(n_unique)
    for i, u in enumerate(users.tolist()):
        if u not in sel_cache:
            sel_cache[u] = user_block_selectivity(corpus, world, u)
        sels[i] = sel_cache[u]

    if repetitions > 1:
        qvecs = np.repeat(qvecs, repetitions, axis=0)
        users = np.repeat(users, repetitions)
        sels = np.repeat(sels, repetitions)
        reps = np.tile(np.arange(repetitions, dtype=np.int32), n_unique)
    else:
        reps = np.zeros(n_unique, dtype=np.int32)

    return QueryWorkload(
        vectors=np.ascontiguousarray(qvecs, dtype=np.float32),
        user_ids=users.astype(np.int64),
        topk=topk,
        selectivities=sels,
        repetitions=reps,
    )
