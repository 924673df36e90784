"""Query-workload generation.

A copy of vectorsearch_rbac_tpu/bench/queries.py: `QueryWorkload` with its
query_dataset.json form (`save_json` / `load_json`),
`generate_query_workload` and `generate_query_workload_for_roles` (the
port does not import the reference package). They give identical arrays
and JSON bytes for the same seed; tests hold them to that. Each query is
an existing corpus block (or a pool vector) sampled zipf- or uniformly,
issued by a user drawn uniformly (or, role-targeted, by a user holding the
role).
"""

from __future__ import annotations

import json
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

    def save_json(self, path: str) -> None:
        """Write the reference's query_dataset.json: a list of {user_id,
        query_vector, topk, query_block_selectivity, repetition}."""
        entries = [{
            "user_id": int(self.user_ids[i]),
            "query_vector": self.vectors[i].tolist(),
            "topk": self.topk,
            "query_block_selectivity": float(self.selectivities[i]),
            "repetition": int(self.repetitions[i]),
        } for i in range(self.num_queries)]
        with open(path, "w") as f:
            json.dump(entries, f)

    @classmethod
    def load_json(cls, path: str) -> "QueryWorkload":
        with open(path) as f:
            entries = json.load(f)
        return cls(
            vectors=np.asarray([e["query_vector"] for e in entries],
                               dtype=np.float32),
            user_ids=np.asarray([e["user_id"] for e in entries],
                                dtype=np.int64),
            topk=entries[0]["topk"] if entries else 10,
            selectivities=np.asarray(
                [e.get("query_block_selectivity", 0.0) for e in entries]),
            repetitions=np.asarray([e.get("repetition", 0) for e in entries],
                                   dtype=np.int32))


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
    return _workload(corpus, world, qvecs, users, topk, repetitions)


def _workload(corpus: Corpus, world: RBACWorld, qvecs: np.ndarray,
              users: np.ndarray, topk: int,
              repetitions: int) -> QueryWorkload:
    """The workload of these queries and users: each user's block
    selectivity (memoized: many queries share users), and each query
    repeated `repetitions` times in a cache workload."""
    sel_cache: Dict[int, float] = {}
    sels = np.empty(len(users))
    for i, u in enumerate(users.tolist()):
        if u not in sel_cache:
            sel_cache[u] = user_block_selectivity(corpus, world, u)
        sels[i] = sel_cache[u]
    if repetitions > 1:
        reps = np.tile(np.arange(repetitions, dtype=np.int32), len(users))
        qvecs = np.repeat(qvecs, repetitions, axis=0)
        users = np.repeat(users, repetitions)
        sels = np.repeat(sels, repetitions)
    else:
        reps = np.zeros(len(users), dtype=np.int32)
    return QueryWorkload(
        vectors=np.ascontiguousarray(qvecs, dtype=np.float32),
        user_ids=users.astype(np.int64),
        topk=topk,
        selectivities=sels,
        repetitions=reps,
    )


def generate_query_workload_for_roles(
    corpus: Corpus,
    world: RBACWorld,
    roles: Optional[np.ndarray] = None,   # role ids to target; all if None
    queries_per_role: int = 10,
    topk: int = 10,
    repetitions: int = 1,
    query_pool: Optional[np.ndarray] = None,
    seed: int = 0,
) -> QueryWorkload:
    """A role-targeted workload: queries_per_role queries for each target
    role, each issued by a user who holds it (a role no user holds gets
    none); with repetitions > 1, the role-targeted cache workload."""
    rng = np.random.default_rng(seed)
    role_ids = (np.asarray(sorted(world.role_to_docs.keys()))
                if roles is None else np.asarray(roles))
    role_users: Dict[int, list] = {int(r): [] for r in role_ids}
    for u, comb in world.user_to_roles.items():
        for r in comb:
            if r in role_users:
                role_users[r].append(u)
    users_out = []
    for r in role_ids:
        cand = role_users[int(r)]
        if cand:
            users_out.extend(int(u) for u in rng.choice(
                cand, size=queries_per_role, replace=True))
    n = len(users_out)
    if query_pool is not None:
        pool = np.asarray(query_pool, dtype=np.float32)
        qvecs = pool[rng.choice(len(pool), size=n, replace=n > len(pool))]
    else:
        qvecs = corpus.vectors[rng.choice(corpus.n, size=n, replace=True)]
    return _workload(corpus, world, qvecs,
                     np.asarray(users_out, dtype=np.int64), topk, repetitions)
