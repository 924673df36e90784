"""Tree RBAC world: the benchmark's frozen copy of the generator.

Frozen from vectorsearch_rbac_tpu_torch/rbac.py at commit 67fd89a
(`TreeRBACGenerator`, `split_into_chunks`, `_inherit`, `pack_role_sets`,
`RBACWorld.doc_role_bits`, `RBACWorld.validate`'s coverage rule), itself a
copy of the reference's `tree_based_rbac_data_generator.py`: a role tree of
height h with b0..b1 children per node drawn depth-first from the role
pool; documents split into one disjoint chunk per role, each role reading
its own chunk and every ancestor's; users split evenly over the roles in
tree order, one role each.

`make(spec, num_docs, seed)` returns a `World` of plain Python and numpy
values: the program builds its own world object from `user_to_roles` and
`role_to_docs`, the reference reads `user_masks` and `doc_role_bits`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Mapping, Sequence, Tuple

import numpy as np

WORD_BITS = 32


@dataclass(frozen=True)
class World:
    num_users: int
    num_roles: int
    num_docs: int
    user_to_roles: Dict[int, Tuple[int, ...]]
    role_to_docs: Dict[int, FrozenSet[int]]
    user_masks: np.ndarray      # (num_users, W) uint32
    doc_role_bits: np.ndarray   # (num_docs, W) uint32

    @property
    def words(self) -> int:
        return self.user_masks.shape[1]


def num_words(num_roles: int) -> int:
    return max(1, (num_roles + WORD_BITS - 1) // WORD_BITS)


def split_into_chunks(rng: np.random.Generator, n_items: int,
                      n_chunks: int) -> List[np.ndarray]:
    perm = rng.permutation(n_items)
    size = n_items // n_chunks
    return [perm[i * size:] if i == n_chunks - 1
            else perm[i * size:(i + 1) * size] for i in range(n_chunks)]


def _inherit(order: Sequence[int], parent: Mapping[int, int],
             own: Mapping[int, set]) -> Dict[int, FrozenSet[int]]:
    role_to_docs: Dict[int, FrozenSet[int]] = {}

    def full_docs(role: int) -> FrozenSet[int]:
        if role not in role_to_docs:
            docs = set(own[role])
            if parent[role] != -1:
                docs |= full_docs(parent[role])
            role_to_docs[role] = frozenset(docs)
        return role_to_docs[role]

    for role in order:
        full_docs(role)
    return role_to_docs


def _build_tree(rng: np.random.Generator, num_roles: int, h: int, b0: int,
                b1: int) -> Tuple[List[int], Dict[int, int]]:
    pool = list(range(num_roles))
    order: List[int] = []
    parent: Dict[int, int] = {}

    def add_children(p: int, level: int) -> None:
        if level >= h or not pool:
            return
        n_children = min(int(rng.integers(b0, b1 + 1)), len(pool))
        for _ in range(n_children):
            if not pool:
                break
            child = pool.pop(0)
            order.append(child)
            parent[child] = p
            add_children(child, level + 1)

    add_children(-1, 0)
    while pool:
        child = pool.pop(0)
        order.append(child)
        parent[child] = -1
    return order, parent


def pack_role_sets(role_sets: Sequence[Sequence[int]],
                   num_roles: int) -> np.ndarray:
    out = np.zeros((len(role_sets), num_words(num_roles)), dtype=np.uint32)
    for i, roles in enumerate(role_sets):
        for r in roles:
            out[i, r // WORD_BITS] |= np.uint32(1 << (r % WORD_BITS))
    return out


def doc_role_bits(role_to_docs: Mapping[int, FrozenSet[int]], num_docs: int,
                  num_roles: int) -> np.ndarray:
    bits = np.zeros((num_docs, num_words(num_roles)), dtype=np.uint32)
    for r, docs in role_to_docs.items():
        idx = np.fromiter(docs, dtype=np.int64, count=len(docs))
        np.bitwise_or.at(bits[:, r // WORD_BITS], idx,
                         np.uint32(1 << (r % WORD_BITS)))
    return bits


def generate(num_users: int, num_roles: int, num_docs: int, h: int, b0: int,
             b1: int, seed: int) -> World:
    if num_roles > num_docs:
        raise ValueError("need at least one document per role")
    rng = np.random.default_rng(seed)
    order, parent = _build_tree(rng, num_roles, h, b0, b1)
    chunks = split_into_chunks(rng, num_docs, len(order))
    own = {role: set(chunks[i].tolist()) for i, role in enumerate(order)}
    role_to_docs = _inherit(order, parent, own)
    user_to_roles: Dict[int, Tuple[int, ...]] = {}
    for role, users in zip(order, np.array_split(np.arange(num_users),
                                                 len(order))):
        for u in users.tolist():
            user_to_roles[u] = (role,)
    covered = set().union(*role_to_docs.values())
    if covered != set(range(num_docs)):
        raise ValueError(f"{num_docs - len(covered)} documents not reachable "
                         "by any role")
    return World(
        num_users=num_users, num_roles=num_roles, num_docs=num_docs,
        user_to_roles=user_to_roles, role_to_docs=role_to_docs,
        user_masks=pack_role_sets(
            [user_to_roles.get(u, ()) for u in range(num_users)], num_roles),
        doc_role_bits=doc_role_bits(role_to_docs, num_docs, num_roles))


def make(spec: Mapping, num_docs: int, seed: int) -> World:
    """The world a config's "world" block describes, over num_docs
    documents, from seed."""
    return generate(num_users=int(spec["num_users"]),
                    num_roles=int(spec["num_roles"]), num_docs=num_docs,
                    h=int(spec["h"]), b0=int(spec["b0"]), b1=int(spec["b1"]),
                    seed=seed)
