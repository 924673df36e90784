"""The RBAC world and the tree generator of the main path.

A copy of the parts of vectorsearch_rbac_tpu/rbac/ that the RLS main path
uses (world.py `RBACWorld`, `query_masks_for`; bitset.py `pack_role_sets`;
generators/tree.py `TreeRBACGenerator`), so that the port runs where the
JAX package is absent. Same seed, same world: tests/test_torch_host.py
holds every array and mapping equal to the reference's. The other
generators, online role insertion and deletion, and the selectivity
reports come with the slices that use them (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Dict, FrozenSet, List, Mapping, Sequence, Tuple

import numpy as np

WORD_BITS = 32

Comb = Tuple[int, ...]  # sorted tuple of role ids: a user's role combination


def num_words(num_roles: int) -> int:
    return max(1, (num_roles + WORD_BITS - 1) // WORD_BITS)


def pack_role_sets(role_sets: Sequence[Sequence[int]],
                   num_roles: int) -> np.ndarray:
    """Pack n role-sets into an (n, W) uint32 bit matrix (bit r % 32 of
    word r // 32 set for role r)."""
    out = np.zeros((len(role_sets), num_words(num_roles)), dtype=np.uint32)
    for i, roles in enumerate(role_sets):
        for r in roles:
            if not 0 <= r < num_roles:
                raise ValueError(f"role id {r} out of range [0, {num_roles})")
            out[i, r // WORD_BITS] |= np.uint32(1 << (r % WORD_BITS))
    return out


def query_masks_for(user_masks: np.ndarray,
                    user_ids: np.ndarray) -> np.ndarray:
    """Per-query masks from the full (num_users, W) user-mask table,
    indexed by user id (never a per-query table: that ambiguity once
    mis-enforced RBAC in the reference)."""
    user_masks = np.asarray(user_masks, dtype=np.uint32)
    user_ids = np.asarray(user_ids)
    if user_masks.ndim != 2:
        raise ValueError("user_masks must be the (num_users, W) table")
    if len(user_ids) and int(user_ids.max()) >= user_masks.shape[0]:
        raise ValueError(
            f"user id {int(user_ids.max())} out of range for a user_masks "
            f"table of {user_masks.shape[0]} rows: pass RBACWorld.user_masks")
    return user_masks[user_ids]


@dataclass(frozen=True)
class RBACWorld:
    """Immutable RBAC universe: user -> sorted role tuple, role -> the
    frozenset of doc ids it may read. Ids are 0-based."""

    num_users: int
    num_roles: int
    num_docs: int
    user_to_roles: Mapping[int, Comb]
    role_to_docs: Mapping[int, FrozenSet[int]]

    def validate(self) -> None:
        for u, roles in self.user_to_roles.items():
            assert 0 <= u < self.num_users, f"bad user id {u}"
            assert roles == tuple(sorted(set(roles))), f"roles of {u}"
            assert all(0 <= r < self.num_roles for r in roles), u
        covered: set = set()
        for r, docs in self.role_to_docs.items():
            assert 0 <= r < self.num_roles, f"bad role id {r}"
            assert all(0 <= d < self.num_docs for d in docs), r
            covered.update(docs)
        assert covered == set(range(self.num_docs)), (
            f"{self.num_docs - len(covered)} documents not reachable by any "
            "role")

    @cached_property
    def words(self) -> int:
        return num_words(self.num_roles)

    @cached_property
    def doc_role_bits(self) -> np.ndarray:
        """(num_docs, W) uint32: bit r set iff role r may read the doc."""
        bits = np.zeros((self.num_docs, self.words), dtype=np.uint32)
        for r, docs in self.role_to_docs.items():
            idx = np.fromiter(docs, dtype=np.int64, count=len(docs))
            np.bitwise_or.at(bits[:, r // WORD_BITS], idx,
                             np.uint32(1 << (r % WORD_BITS)))
        return bits

    @cached_property
    def user_masks(self) -> np.ndarray:
        """(num_users, W) uint32 role bitmask per user."""
        return pack_role_sets(
            [self.user_to_roles.get(u, ()) for u in range(self.num_users)],
            self.num_roles)

    @cached_property
    def combs(self) -> List[Comb]:
        """Distinct user role-combinations, sorted."""
        return sorted({tuple(r) for r in self.user_to_roles.values() if r})

    def user_docs(self, user_id: int) -> FrozenSet[int]:
        docs: set = set()
        for r in self.user_to_roles[user_id]:
            docs.update(self.role_to_docs.get(r, ()))
        return frozenset(docs)


def split_into_chunks(rng: np.random.Generator, n_items: int,
                      n_chunks: int) -> List[np.ndarray]:
    """Shuffle 0..n_items-1 and cut it into n_chunks disjoint runs; the
    last takes the remainder."""
    perm = rng.permutation(n_items)
    size = n_items // n_chunks
    return [perm[i * size:] if i == n_chunks - 1
            else perm[i * size:(i + 1) * size] for i in range(n_chunks)]


class TreeRBACGenerator:
    """Tree RBAC: a role tree of height h, b0..b1 children per node drawn
    depth-first from the role pool; documents split into one disjoint
    chunk per role, each role reading its own chunk and every ancestor's;
    users split evenly over the roles in tree order, one role each."""

    def __init__(self, num_users: int = 10000, num_roles: int = 100,
                 num_docs: int = 10000, h: int = 4, b0: int = 3, b1: int = 4,
                 seed: int = 0):
        if num_roles > num_docs:
            raise ValueError("need at least one document per role")
        self.rng = np.random.default_rng(seed)
        self.num_users, self.num_roles, self.num_docs = (
            num_users, num_roles, num_docs)
        self.h, self.b0, self.b1 = h, b0, b1

    def _build_tree(self) -> Tuple[List[int], Dict[int, int]]:
        """(roles in depth-first order, role -> parent; -1 is the root)."""
        pool = list(range(self.num_roles))
        order: List[int] = []
        parent: Dict[int, int] = {}

        def add_children(p: int, level: int) -> None:
            if level >= self.h or not pool:
                return
            n_children = min(int(self.rng.integers(self.b0, self.b1 + 1)),
                             len(pool))
            for _ in range(n_children):
                if not pool:
                    break
                child = pool.pop(0)
                order.append(child)
                parent[child] = p
                add_children(child, level + 1)

        add_children(-1, 0)
        while pool:   # roles the tree could not absorb hang off the root
            child = pool.pop(0)
            order.append(child)
            parent[child] = -1
        return order, parent

    def generate(self) -> RBACWorld:
        order, parent = self._build_tree()
        chunks = split_into_chunks(self.rng, self.num_docs, len(order))
        own = {role: set(chunks[i].tolist()) for i, role in enumerate(order)}
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
        user_to_roles: Dict[int, Comb] = {}
        for role, users in zip(order, np.array_split(
                np.arange(self.num_users), len(order))):
            for u in users.tolist():
                user_to_roles[u] = (role,)
        world = RBACWorld(num_users=self.num_users, num_roles=self.num_roles,
                          num_docs=self.num_docs, user_to_roles=user_to_roles,
                          role_to_docs=role_to_docs)
        world.validate()
        return world
