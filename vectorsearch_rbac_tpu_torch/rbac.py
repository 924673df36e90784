"""The RBAC world and the tree generator.

A copy of the parts of vectorsearch_rbac_tpu/rbac/ that the ported paths
use (world.py `RBACWorld` with its combination and selectivity helpers,
`query_masks_for`; bitset.py `pack_role_sets`; generators/tree.py
`TreeRBACGenerator`; the online role insert and delete, world.py
`with_new_role` and `without_role`; the other generators of
rbac/generators/, their `RBACGenerator` base and the `GENERATORS`
registry), so that the port runs where the JAX package is absent. Same
seed, same world: tests/test_torch_host.py and
tests/test_torch_generators.py hold every array and mapping equal to the
reference's.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from collections import defaultdict
from dataclasses import dataclass
from functools import cached_property
from typing import (Dict, FrozenSet, Iterable, List, Mapping, Optional,
                    Sequence, Tuple, Union)

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

    @cached_property
    def comb_user_counts(self) -> Dict[Comb, int]:
        counts: Dict[Comb, int] = defaultdict(int)
        for roles in self.user_to_roles.values():
            if roles:
                counts[tuple(roles)] += 1
        return dict(counts)

    @cached_property
    def comb_weights(self) -> Dict[Comb, float]:
        """comb -> fraction of users holding exactly this combination."""
        total = sum(self.comb_user_counts.values())
        return {c: n / total for c, n in self.comb_user_counts.items()}

    def comb_docs(self, comb: Comb) -> FrozenSet[int]:
        docs: set = set()
        for r in comb:
            docs.update(self.role_to_docs.get(r, ()))
        return frozenset(docs)

    def user_docs(self, user_id: int) -> FrozenSet[int]:
        return self.comb_docs(self.user_to_roles[user_id])

    def role_selectivity(self, role_id: int) -> float:
        """|docs(role)| / |docs|."""
        return len(self.role_to_docs.get(role_id, ())) / max(1, self.num_docs)

    def user_selectivity(self, user_id: int) -> float:
        """|union of the user's roles' docs| / |docs|."""
        return len(self.user_docs(user_id)) / max(1, self.num_docs)

    def average_role_selectivity(self) -> float:
        sels = [self.role_selectivity(r) for r in range(self.num_roles)]
        return float(np.mean(sels)) if sels else 0.0

    def average_user_selectivity(self) -> float:
        sels = [self.user_selectivity(u) for u in self.user_to_roles]
        return float(np.mean(sels)) if sels else 0.0

    def storage_ratio(self) -> float:
        """Sum over roles of |docs(role)| / |docs|: the duplication factor
        of a per-role physical layout."""
        return (sum(len(d) for d in self.role_to_docs.values())
                / max(1, self.num_docs))

    def with_new_role(self, role_docs: Iterable[int],
                      users: Sequence[int] = ()) -> Tuple["RBACWorld", int]:
        """(a new world with one role appended, reading role_docs and
        granted to `users`; the new role's id): online role insertion."""
        new_role = self.num_roles
        r2d = dict(self.role_to_docs)
        r2d[new_role] = frozenset(role_docs)
        u2r = dict(self.user_to_roles)
        for u in users:
            u2r[u] = tuple(sorted(set(u2r.get(u, ())) | {new_role}))
        return RBACWorld(num_users=self.num_users,
                         num_roles=self.num_roles + 1,
                         num_docs=self.num_docs, user_to_roles=u2r,
                         role_to_docs=r2d), new_role

    def without_role(self, role_id: int) -> "RBACWorld":
        """A new world with `role_id` taken from every user and its
        documents' grant dropped: online role deletion. Role ids are not
        renumbered, so bitsets and layouts stay aligned; the slot stays
        empty."""
        r2d = {r: d for r, d in self.role_to_docs.items() if r != role_id}
        u2r = {u: tuple(r for r in roles if r != role_id)
               for u, roles in self.user_to_roles.items()}
        return RBACWorld(num_users=self.num_users, num_roles=self.num_roles,
                         num_docs=self.num_docs, user_to_roles=u2r,
                         role_to_docs=r2d)


def split_into_chunks(rng: np.random.Generator, n_items: int,
                      n_chunks: int) -> List[np.ndarray]:
    """Shuffle 0..n_items-1 and cut it into n_chunks disjoint runs; the
    last takes the remainder."""
    perm = rng.permutation(n_items)
    size = n_items // n_chunks
    return [perm[i * size:] if i == n_chunks - 1
            else perm[i * size:(i + 1) * size] for i in range(n_chunks)]


class RBACGenerator(ABC):
    """Generates an RBACWorld for num_docs documents from a seeded
    np.random.Generator: the same parameters give the same world."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    @abstractmethod
    def generate(self) -> RBACWorld:
        ...


def _unique_draw(rng: np.random.Generator, n_pool: int, lo: int, hi: int,
                 seen: set, what: str) -> Tuple[int, ...]:
    """A sorted tuple of lo..hi distinct ids below n_pool, not in `seen`
    (added to it), within 1,000 draws."""
    for _ in range(1000):
        size = int(rng.integers(lo, hi + 1))
        ids = tuple(sorted(rng.choice(n_pool, size=size,
                                      replace=False).tolist()))
        if ids not in seen:
            seen.add(ids)
            return ids
    raise RuntimeError(f"could not draw a unique {what}")


def _inherit(order: Sequence[int], parent: Mapping[int, int],
             own: Mapping[int, set]) -> Dict[int, FrozenSet[int]]:
    """role -> its own documents and every ancestor's."""
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


class TreeRBACGenerator(RBACGenerator):
    """Tree RBAC: a role tree of height h, b0..b1 children per node drawn
    depth-first from the role pool; documents split into one disjoint
    chunk per role, each role reading its own chunk and every ancestor's;
    users split evenly over the roles in tree order, one role each."""

    def __init__(self, num_users: int = 10000, num_roles: int = 100,
                 num_docs: int = 10000, h: int = 4, b0: int = 3, b1: int = 4,
                 seed: int = 0):
        if num_roles > num_docs:
            raise ValueError("need at least one document per role")
        super().__init__(seed)
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

    def _world(self, order: Sequence[int], role_to_docs) -> RBACWorld:
        """Users split evenly over the roles in tree order, one role
        each."""
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

    def generate(self) -> RBACWorld:
        order, parent = self._build_tree()
        chunks = split_into_chunks(self.rng, self.num_docs, len(order))
        own = {role: set(chunks[i].tolist()) for i, role in enumerate(order)}
        return self._world(order, _inherit(order, parent, own))


class SharingTreeRBACGenerator(TreeRBACGenerator):
    """The tree generator's role tree, with shared documents:
    percent_shared percent of the documents each go to Poisson(mean)
    nodes (clipped to [min_roles, max_roles]), the rest are dealt one
    node each, round-robin over shuffled nodes; a role reads its node's
    documents and every ancestor's."""

    def __init__(self, num_users: int = 10000, num_roles: int = 100,
                 num_docs: int = 10000, h: int = 4, b0: int = 3, b1: int = 4,
                 doc_sharing_distribution: Tuple[float, float, int, int] = (
                     30, 3, 1, 10),
                 seed: int = 0):
        super().__init__(num_users, num_roles, num_docs, h, b0, b1, seed)
        self.doc_sharing_distribution = doc_sharing_distribution

    def generate(self) -> RBACWorld:
        order, parent = self._build_tree()
        n_nodes = len(order)
        percent_shared, poisson_mean, min_roles, max_roles = \
            self.doc_sharing_distribution
        docs = self.rng.permutation(self.num_docs)
        n_shared = round(percent_shared / 100 * self.num_docs)
        degrees = np.clip(self.rng.poisson(lam=poisson_mean, size=n_shared),
                          min_roles, min(max_roles, n_nodes))
        own: Dict[int, set] = {role: set() for role in order}
        for doc, degree in zip(docs[:n_shared].tolist(), degrees.tolist()):
            for node in self.rng.choice(n_nodes, size=degree, replace=False):
                own[order[int(node)]].add(doc)
        shuffled = self.rng.permutation(n_nodes)
        for i, doc in enumerate(docs[n_shared:].tolist()):
            own[order[int(shuffled[i % n_nodes])]].add(doc)
        return self._world(order, _inherit(order, parent, own))


class RandomRBACGenerator(RBACGenerator):
    """Random RBAC: each user 1..m_roles distinct roles; each role a unique
    random set of m_perms // 2..m_perms documents; an uncovered document
    goes to a random role still under m_perms."""

    def __init__(self, num_users: int = 10000, num_roles: int = 100,
                 num_docs: int = 10000, m_roles: int = 3, m_perms: int = 300,
                 seed: int = 0):
        super().__init__(seed)
        if num_roles * m_perms < num_docs:
            raise ValueError("num_roles * m_perms must cover num_docs")
        self.num_users, self.num_roles, self.num_docs = (
            num_users, num_roles, num_docs)
        self.m_roles, self.m_perms = m_roles, m_perms

    def generate(self) -> RBACWorld:
        rng = self.rng
        user_to_roles: Dict[int, Comb] = {}
        for u in range(self.num_users):
            n = int(rng.integers(1, self.m_roles + 1))
            roles = rng.choice(self.num_roles, size=n, replace=False)
            user_to_roles[u] = tuple(sorted(roles.tolist()))
        seen: set = set()
        role_docs = {r: set(_unique_draw(
            rng, self.num_docs, max(1, self.m_perms // 2), self.m_perms, seen,
            "permission set")) for r in range(self.num_roles)}
        covered = set().union(*role_docs.values())
        for doc in sorted(set(range(self.num_docs)) - covered):
            for _ in range(10 * self.num_roles):
                r = int(rng.integers(self.num_roles))
                if len(role_docs[r]) < self.m_perms:
                    role_docs[r].add(doc)
                    break
            else:   # every role full: place it anyway, coverage stays total
                role_docs[int(rng.integers(self.num_roles))].add(doc)
        world = RBACWorld(
            num_users=self.num_users, num_roles=self.num_roles,
            num_docs=self.num_docs, user_to_roles=user_to_roles,
            role_to_docs={r: frozenset(d) for r, d in role_docs.items()})
        world.validate()
        return world


def _business_users(rng: np.random.Generator, num_users: int, n_broles: int,
                    m_broles: int, brole_froles: Mapping[int, Comb]
                    ) -> Dict[int, Comb]:
    """Each user holds 1..m_broles business roles; their role set is the
    union of the functional roles behind them."""
    user_to_roles: Dict[int, Comb] = {}
    for u in range(num_users):
        n_b = int(rng.integers(1, m_broles + 1))
        froles: set = set()
        for b in rng.choice(n_broles, size=n_b, replace=False).tolist():
            froles.update(brole_froles[b])
        user_to_roles[u] = tuple(sorted(froles))
    return user_to_roles


class ERBACGenerator(RBACGenerator):
    """Enterprise RBAC: n_froles functional roles, each a unique random set
    of 1..m_perms documents (uncovered documents dealt round-robin under
    m_perms); n_broles business roles, each a unique set of 1..m_froles
    functional roles; users hold 1..m_broles business roles. The world's
    roles are the functional roles."""

    def __init__(self, num_users: int = 10000, n_froles: int = 100,
                 n_broles: int = 50, num_docs: int = 10000,
                 m_perms: int = 300, m_froles: int = 3, m_broles: int = 2,
                 seed: int = 0):
        super().__init__(seed)
        if n_froles * m_perms < num_docs:
            raise ValueError("n_froles * m_perms must cover num_docs")
        self.num_users, self.n_froles, self.n_broles = (
            num_users, n_froles, n_broles)
        self.num_docs, self.m_perms = num_docs, m_perms
        self.m_froles, self.m_broles = m_froles, m_broles

    def generate(self) -> RBACWorld:
        rng = self.rng
        seen: set = set()
        frole_docs = {r: set(_unique_draw(rng, self.num_docs, 1, self.m_perms,
                                          seen, "permission set"))
                      for r in range(self.n_froles)}
        covered = set().union(*frole_docs.values())
        ptr = 0
        for doc in sorted(set(range(self.num_docs)) - covered):
            for _ in range(self.n_froles):
                role = ptr % self.n_froles
                ptr += 1
                if len(frole_docs[role]) < self.m_perms:
                    frole_docs[role].add(doc)
                    break
            else:   # every role at m_perms: coverage stays total
                frole_docs[ptr % self.n_froles].add(doc)
                ptr += 1
        seen_b: set = set()
        brole_froles = {b: _unique_draw(rng, self.n_froles, 1, self.m_froles,
                                        seen_b, "business role")
                        for b in range(self.n_broles)}
        world = RBACWorld(
            num_users=self.num_users, num_roles=self.n_froles,
            num_docs=self.num_docs,
            user_to_roles=_business_users(rng, self.num_users, self.n_broles,
                                          self.m_broles, brole_froles),
            role_to_docs={r: frozenset(d) for r, d in frole_docs.items()})
        world.validate()
        return world


def synthetic_categories(num_docs: int, num_categories: int, seed: int = 0,
                         zipf_a: float = 1.5) -> np.ndarray:
    """Zipf-skewed category labels (arXiv category sizes are
    heavy-tailed)."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(zipf_a, size=num_docs) - 1
    return (raw % num_categories).astype(np.int64)


class ArxivBusinessRBACGenerator(RBACGenerator):
    """Category-driven business roles: each document category with
    documents is a functional role owning them; n_broles business roles
    each take a unique set of 1..m_froles functional roles; users hold
    1..m_broles business roles. Categories come from doc_categories (doc
    id -> category; data.load_arxiv_categories reads them from arXiv's
    metadata file), else from synthetic_categories."""

    def __init__(self, num_users: int = 10000, n_broles: int = 50,
                 num_docs: int = 10000,
                 doc_categories: Optional[Union[Mapping[int, int],
                                                np.ndarray]] = None,
                 num_categories: int = 40, m_froles: int = 3,
                 m_broles: int = 2, seed: int = 0):
        super().__init__(seed)
        self.num_users, self.n_broles, self.num_docs = (
            num_users, n_broles, num_docs)
        self.m_froles, self.m_broles = m_froles, m_broles
        if doc_categories is None:
            doc_categories = synthetic_categories(num_docs, num_categories,
                                                  seed)
        self.doc_categories = (
            doc_categories if isinstance(doc_categories, np.ndarray)
            else np.asarray([doc_categories[d] for d in range(num_docs)],
                            dtype=np.int64))

    def generate(self) -> RBACWorld:
        rng = self.rng
        cat_docs: Dict[int, set] = defaultdict(set)
        for doc, cat in enumerate(self.doc_categories.tolist()):
            cat_docs[int(cat)].add(doc)
        cats = sorted(cat_docs)
        n_froles = len(cats)
        seen: set = set()
        brole_froles = {b: _unique_draw(rng, n_froles, 1, self.m_froles,
                                        seen, "business role")
                        for b in range(self.n_broles)}
        world = RBACWorld(
            num_users=self.num_users, num_roles=n_froles,
            num_docs=self.num_docs,
            user_to_roles=_business_users(rng, self.num_users, self.n_broles,
                                          self.m_broles, brole_froles),
            role_to_docs={i: frozenset(cat_docs[c])
                          for i, c in enumerate(cats)})
        world.validate()
        return world


GENERATORS = {
    "tree": TreeRBACGenerator,
    "sharing_tree": SharingTreeRBACGenerator,
    "erbac": ERBACGenerator,
    "random": RandomRBACGenerator,
    "arxiv_business": ArxivBusinessRBACGenerator,
}
