"""Strategies: the global scan (RLS), per-role partitions (ROLE),
combination-role partitions (USER), and the registry.

Counterpart of vectorsearch_rbac_tpu/partition/strategies.py:

- RLS: one index over the whole arena, the permission check fused into
  the scan;
- ROLE: a partition per role holding that role's documents; a user's
  query fans out over their roles and merges;
- USER (comb): a partition per distinct role combination; a query hits
  exactly one partition.

AnonySys (`dynamic`) lives in partition/dynamic/, QDTree in
partition/qdtree.py. The packed layout of ROLE, USER, AnonySys and QDTree
is the TiledSearcher on an int8 l2 arena and the PackedSearcher on every
other (ip and cosine arenas, float32 and bfloat16 arenas of any metric);
packed=False, and every index kind but flat and flat_approx, builds one
index a partition (make_partition_index).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..config import FrameworkConfig
from ..core import Corpus, DeviceArena
from ..rbac import RBACWorld
from .base import (BuiltPartition, PartitionedSearcher,
                   build_partition_indexes, make_partition_index)


def build_global_searcher(corpus: Corpus, world: RBACWorld,
                          arena: DeviceArena,
                          cfg: FrameworkConfig) -> PartitionedSearcher:
    """RLS analog: one index over the whole arena, fused mask enforcement."""
    part = BuiltPartition(pid=0, rows=None,
                          index=make_partition_index(arena, None, cfg),
                          label="global")
    return PartitionedSearcher(arena, {0: part}, router=None, name="rls")


def packed_searcher(arena: DeviceArena, partition_rows, router, name: str,
                    cfg: FrameworkConfig, **tiled_kwargs):
    """The packed layout of a partitioned strategy: the TiledSearcher (with
    tiled_kwargs) on an int8 l2 arena; the PackedSearcher elsewhere, exact
    for index kind flat and approx for flat_approx."""
    if arena.quant is not None and arena.metric == "l2":
        from .tiled import TiledSearcher
        return TiledSearcher(arena, partition_rows, router, name=name,
                             scan_group=cfg.search.scan_group,
                             **tiled_kwargs)
    from .packed import PackedSearcher
    return PackedSearcher(
        arena, partition_rows, router, name=name,
        mode="exact" if cfg.index.kind == "flat" else "approx")


def unpacked_searcher(arena: DeviceArena, partition_rows, router,
                      name: str, cfg: FrameworkConfig) -> PartitionedSearcher:
    """One index per partition (the packed=False layout)."""
    indexes = build_partition_indexes(arena, partition_rows, cfg)
    partitions = {
        pid: BuiltPartition(pid=pid, rows=rows, index=indexes[pid],
                            label=f"{name}_{pid}")
        for pid, rows in partition_rows.items()
    }
    return PartitionedSearcher(arena, partitions, router, name=name)


def build_role_searcher(corpus: Corpus, world: RBACWorld, arena: DeviceArena,
                        cfg: FrameworkConfig, packed: bool = True):
    """ROLE prefilter: a physical partition per role."""
    partition_rows: Dict[int, np.ndarray] = {}
    for role, docs in sorted(world.role_to_docs.items()):
        rows = corpus.rows_for_docs(np.fromiter(docs, dtype=np.int64,
                                                count=len(docs)))
        if len(rows):
            partition_rows[role] = rows
    router = role_router(world, partition_rows)
    if packed and cfg.index.kind in ("flat", "flat_approx"):
        return packed_searcher(arena, partition_rows, router, "role", cfg)
    return unpacked_searcher(arena, partition_rows, router, "role", cfg)


def role_router(world: RBACWorld, pids):
    """ROLE's router: a user's roles that are among pids (the roles that
    hold rows; membership is read at each call)."""
    user_to_roles = world.user_to_roles

    def router(uid: int):
        return tuple(r for r in user_to_roles.get(uid, ()) if r in pids)

    return router


def build_comb_searcher(corpus: Corpus, world: RBACWorld, arena: DeviceArena,
                        cfg: FrameworkConfig, packed: bool = True):
    """USER prefilter: a physical partition per distinct role combination."""
    partition_rows: Dict[int, np.ndarray] = {}
    comb_to_pid: Dict[tuple, int] = {}
    for pid, comb in enumerate(world.combs):
        docs = world.comb_docs(comb)
        rows = corpus.rows_for_docs(np.fromiter(docs, dtype=np.int64,
                                                count=len(docs)))
        if len(rows) == 0:
            continue
        comb_to_pid[comb] = pid
        partition_rows[pid] = rows
    user_to_roles = world.user_to_roles

    def router(uid: int):
        pid = comb_to_pid.get(tuple(user_to_roles.get(uid, ())))
        return (pid,) if pid is not None else ()

    if packed and cfg.index.kind in ("flat", "flat_approx"):
        return packed_searcher(arena, partition_rows, router, "user", cfg)
    return unpacked_searcher(arena, partition_rows, router, "user", cfg)


STRATEGIES = {
    "rls": build_global_searcher,
    "role": build_role_searcher,
    "user": build_comb_searcher,
}


def build_searcher(name: str, corpus: Corpus, world: RBACWorld,
                   arena: DeviceArena, cfg: FrameworkConfig, **kwargs):
    """Build a strategy by name; dynamic (AnonySys) takes the planner's
    kwargs (plan, inputs, comb_weights, single_role_weights, packed, mesh),
    qdtree build_qdtree_searcher's (workload, min_leaf, max_depth,
    radius_scale, tree, packed, ...)."""
    if name in STRATEGIES:
        return STRATEGIES[name](corpus, world, arena, cfg)
    if name in ("dynamic", "anonysys"):
        from .dynamic import build_dynamic_searcher
        return build_dynamic_searcher(corpus, world, arena, cfg, **kwargs)
    if name == "qdtree":
        from .qdtree import build_qdtree_searcher
        return build_qdtree_searcher(corpus, world, arena, cfg, **kwargs)
    raise ValueError(f"unknown strategy {name}")
