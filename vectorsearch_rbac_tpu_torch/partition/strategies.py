"""Strategies: the global scan (RLS).

Counterpart of vectorsearch_rbac_tpu/partition/strategies.py for the RLS
strategy: one index over the whole arena, the permission check fused into
the scan. ROLE, USER, AnonySys and QDTree are ROADMAP slice 3."""

from __future__ import annotations

from ..config import FrameworkConfig
from ..core import Corpus, DeviceArena
from ..rbac import RBACWorld
from .base import BuiltPartition, PartitionedSearcher, make_partition_index

_NOT_PORTED = ("role", "user", "dynamic", "anonysys", "qdtree")


def build_global_searcher(corpus: Corpus, world: RBACWorld,
                          arena: DeviceArena,
                          cfg: FrameworkConfig) -> PartitionedSearcher:
    """RLS analog: one index over the whole arena, fused mask enforcement."""
    part = BuiltPartition(pid=0, rows=None,
                          index=make_partition_index(arena, None, cfg),
                          label="global")
    return PartitionedSearcher(arena, {0: part}, name="rls")


STRATEGIES = {"rls": build_global_searcher}


def build_searcher(name: str, corpus: Corpus, world: RBACWorld,
                   arena: DeviceArena, cfg: FrameworkConfig,
                   **kwargs) -> PartitionedSearcher:
    """Build a strategy by name."""
    if name in STRATEGIES:
        return STRATEGIES[name](corpus, world, arena, cfg)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"strategy {name!r} is ROADMAP slice 3; the port has 'rls'")
    raise ValueError(f"unknown strategy {name}")
