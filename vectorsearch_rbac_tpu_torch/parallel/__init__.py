"""Multi-device serving: the mesh, the sharded scans and searchers, and
the process axis (reference parallel/).

    mesh            the (repl, shard) device grid, make_mesh
    sharded         row-sharded arrays, the sharded float scan and int8
                    flagship, the exact shard merge
    searcher        RLS over a mesh (ShardedGlobalSearcher)
    tiled_sharded   partitions placed per device, the chunk engine
    graph_sharded   HNSW partitions placed per device, the graph search
    multihost       ingestion and serving across processes
                    (torch.distributed, gloo or nccl)
    dryrun          every path once against one device
"""

from .graph_sharded import ShardedGraphSearcher
from .mesh import make_mesh
from .searcher import ShardedGlobalSearcher
from .sharded import shard_arena_arrays, sharded_masked_topk
from .tiled_sharded import ShardedTiledSearcher, place_partitions

__all__ = [
    "make_mesh",
    "sharded_masked_topk",
    "shard_arena_arrays",
    "ShardedGlobalSearcher",
    "ShardedTiledSearcher",
    "ShardedGraphSearcher",
    "place_partitions",
]
