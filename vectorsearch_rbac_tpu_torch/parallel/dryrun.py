"""One step of every multi-device path on an n-device mesh, each held
against its one-device counterpart.

    python -m vectorsearch_rbac_tpu_torch.parallel.dryrun [N] [--cpu]

The port's counterpart of the reference's `__graft_entry__.dryrun_multichip`
(the five paths its MULTICHIP record names): the sharded masked scan and
its merge, one sharded k-means step, the sharded int8 flagship, the routed
partitioned search (partitions placed per device) and the sharded graph
probes, on tiny shapes. The mesh is make_mesh's: the visible CUDA devices
by default, or `devices` (the CPU tests pass ["cpu"] * 8; `--cpu` does the
same from the command line).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import build_device_arena
from ..data import synthetic_corpus
from ..index.hnsw import HNSWIndex
from ..ops.kmeans import _update_step, kmeans_init, sharded_kmeans_step
from ..ops.scan import masked_scan_topk
from ..ops.scan_int8 import int8_masked_topk
from ..partition.graph_batch import GraphProbeBatcher
from ..partition.tiled import TiledSearcher
from ..rbac import TreeRBACGenerator
from .graph_sharded import ShardedGraphSearcher
from .mesh import make_mesh
from .searcher import ShardedGlobalSearcher
from .sharded import as_tensor, shard_arena_arrays, sharded_masked_topk
from .tiled_sharded import ShardedTiledSearcher


def _tiny_problem(n_rows, dim=128, n_queries=16, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((n_rows, dim)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    bits = rng.integers(1, 2**31, size=(n_rows, 1),
                        dtype=np.int64).astype(np.uint32)
    queries = rng.standard_normal((n_queries, dim)).astype(np.float32)
    masks = rng.integers(1, 2**31, size=(n_queries, 1),
                         dtype=np.int64).astype(np.uint32)
    return queries, vecs, norms, bits, masks


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def dryrun_multichip(n_devices: int,
                     devices: Optional[Sequence] = None) -> None:
    """Run the five paths once on an n-device mesh (2 replicas where n is
    even) and hold each against one device; raises on any disagreement."""
    n_repl = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, n_replicas=n_repl, devices=devices)
    flat_mesh = make_mesh(n_devices, devices=devices)
    dev = mesh.devices[0][0]
    n_shards = n_devices // n_repl

    # the serving step: sharded masked scan + merge
    block_rows, k = 128, 8
    n_rows = block_rows * n_shards * 2     # 2 blocks a shard
    queries, vecs, norms, bits, masks = _tiny_problem(
        n_rows, n_queries=8 * n_repl)
    dv, dn, db = shard_arena_arrays(mesh, vecs, norms, bits)
    d, i = sharded_masked_topk(mesh, queries, dv, dn, db, masks, k,
                               block_rows=block_rows)
    d, i = d.cpu().numpy(), i.cpu().numpy()
    _check(d.shape == (queries.shape[0], k) and i.shape == d.shape
           and np.all(i >= 0) and np.all(np.diff(d, axis=1) >= -1e-5),
           "the sharded scan's results are malformed")
    od, _ = masked_scan_topk(
        *(as_tensor(a).to(dev) for a in (queries, vecs, norms, bits, masks)),
        k, block_rows=block_rows)
    np.testing.assert_allclose(d, od.cpu().numpy(), rtol=1e-4, atol=1e-3)

    # the training step: one sharded k-means update, against one device
    cents = torch.from_numpy(kmeans_init(vecs, 16, seed=0))
    new_c, _ = sharded_kmeans_step(mesh, dv, cents)
    one_c, _ = _update_step(torch.from_numpy(vecs).to(dev), cents.to(dev))
    new_c = new_c.gather().numpy()
    _check(new_c.shape == (16, vecs.shape[1]) and np.isfinite(new_c).all(),
           "the sharded k-means step's centroids are malformed")
    np.testing.assert_allclose(new_c, one_c.cpu().numpy(), rtol=1e-4,
                               atol=1e-4)

    # the int8 flagship, sharded, against the one-device scan and merge
    # over the same padded arena at the same group width
    w8 = TreeRBACGenerator(num_users=40, num_roles=12, num_docs=64, h=2,
                           b0=3, b1=4, seed=6).generate()
    c8 = synthetic_corpus(num_docs=64, blocks_per_doc=4, dim=32, seed=7)
    s8 = ShardedGlobalSearcher(c8, w8, mesh=mesh, block_rows=128,
                               dtype="int8")
    rng8 = np.random.default_rng(8)
    q8 = rng8.standard_normal((8 * n_repl, c8.dim)).astype(np.float32)
    u8 = rng8.integers(0, w8.num_users, 8 * n_repl)
    d8, i8 = s8.search_batch(q8, u8, w8.user_masks, k=6)
    quant = s8._quant
    qq, qn = quant.quantize_queries(q8)
    od8, oi8 = int8_masked_topk(
        *(as_tensor(a).to(dev) for a in (
            qq, qn, quant.vectors_q.gather(), quant.norms_q.gather(),
            s8._bits.gather(), w8.user_masks[u8])),
        1.0 / quant.scale**2, 6, group=s8._int8_group(),
        score_shift=quant.score_shift)
    np.testing.assert_array_equal(d8, od8.cpu().numpy())
    for qi, want_i in enumerate(oi8.cpu().numpy()):
        got = set(int(x) for x in i8[qi] if x >= 0)
        want = set(int(x) for x in want_i if x >= 0)
        _check(len(got & want) >= max(len(want) - 1, 0),
               f"sharded int8 flagship diverged from one device: query "
               f"{qi}, {got} against {want}")

    # routed partitioned serving: partitions placed per device by load,
    # chunk scans, host merge; against the one-device chunk engine
    world = TreeRBACGenerator(num_users=60, num_roles=12, num_docs=120, h=2,
                              b0=3, b1=4, seed=3).generate()
    corpus = synthetic_corpus(num_docs=120, blocks_per_doc=4, dim=32, seed=4)
    arena = build_device_arena(corpus, world, device=dev, block_rows=128,
                               dtype="int8")
    partition_rows = {}
    for role, docs in sorted(world.role_to_docs.items()):
        rows = corpus.rows_for_docs(
            np.fromiter(docs, dtype=np.int64, count=len(docs)))
        if len(rows):
            partition_rows[role] = rows
    u2r = world.user_to_roles

    def router(uid):
        return tuple(r for r in u2r.get(uid, ()) if r in partition_rows)

    rng = np.random.default_rng(5)
    pq = rng.standard_normal((16, corpus.dim)).astype(np.float32)
    pu = rng.integers(0, world.num_users, 16)
    multi = ShardedTiledSearcher(
        arena, partition_rows, router, flat_mesh, chunk_rows=128, q_tile=8,
        partition_weights={p: len(r) for p, r in partition_rows.items()})
    md, _ = multi.search_batch(pq, pu, world.user_masks, k=8)
    single = TiledSearcher(arena, partition_rows, router, name="role",
                           chunk_rows=128, q_tile=8, scan_group=0)
    sd, _ = single.search_batch(pq, pu, world.user_masks, k=8)
    np.testing.assert_allclose(md, sd, rtol=1e-5, atol=1e-5)

    # partition-per-device graph serving against the one-device batcher
    gparts = {}
    for gpid, (role, rows) in enumerate(sorted(partition_rows.items())):
        if len(rows) >= 40:
            gparts[gpid] = HNSWIndex(arena, rows, m=8, ef_construction=32,
                                     seed=gpid, logical=True)
        if len(gparts) == 3:
            break
    gjobs = [(gpid, list(range(8)), {"ef_search": 16, "max_steps": 24})
             for gpid in gparts]
    gmasks = world.user_masks[pu[:8]].astype(np.uint32)
    r_one = GraphProbeBatcher(arena, gparts).run(pq[:8], gmasks, gjobs, k=4)
    gstates = {gpid: {"neighbors": ix._hgraph, "entry": ix.entry,
                      "row_map": ix._hrmap} for gpid, ix in gparts.items()}
    r_mesh = ShardedGraphSearcher(arena, gstates, flat_mesh).run(
        pq[:8], gmasks, gjobs, k=4)
    for j in range(len(gjobs)):
        np.testing.assert_array_equal(r_one[j][1], r_mesh[j][1])

    print(f"dryrun_multichip OK: mesh {dict(mesh.shape)} on "
          f"{[str(d) for d in mesh.distinct_devices()]}: scan+merge, kmeans, "
          f"sharded int8 flagship, routed partitioned search, and sharded "
          f"graph probes executed ({len(partition_rows)} partitions over "
          f"{n_devices} devices)", flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n = int(args[0]) if args else 8
    dryrun_multichip(n, devices=["cpu"] * n if "--cpu" in sys.argv else None)
