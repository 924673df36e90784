"""Sharded masked scans: corpus rows across a mesh, top-k merged once.

Counterpart of vectorsearch_rbac_tpu/parallel/sharded.py. The big operand
(the arena's rows) is row-sharded over the mesh's `shard` axis and
replicated over `repl`; query batches split over `repl`. Each shard runs
the one-device scan on its rows (`ops/scan.masked_scan_topk` for float
arenas, `ops/scan_int8.int8_masked_topk` for the int8 flagship: K1, then
the K3/K4 merge on the card), its local row ids become global (`i +
shard * local_n`), and the S * k candidates of a query are merged exactly
on the replica's first device, with no host sync between shards.

The merge is a stable sort over the (query, shard-major) flattening of
the candidates: among equal distances the lower flat position comes
first, as lax.top_k over the negated distances orders them in the
reference, so ids match its merge (torch.topk's tie order is not
defined). Arrays ingested across processes (parallel/multihost.py
marks them `across_processes`) have the candidates of every rank
all-gathered over the default process group before that sort, rank-major,
which is the global shard-major order; every other array merges in
process, the reference's `process_count() == 1` branch, whatever process
group may have been started for other reasons.

Admissibility comes from the arena's bitsets, where the reference's int8
flagship multiplies role one-hots (`roles8`): the same predicate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..ops.scan import masked_scan_topk
from ..ops.scan_int8 import int8_masked_topk
from .mesh import REPL_AXIS, SHARD_AXIS, Mesh, shard_map_compat


@dataclass(frozen=True)
class ShardedArray:
    """A global (N, ...) array row-sharded over a mesh's shard axis:
    parts[r][s] holds rows [s * N / S, (s + 1) * N / S) on device
    devices[r][s]; shards that share a device share one tensor. With
    `replicated`, every part is the whole array. `row_offset` is the
    global row of local row 0 (a process's first row across processes);
    `across_processes` marks one process's slice of an array that the
    ranks of the default process group hold together, whose searches
    gather their candidates over the group."""

    parts: Tuple[Tuple[torch.Tensor, ...], ...]
    shape: Tuple[int, ...]
    row_offset: int = 0
    replicated: bool = False
    across_processes: bool = False

    @property
    def local_rows(self) -> int:
        return self.parts[0][0].shape[0]

    def gather(self) -> torch.Tensor:
        """The whole array on the CPU (replica 0's parts)."""
        if self.replicated:
            return self.parts[0][0].cpu()
        return torch.cat([p.cpu() for p in self.parts[0]])


def as_tensor(a) -> torch.Tensor:
    """A numpy array (uint32 bitsets as their int32 view) or a tensor."""
    if torch.is_tensor(a):
        return a
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def shard_rows(mesh: Mesh, a, row_offset: int = 0,
               across_processes: bool = False) -> ShardedArray:
    """Row-shard `a` over the mesh's shard axis (its row count must divide
    by the axis), each shard uploaded once to each device that holds it."""
    t = as_tensor(a)
    n_shards = mesh.shape[SHARD_AXIS]
    if t.shape[0] % n_shards:
        raise ValueError(f"{t.shape[0]} rows do not split over {n_shards} "
                         "shards: pad the arena to a multiple of block_rows "
                         "* n_shards")
    local = t.shape[0] // n_shards
    placed: Dict[Tuple[int, torch.device], torch.Tensor] = {}
    parts = []
    for row in mesh.devices:
        cells = []
        for s, dev in enumerate(row):
            if (s, dev) not in placed:
                placed[s, dev] = t[s * local:(s + 1) * local].to(dev)
            cells.append(placed[s, dev])
        parts.append(tuple(cells))
    return ShardedArray(tuple(parts), tuple(t.shape), row_offset,
                        across_processes=across_processes)


def replicate(mesh: Mesh, a) -> ShardedArray:
    """`a` whole on every device of the mesh, uploaded once a device."""
    t = as_tensor(a)
    placed = {dev: t.to(dev) for dev in mesh.distinct_devices()}
    return ShardedArray(tuple(tuple(placed[d] for d in row)
                              for row in mesh.devices),
                        tuple(t.shape), replicated=True)


def shard_arena_arrays(mesh: Mesh, vectors, norms, role_bits
                       ) -> Tuple[ShardedArray, ShardedArray, ShardedArray]:
    """Arena arrays row-sharded over the mesh's shard axis. The row count
    must divide by the axis (pad to a multiple of block_rows * n_shards)."""
    return (shard_rows(mesh, vectors), shard_rows(mesh, norms),
            shard_rows(mesh, role_bits))


# the int8 mirror (codes, int32 norms, bitsets) shards the same way
shard_quant_arrays = shard_arena_arrays


def replica_inputs(mesh: Mesh, *arrays) -> Dict[Tuple[int, torch.device],
                                                 Tuple[torch.Tensor, ...]]:
    """Per-query operands split over the repl axis, each replica's slice
    uploaded to each of its row's devices, all before any scan is queued:
    a pageable host-to-device copy would wait for the queued kernels."""
    n_repl = mesh.shape[REPL_AXIS]
    ts = [as_tensor(a) for a in arrays]
    nq = ts[0].shape[0]
    if nq % n_repl:
        raise ValueError(f"{nq} queries do not split over {n_repl} replicas")
    per = nq // n_repl
    out = {}
    for r, row in enumerate(mesh.devices):
        for dev in row:
            if (r, dev) not in out:
                out[r, dev] = tuple(t[r * per:(r + 1) * per].to(dev)
                                    for t in ts)
    return out


def _global_ids(i: torch.Tensor, offset: int) -> torch.Tensor:
    return torch.where(i >= 0, i + offset, -1)


def _all_gather_ranks(t: torch.Tensor) -> torch.Tensor:
    """(Q, C) on every rank -> (Q, P * C), rank-major, over the default
    process group with `all_gather` (a list of one tensor a rank: one
    call in every torch version, where the single-tensor gather changed
    its name and warns under the old one). gloo's candidates go through
    host memory (ranks that share a card, or CPU processes); nccl's stay
    on the device."""
    dist = torch.distributed
    src = (t.cpu() if dist.get_backend() == "gloo" else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=1).to(t.device)


def merge_shards(mesh: Mesh, grid: List[List[Tuple[torch.Tensor,
                                                   torch.Tensor]]],
                 k: int, across_processes: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A [repl][shard] grid of per-shard (dists (Qr, k), global ids (Qr,
    k)) -> (dists (Q, k), ids (Q, k)) on the mesh's first device: per
    replica, the shard-major candidates (with `across_processes`,
    all-gathered over the default process group) in one stable sort on
    the replica's first device; the replicas' results in order."""
    out_dev = mesh.devices[0][0]
    outs_d, outs_i = [], []
    for r, row in enumerate(grid):
        dev = mesh.devices[r][0]
        flat_d = torch.cat([d.to(dev) for d, _ in row], dim=1)
        flat_i = torch.cat([i.to(dev) for _, i in row], dim=1)
        if across_processes:
            flat_d = _all_gather_ranks(flat_d)
            flat_i = _all_gather_ranks(flat_i)
        srt, pos = torch.sort(flat_d, dim=1, stable=True)
        outs_d.append(srt[:, :k].to(out_dev))
        outs_i.append(flat_i.gather(1, pos[:, :k]).to(out_dev))
    return torch.cat(outs_d), torch.cat(outs_i)


def sharded_masked_topk(
    mesh: Mesh,
    queries,                    # (Q, d) float32, Q % n_repl == 0
    vectors: ShardedArray,      # (Npad, d) row-sharded
    norms: ShardedArray,        # (Npad,)
    role_bits: ShardedArray,    # (Npad, W) int32 bitsets
    query_masks,                # (Q, W) uint32 / int32 user masks
    k: int,
    block_rows: int = 16384,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed exact masked top-k in squared L2: each shard's
    `masked_scan_topk`, then the merge (merge_shards). Returns (dists (Q,
    k), global row ids (Q, k) int32) on the mesh's first device; -1 / +inf
    where empty."""
    local_n = vectors.local_rows
    if local_n % block_rows:
        raise ValueError(f"{local_n} rows a shard is not a multiple of "
                         f"block_rows {block_rows}")
    ins = replica_inputs(mesh, np.asarray(queries, np.float32)
                         if not torch.is_tensor(queries) else queries,
                         query_masks)

    def local(r, s, dev):
        q, m = ins[r, dev]
        d, i = masked_scan_topk(q, vectors.parts[r][s], norms.parts[r][s],
                                role_bits.parts[r][s], m, k,
                                block_rows=block_rows)
        return d, _global_ids(i, vectors.row_offset + s * local_n)

    return merge_shards(mesh, shard_map_compat(local, mesh)(), k,
                        vectors.across_processes)


def sharded_int8_topk(
    mesh: Mesh,
    queries_q,                  # (Q, d_pad) int8, Q % n_repl == 0
    query_norms,                # (Q,) int32 ||q_q||^2
    vectors_q: ShardedArray,    # (Npad, d_pad) int8, row-sharded
    norms_q: ShardedArray,      # (Npad,) int32
    role_bits: ShardedArray,    # (Npad, W) int32 bitsets
    query_bits,                 # (Q, W) uint32 / int32 user masks
    inv_scale_sq: float,
    k: int,
    group: int = 128,
    score_shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The flagship over a mesh: every shard runs `int8_masked_topk` (K1
    and, where their gate takes the shape, the K3/K4 merge kernels on a
    card, the cascade or exact merge where it refuses; their plain
    versions on the CPU) on its rows, then the exact merge of the S * k
    candidates (merge_shards). Returns (dists (Q, k) float32, global row
    ids (Q, k) int32) on the mesh's first device."""
    local_n = vectors_q.local_rows
    ins = replica_inputs(mesh, queries_q, query_norms, query_bits)

    def local(r, s, dev):
        q8, qn, m = ins[r, dev]
        d, i = int8_masked_topk(
            q8, qn, vectors_q.parts[r][s], norms_q.parts[r][s],
            role_bits.parts[r][s], m, float(inv_scale_sq), k, group=group,
            merge="kernel", score_shift=score_shift)
        return d, _global_ids(i, vectors_q.row_offset + s * local_n)

    return merge_shards(mesh, shard_map_compat(local, mesh)(), k,
                        vectors_q.across_processes)
