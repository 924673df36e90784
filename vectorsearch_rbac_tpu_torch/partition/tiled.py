"""TiledSearcher: partitioned serving over contiguous int8 chunk storage.

Counterpart of vectorsearch_rbac_tpu/partition/tiled.py `TiledSearcher`,
snapshots included (`save_snapshot` / `from_snapshot`). Each partition's
rows live once, contiguously, as fixed-size chunks of the quantized
arena, and a query
batch is grouped into per-partition slots of up to q_tile queries, so that
each partition is read once per slot instead of once per query
(ops/tiled_scan.py). Partitions of more than big_chunks chunks form the big
tier instead: each is an Int8FlatIndex over its rows (the fused CUDA scan,
the merge kernels), at group big_group.

The chunk arrays are gathered on the device from the arena's int8 tensors
along the chunk row map (chunk 0 is the dummy all-masked chunk that
padding slots point at; pad rows are zero and admit no query), as the
reference's snapshot restore derives them. The dispatch rules that decide
results are the reference's: the chunk class of a partition, the bucket
of slots per class, and the grouped-epilogue width from the smallest
partition of the class. How slots are batched into dispatches only bounds
the reference's compiles, and results do not depend on it: here a
dispatch takes up to _SLOTS_PER_DISPATCH slots of one class, unpadded,
and every slot's operands are gathered on the device from the pass's one
upload of queries, norms and masks.

A pass is split by profiler spans: tiled.route (host), tiled.big_enqueue
(the big tier's scans and merges, with flat_int8.* inside),
tiled.chunk_scan (the chunk engine, enqueue and fetch), tiled.big_fetch
and tiled.merge (the host's fan-out merge). The searcher's StageTimer
(`.timer`) keeps the reference's stages beside them: route, big_enqueue,
device_scan (the chunk engine and the big tier's fetch), quantize (within
device_scan) and merge.
"""

from __future__ import annotations

import json

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import get_logger
from ..core import DeviceArena
from ..index.flat_int8 import Int8FlatIndex
from ..ops.tiled_scan import tiled_bucket_topk
from ..ops.topk import merge_topk_host
from ..rbac import query_masks_for
from ..utils.tracing import StageTimer
from .base import route_batch

logger = get_logger("partition.tiled")


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """A host array on the device. To a card it goes through pinned memory
    without blocking: a pageable copy would wait for the big tier's queued
    scans, which the chunk engine's host work is meant to overlap."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def chunk_class(nc: int, small_cap: int) -> int:
    """Dispatch chunk-capacity class for an nc-chunk partition (the
    reference's): small_cap, then powers of two and the 3 * 2^k classes
    between them, {small, 12, 16, 24, 32, 48, 64, ...}."""
    if nc <= small_cap:
        return small_cap
    p = _pow2(nc)
    mid = 3 * p // 4
    return mid if nc <= mid else p


def _big_index(arena: DeviceArena, rows, group: int,
               logical: bool) -> Int8FlatIndex:
    """A big-tier partition: the fused-scan index over its arena rows
    (the constructor's and from_snapshot's)."""
    return Int8FlatIndex(arena, np.asarray(rows), query_batch=2048,
                         q_tile=1024, block_rows=8192, group=group,
                         wire="f32", logical=logical)


_SMALL_CHUNKS = 8          # small class: partitions <= 8 chunks
_SLOTS_PER_DISPATCH = 64   # slots per chunk-engine dispatch


class TiledSearcher:
    """Partitioned strategy executor over packed int8 chunks (l2 arenas:
    the chunk engine scores squared L2)."""

    def __init__(
        self,
        arena: DeviceArena,
        partition_rows: Dict[int, np.ndarray],   # pid -> arena row ids
        router: Callable[[int], Sequence[int]],
        name: str,
        chunk_rows: int = 2048,
        q_tile: int = 64,
        big_chunks: int = 48,   # larger partitions form the big tier
        big_group: int = 32,    # the big tier's group-min width
        scan_group: int = 32,   # chunk-engine epilogue group (0 = exact)
        big_logical: bool = False,  # big tier gathers from the shared
                                    # arena per pass (cfg.index.big_logical)
    ):
        q = arena.quant
        if q is None:
            raise ValueError("TiledSearcher needs an int8-quantized arena")
        if arena.metric != "l2":
            raise NotImplementedError(
                f"metric {arena.metric!r}: the chunk engine scores squared "
                "L2; ip/cosine partitions are served by the PackedSearcher "
                "(partition/packed.py), which strategies.packed_searcher "
                "picks for them")
        self.arena = arena
        self.router = router
        # a strategy that routes by query vector as well (QDTree) sets
        # these; see base.PartitionedSearcher
        self.batch_router: Optional[Callable] = None
        self.vector_router: Optional[Callable] = None
        self.name = name
        self.chunk_rows = chunk_rows
        self.q_tile = q_tile
        self.scan_group = scan_group
        self._quant = q
        dev = arena.device

        # big tier: fused-scan indexes over the partition's rows
        self._big: Dict[int, Int8FlatIndex] = {}
        for pid, rows in sorted(partition_rows.items()):
            if -(-len(rows) // chunk_rows) > big_chunks:
                self._big[pid] = _big_index(arena, rows, big_group,
                                            big_logical)

        # chunk 0 is the dummy all-masked chunk padding slots point at
        part_chunks: Dict[int, List[int]] = {}
        n_chunks_total = 1
        for pid, rows in sorted(partition_rows.items()):
            if len(rows) == 0 or pid in self._big:
                continue
            nc = -(-len(rows) // chunk_rows)
            part_chunks[pid] = list(range(n_chunks_total, n_chunks_total + nc))
            n_chunks_total += nc
        row_c = np.full(n_chunks_total * chunk_rows, -1, dtype=np.int32)
        for pid, cids in part_chunks.items():
            rows = np.asarray(partition_rows[pid], dtype=np.int64)
            row_c[cids[0] * chunk_rows:cids[0] * chunk_rows + len(rows)] = rows
        self._rowC = torch.from_numpy(row_c).to(dev).view(
            n_chunks_total, chunk_rows)
        self._gather_chunks()
        self.part_chunks = part_chunks
        self._part_nrows = {pid: len(partition_rows[pid])
                            for pid in part_chunks}
        self.timer = StageTimer()
        d, w = self._vecC.shape[2], self._roleC.shape[2]
        logger.info(
            "tiled searcher '%s': %d chunk-engine partitions, %d chunks x %d "
            "rows (%.1f MB), %d big-tier partitions", name, len(part_chunks),
            n_chunks_total, chunk_rows,
            n_chunks_total * chunk_rows * (d + 4 * w + 4 + 4) / 1e6,
            len(self._big))

    def _gather_chunks(self) -> None:
        """The chunk arrays, gathered on the device from the arena's int8
        tensors along the row map; -1 slots (pads and the dummy chunk)
        get zero rows, whose zero bitsets admit no query."""
        q, arena = self._quant, self.arena
        n_chunks, chunk_rows = self._rowC.shape
        flat = self._rowC.reshape(-1)
        safe = flat.clamp_min(0)
        pad = (flat < 0)
        vec = q.vectors_q.index_select(0, safe)
        nrm = q.norms_q.index_select(0, safe)
        bits = arena.role_bits.index_select(0, safe)
        vec[pad] = 0
        nrm[pad] = 0
        bits[pad] = 0
        self._vecC = vec.view(n_chunks, chunk_rows, -1)
        self._normC = nrm.view(n_chunks, chunk_rows)
        self._roleC = bits.view(n_chunks, chunk_rows, -1)

    # ---------------------------------------------------------- snapshot

    def save_snapshot(self, path: str, pack_arrays: bool = False) -> None:
        """Save the engine so that from_snapshot restores it over an arena
        (utils.persist.save_arena_snapshot) and a router (the plan's, or
        the strategy's). The light form (the default) keeps the chunk row
        map and the routing meta, and from_snapshot gathers the chunk
        arrays on the device along the row map, as the constructor does;
        pack_arrays=True also ships the chunk arrays. The big tier keeps
        each partition's rows, group and logical flag."""
        state = dict(rowC=self._rowC.cpu().numpy())
        if pack_arrays:
            state.update(vecC=self._vecC.cpu().numpy(),
                         normC=self._normC.cpu().numpy(),
                         roleC=self._roleC.cpu().numpy())
        big_meta = {}
        for pid, idx8 in self._big.items():
            state[f"big_rows_{pid}"] = \
                idx8._row_map[:idx8.n_rows].cpu().numpy()
            big_meta[str(pid)] = dict(group=idx8.group,
                                      logical=bool(idx8.logical))
        meta = dict(
            name=self.name, chunk_rows=self.chunk_rows, q_tile=self.q_tile,
            scan_group=self.scan_group,
            part_chunks={str(p): c for p, c in self.part_chunks.items()},
            part_nrows={str(p): n for p, n in self._part_nrows.items()},
            big=big_meta)
        np.savez(path, __meta__=json.dumps(meta), **state)

    @classmethod
    def from_snapshot(cls, arena: DeviceArena, router, path: str
                      ) -> "TiledSearcher":
        """A serving-ready TiledSearcher from save_snapshot's file: no
        quantization and no packing, only uploads (and, from a light
        snapshot, the device gather of the chunk arrays)."""
        self = object.__new__(cls)
        self.arena = arena
        self._quant = arena.quant
        self.router = router
        self.batch_router = None
        self.vector_router = None
        self.timer = StageTimer()
        dev = arena.device
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            self.name = meta["name"]
            self.chunk_rows = int(meta["chunk_rows"])
            self.q_tile = int(meta["q_tile"])
            self.scan_group = int(meta["scan_group"])
            self._rowC = torch.from_numpy(data["rowC"]).to(dev)
            if "vecC" in data.files:
                self._vecC = torch.from_numpy(data["vecC"]).to(dev)
                self._normC = torch.from_numpy(data["normC"]).to(dev)
                self._roleC = torch.from_numpy(data["roleC"]).to(dev)
            else:
                self._gather_chunks()
            self._big = {
                int(pid): _big_index(arena, data[f"big_rows_{pid}"],
                                     int(bm["group"]), bool(bm["logical"]))
                for pid, bm in meta["big"].items()}
        self.part_chunks = {int(p): list(c)
                            for p, c in meta["part_chunks"].items()}
        self._part_nrows = {int(p): int(n)
                            for p, n in meta["part_nrows"].items()}
        return self

    # ------------------------------------------------------------- search

    def _adapt_scan_group(self, pids) -> int:
        """Grouped-epilogue width for one chunk class (the reference's
        rule): keep >= 2048 group minima for the SMALLEST partition of the
        class, dropping to the exact per-chunk epilogue (0) when even
        group 8 cannot (partitions below 16k rows)."""
        if not self.scan_group or not pids:
            return self.scan_group
        min_rows = min(self._part_nrows[pid] for pid in pids)
        fit = min_rows // 2048
        if fit >= 8:
            return min(self.scan_group, 1 << (fit.bit_length() - 1))
        return 0

    def _chunk_engine(self, queries, qmasks, pid_queries, k):
        """Every chunk-engine slot of the pass: [(slots, dists, ids)] on the
        host, slots a list of (pid, query ids) whose rows follow one
        another in dists / ids at q_tile apart."""
        q = self._quant
        dev = self.arena.device
        qt = self.q_tile
        chunks_max = max((len(c) for c in self.part_chunks.values()),
                         default=1)
        small_cap = min(_SMALL_CHUNKS, _pow2(chunks_max))
        buckets: Dict[int, List[Tuple[int, List[int]]]] = {}
        for pid, qidx in pid_queries.items():
            cb = chunk_class(len(self.part_chunks[pid]), small_cap)
            for s in range(0, len(qidx), qt):
                buckets.setdefault(cb, []).append((pid, qidx[s:s + qt]))
        if not buckets:
            return []
        # the dispatches' query and chunk ids, built on the host and
        # uploaded once with the pass's operands (row nq is all zero: the
        # pad queries of a slot admit nothing)
        nq = queries.shape[0]
        dispatches, qsel, csel = [], [], []
        for cb, all_slots in sorted(buckets.items()):
            group = self._adapt_scan_group({pid for pid, _ in all_slots})
            for g0 in range(0, len(all_slots), _SLOTS_PER_DISPATCH):
                slots = all_slots[g0:g0 + _SLOTS_PER_DISPATCH]
                sel = np.full((len(slots), qt), nq, dtype=np.int64)
                cid = np.zeros((len(slots), cb), dtype=np.int64)
                for si, (pid, qidx) in enumerate(slots):
                    sel[si, :len(qidx)] = qidx
                    cids = self.part_chunks[pid]
                    cid[si, :len(cids)] = cids
                dispatches.append((slots, cb, group))
                qsel.append(sel.reshape(-1))
                csel.append(cid.reshape(-1))
        with self.timer.stage("quantize"):
            q8, qn = q.quantize_queries(queries)
        zero = np.zeros((1, q8.shape[1]), np.int8)
        bits = np.concatenate([np.ascontiguousarray(qmasks, np.uint32),
                               np.zeros((1, qmasks.shape[1]), np.uint32)])
        q8_d = _upload(np.concatenate([q8, zero]), dev)
        qn_d = _upload(np.concatenate([qn, [0]]).astype(np.int32), dev)
        m_d = _upload(bits.view(np.int32), dev)
        qsel_d = _upload(np.concatenate(qsel), dev)
        csel_d = _upload(np.concatenate(csel), dev)
        outs = []
        qo = co = 0
        for slots, cb, group in dispatches:
            n = len(slots) * qt
            sel = qsel_d[qo:qo + n]
            cid = csel_d[co:co + len(slots) * cb].view(len(slots), cb)
            qo, co = qo + n, co + len(slots) * cb
            outs.append(tiled_bucket_topk(
                q8_d.index_select(0, sel), qn_d.index_select(0, sel),
                m_d.index_select(0, sel), cid, self._vecC, self._normC,
                self._roleC, self._rowC, 1.0 / q.scale**2, k, cb, qt,
                scan_group=group, score_shift=q.score_shift))
        d_all = torch.cat([d for d, _ in outs]).cpu().numpy()
        i_all = torch.cat([i for _, i in outs]).cpu().numpy()
        res, off = [], 0
        for slots, _, _ in dispatches:
            n = len(slots) * qt
            res.append((slots, d_all[off:off + n], i_all[off:off + n]))
            off += n
        return res

    def search_batch(
        self, queries: np.ndarray, user_ids: np.ndarray,
        user_masks: np.ndarray, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (dists (Q, k), arena row ids (Q, k)); -1 / +inf pads."""
        queries = np.asarray(queries, dtype=np.float32)
        user_ids = np.asarray(user_ids)
        nq = queries.shape[0]
        qmasks = query_masks_for(user_masks, user_ids)

        with record_function("tiled.route"), self.timer.stage("route"):
            pid_queries: Dict[int, List[int]] = {}
            n_pids = np.zeros(nq, dtype=np.int32)
            for qi, routed in enumerate(route_batch(self, queries,
                                                    user_ids)):
                pids = [p for p in routed
                        if p in self.part_chunks or p in self._big]
                n_pids[qi] = len(pids)
                for pid in pids:
                    pid_queries.setdefault(pid, []).append(qi)

        # the big tier first, so its device work runs while the host
        # prepares the chunk engine's dispatches
        big_pending = []
        with record_function("tiled.big_enqueue"), \
                self.timer.stage("big_enqueue"):
            for pid, idx8 in self._big.items():
                qidx = pid_queries.pop(pid, None)
                if qidx:
                    fin = idx8.search_deferred(queries[qidx], qmasks[qidx], k)
                    big_pending.append((qidx, fin))
        with self.timer.stage("device_scan"):
            with record_function("tiled.chunk_scan"):
                results = self._chunk_engine(queries, qmasks, pid_queries, k)
            with record_function("tiled.big_fetch"):
                big_results = [(qidx, *fin()) for qidx, fin in big_pending]

        with record_function("tiled.merge"), self.timer.stage("merge"):
            out_d = np.full((nq, k), np.inf)
            out_i = np.full((nq, k), -1, dtype=np.int64)
            # fan-out merge, vectorized over the multi-partition queries:
            # their candidates gather into one (n_multi, fan_max * k) block
            # merged in one call
            multi_q = np.flatnonzero(n_pids > 1)
            if len(multi_q):
                slot_of = np.full(nq, -1, dtype=np.int64)
                slot_of[multi_q] = np.arange(len(multi_q))
                fan_max = int(n_pids[multi_q].max())
                md = np.full((len(multi_q), fan_max, k), np.inf)
                mi = np.full((len(multi_q), fan_max, k), -1, dtype=np.int64)
                fill = np.zeros(len(multi_q), dtype=np.int32)

            def scatter(qarr: np.ndarray, d: np.ndarray, i: np.ndarray):
                single = n_pids[qarr] == 1
                if single.any():
                    qs = qarr[single]
                    out_d[qs] = d[single]
                    out_i[qs] = i[single]
                for j in np.flatnonzero(~single):
                    sl = slot_of[qarr[j]]
                    md[sl, fill[sl]] = d[j]
                    mi[sl, fill[sl]] = i[j]
                    fill[sl] += 1

            for slots, d, i in results:
                for si, (pid, qidx) in enumerate(slots):
                    base = si * self.q_tile
                    scatter(np.asarray(qidx, dtype=np.int64),
                            d[base:base + len(qidx)],
                            i[base:base + len(qidx)])
            for qidx, d, i in big_results:
                scatter(np.asarray(qidx, dtype=np.int64), d, i)
            if len(multi_q):
                f = len(multi_q)
                mD, mI = merge_topk_host([md.reshape(f, fan_max * k)],
                                         [mi.reshape(f, fan_max * k)], k)
                out_d[multi_q] = mD
                out_i[multi_q] = mI
        return out_d, out_i

    # ------------------------------------------------------------ storage

    def storage_report(self) -> Dict[str, float]:
        """MB of the shared arena, the chunk arrays (int8 rows; bitsets,
        norms and row map) and the big tier's own tensors, as the port
        stores them."""
        mb = 1024 * 1024
        a = self.arena
        arena_vec = a.n_padded * a.dim * a.vectors.element_size()
        arena_aux = a.n_padded * (4 + 4 * a.role_bits.shape[1])
        d = self._vecC.shape[2]
        slots = self._vecC.shape[0] * self._vecC.shape[1]
        pv = slots * d
        pi = slots * (4 * self._roleC.shape[2] + 4 + 4)
        for idx8 in self._big.values():
            b = idx8.storage_bytes()
            pv += b["vectors"]
            pi += b["index"]
        return {
            "arena_vectors_mb": arena_vec / mb,
            "arena_aux_mb": arena_aux / mb,
            "partition_vectors_mb": pv / mb,
            "partition_index_mb": pi / mb,
            "total_mb": (arena_vec + arena_aux + pv + pi) / mb,
            "num_partitions": len(self.part_chunks) + len(self._big),
        }
