"""Partition-per-device serving: a strategy's partitions placed across a
mesh, scanned on their devices by the chunk engine, merged on the host.

Counterpart of vectorsearch_rbac_tpu/parallel/tiled_sharded.py. Each
device holds a subset of the partitions as contiguous int8 chunks (the
partition/tiled.py layout: chunk 0 the all-masked dummy that padding
slots point at, pad rows with zero bitsets), chosen by a greedy
longest-processing-time placement over the load map (weight x chunk
count). A query routed to partitions on two devices appears in both
devices' slots and is merged on the host like the one-device
multi-partition path. Partitions in `replicate` are placed on every device
and their query tiles take the devices in round-robin turns.

Per chunk class and round, every device's slots (up to the one-device
engine's _SLOTS_PER_DISPATCH a dispatch; the reference's 16 bounded its
compiles, and results do not depend on it) are queued on that device
(ops/tiled_scan.py `tiled_scan_core`, then `finish_scores`) before any
result is read back; the results come back once, after the last round.
The chunk arrays are gathered from the arena's int8 tensors and bitsets
along each device's chunk row map (the TPU's int8 role one-hots and their
on-device expansion are not kept: the chunk engine ANDs int32 mask words).
There is no big tier here, as in the reference: every partition is
chunks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import get_logger
from ..core import DeviceArena
from ..ops.tiled_scan import finish_scores, tiled_scan_core
from ..ops.topk import merge_topk_host
from ..partition.tiled import (_SLOTS_PER_DISPATCH, _SMALL_CHUNKS, _pow2,
                               chunk_class)
from ..rbac import query_masks_for
from ..utils.tracing import StageTimer
from .mesh import SHARD_AXIS

logger = get_logger("parallel.tiled_sharded")


def place_partitions(
    loads: Dict[int, float], n_devices: int,
    replicate: Sequence[int] = (),
) -> Dict[int, Tuple[int, ...]]:
    """Greedy longest-processing-time placement: the heaviest partition
    onto the least-loaded device (ties to the lower device). Returns pid ->
    device ids; replicated pids -> all of them, their load spread evenly.
    `loads` is the optimizer's load map: expected query weight x chunk
    count."""
    placement: Dict[int, Tuple[int, ...]] = {}
    dev_load = np.zeros(n_devices)
    rep = set(replicate)
    for pid in rep:
        if pid in loads:
            placement[pid] = tuple(range(n_devices))
            dev_load += loads[pid] / n_devices
    for pid, load in sorted(loads.items(), key=lambda kv: -kv[1]):
        if pid in rep:
            continue
        dev = int(np.argmin(dev_load))
        placement[pid] = (dev,)
        dev_load[dev] += load
    return placement


class ShardedTiledSearcher:
    """Partitioned strategy executor over a mesh (its first replica row):
    partitions placed per device by load, scanned as int8 chunks."""

    def __init__(
        self,
        arena: DeviceArena,
        partition_rows: Dict[int, np.ndarray],   # pid -> arena row ids
        router: Callable[[int], Sequence[int]],
        mesh,
        name: str = "dynamic_sharded",
        chunk_rows: int = 2048,
        q_tile: int = 64,
        partition_weights: Optional[Dict[int, float]] = None,
        replicate: Sequence[int] = (),
        scan_group: int = 0,   # the chunk engine's grouped epilogue (0:
                               # exact), as partition/tiled.py's
    ):
        q = arena.quant
        if q is None:
            raise ValueError("ShardedTiledSearcher needs an int8-quantized "
                             "arena")
        if arena.metric != "l2":
            raise NotImplementedError(
                f"metric {arena.metric!r}: the chunk engine scores squared L2")
        self.arena = arena
        self.router = router
        self.mesh = mesh
        self.name = name
        self.chunk_rows = chunk_rows
        self.q_tile = q_tile
        self.scan_group = scan_group
        self.timer = StageTimer()
        self._quant = q
        self.devices = mesh.devices[0]
        self.n_devices = mesh.shape[SHARD_AXIS]

        # ---- placement by load map
        n_chunks = {pid: -(-len(rows) // chunk_rows)
                    for pid, rows in partition_rows.items() if len(rows)}
        w = partition_weights or {}
        loads = {pid: nc * float(w.get(pid, 1.0))
                 for pid, nc in n_chunks.items()}
        self.placement = place_partitions(loads, self.n_devices, replicate)

        # ---- per-device chunk row maps (local chunk 0 = dummy)
        dev_chunks = [1] * self.n_devices
        # pid -> {dev -> [local chunk ids]}
        self.part_chunks: Dict[int, Dict[int, List[int]]] = {}
        for pid, devs in sorted(self.placement.items()):
            nc = n_chunks[pid]
            self.part_chunks[pid] = {
                dev: list(range(dev_chunks[dev], dev_chunks[dev] + nc))
                for dev in devs}
            for dev in devs:
                dev_chunks[dev] += nc
        lc_max = max(dev_chunks)
        row_c = np.full((self.n_devices, lc_max * chunk_rows), -1, np.int32)
        for pid, per_dev in self.part_chunks.items():
            rows = np.asarray(partition_rows[pid], dtype=np.int64)
            for dev, cids in per_dev.items():
                c0 = cids[0] * chunk_rows
                row_c[dev, c0:c0 + len(rows)] = rows
        self._chunks = [self._gather(row_c[dev], lc_max, self.devices[dev])
                        for dev in range(self.n_devices)]
        self.chunks_max = max(n_chunks.values(), default=1)
        self._rr = 0  # replica round-robin cursor
        d, words = q.d_pad, arena.role_bits.shape[1]
        logger.info(
            "sharded tiled '%s': %d partitions over %d devices (%d "
            "replicated), %d chunks/device max, %.1f MB/device", name,
            len(self.part_chunks), self.n_devices, len(replicate), lc_max,
            lc_max * chunk_rows * (d + 4 * words + 8) / 1e6)

    def _gather(self, rows: np.ndarray, n_chunks: int, dev):
        """One device's (vectors, norms, bitsets, row map) chunk arrays,
        gathered from the arena along its row map; -1 slots get zero rows,
        whose zero bitsets admit no query."""
        q, arena = self._quant, self.arena
        flat = torch.from_numpy(rows).to(arena.device)
        safe = flat.clamp_min(0).long()
        pad = flat < 0
        vec = q.vectors_q.index_select(0, safe)
        nrm = q.norms_q.index_select(0, safe)
        bits = arena.role_bits.index_select(0, safe)
        vec[pad] = 0
        nrm[pad] = 0
        bits[pad] = 0
        cr = self.chunk_rows
        return tuple(t.view(n_chunks, cr, *t.shape[1:]).to(dev)
                     for t in (vec, nrm, bits, flat))

    def search_batch(
        self, queries: np.ndarray, user_ids: np.ndarray,
        user_masks: np.ndarray, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (dists (Q, k), arena row ids (Q, k)); -1 / +inf pads."""
        q = self._quant
        queries = np.asarray(queries, dtype=np.float32)
        user_ids = np.asarray(user_ids)
        nq = queries.shape[0]
        qmasks = query_masks_for(user_masks, user_ids)
        n_dev = self.n_devices
        qt = self.q_tile

        with self.timer.stage("route"):
            # (dev, pid) -> [query idx]; replicated pids round-robin
            dev_pid_queries: Dict[Tuple[int, int], List[int]] = {}
            n_pids = np.zeros(nq, dtype=np.int32)
            for qi in range(nq):
                pids = [p for p in self.router(int(user_ids[qi]))
                        if p in self.part_chunks]
                n_pids[qi] = len(pids)
                for pid in pids:
                    devs = tuple(self.part_chunks[pid])
                    dev = devs[self._rr % len(devs)]
                    self._rr += 1
                    dev_pid_queries.setdefault((dev, pid), []).append(qi)

        with self.timer.stage("quantize"):
            q8, qn = q.quantize_queries(queries)
            mk = np.ascontiguousarray(qmasks, dtype=np.uint32).view(np.int32)

        # chunk classes as partition/tiled.py's; slots laid out per device
        small_cap = min(_SMALL_CHUNKS, _pow2(self.chunks_max))
        per_class: Dict[int, List[List[Tuple[int, List[int]]]]] = {}
        for (dev, pid), qidx in dev_pid_queries.items():
            nc = len(next(iter(self.part_chunks[pid].values())))
            cb = chunk_class(nc, small_cap)
            slots = per_class.setdefault(cb, [[] for _ in range(n_dev)])
            for s0 in range(0, len(qidx), qt):
                slots[dev].append((pid, qidx[s0:s0 + qt]))

        with self.timer.stage("device_scan"):
            # every dispatch's operands built on the host, each device's
            # uploaded once before its first scan is queued
            jobs = []   # (dev, batch, q8P, qnP, mkP, cidP, cb)
            cap = _SLOTS_PER_DISPATCH
            for cb, dev_slots in sorted(per_class.items()):
                n_rounds = -(-max(len(sl) for sl in dev_slots) // cap)
                for rd in range(n_rounds):
                    for dev in range(n_dev):
                        batch = dev_slots[dev][rd * cap:(rd + 1) * cap]
                        if not batch:
                            continue
                        ns = len(batch)
                        q8P = np.zeros((ns, qt, q8.shape[1]), np.int8)
                        qnP = np.zeros((ns, qt), np.int32)
                        mkP = np.zeros((ns, qt, mk.shape[1]), np.int32)
                        cidP = np.zeros((ns, cb), np.int64)   # 0 = dummy
                        for si, (pid, qidx) in enumerate(batch):
                            q8P[si, :len(qidx)] = q8[qidx]
                            qnP[si, :len(qidx)] = qn[qidx]
                            mkP[si, :len(qidx)] = mk[qidx]
                            cids = self.part_chunks[pid][dev]
                            cidP[si, :len(cids)] = cids
                        jobs.append((dev, batch, q8P, qnP, mkP, cidP, cb))
            ups = [tuple(torch.from_numpy(a).to(self.devices[j[0]])
                         for a in j[2:6]) for j in jobs]
            inv = 1.0 / q.scale**2
            pending = []
            for (dev, batch, *_, cb), (q8d, qnd, mkd, cidd) in zip(jobs, ups):
                vecC, normC, roleC, rowC = self._chunks[dev]
                top, idx = tiled_scan_core(
                    q8d, mkd, cidd, vecC, normC, roleC, rowC, k=k, chunks=cb,
                    score_shift=q.score_shift, scan_group=self.scan_group)
                pending.append((dev, batch, *finish_scores(top, idx, qnd,
                                                           inv)))
            results = [(dev, batch, d.cpu().numpy(), i.cpu().numpy())
                       for dev, batch, d, i in pending]

        with self.timer.stage("merge"):
            out_d = np.full((nq, k), np.inf)
            out_i = np.full((nq, k), -1, dtype=np.int64)
            multi: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
            for dev, batch, d, i in results:
                for si, (pid, qidx) in enumerate(batch):
                    for j, qi in enumerate(qidx):
                        if n_pids[qi] == 1:
                            out_d[qi] = d[si, j]
                            out_i[qi] = i[si, j]
                        else:
                            multi.setdefault(qi, []).append(
                                (d[si, j:j + 1], i[si, j:j + 1]))
            for qi, parts in multi.items():
                md, mi = merge_topk_host([p[0] for p in parts],
                                         [p[1] for p in parts], k)
                out_d[qi] = md[0]
                out_i[qi] = mi[0]
        return out_d, out_i

    def storage_report(self) -> Dict[str, float]:
        mb = 1024 * 1024
        a = self.arena
        arena_vec = a.n_padded * a.dim * a.vectors.element_size()
        arena_aux = a.n_padded * (4 + 4 * a.role_bits.shape[1])
        vecC, _, roleC, _ = self._chunks[0]
        slots = self.n_devices * vecC.shape[0] * vecC.shape[1]
        pv = slots * vecC.shape[2]
        pi = slots * (4 * roleC.shape[2] + 4 + 4)
        return {
            "arena_vectors_mb": arena_vec / mb,
            "arena_aux_mb": arena_aux / mb,
            "partition_vectors_mb": pv / mb,
            "partition_index_mb": pi / mb,
            "total_mb": (arena_vec + arena_aux + pv + pi) / mb,
            "num_partitions": len(self.part_chunks),
            "num_devices": self.n_devices,
        }
