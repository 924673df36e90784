"""Partition-per-device graph serving: logical HNSW partitions placed
across a mesh, traversed on their devices, merged on the host.

Counterpart of vectorsearch_rbac_tpu/parallel/graph_sharded.py. Each
device holds a subset of a strategy's logical HNSW partitions as a
stacked (L, n_max, M0) graph slab and (L, n_max) row maps (placement:
parallel/tiled_sharded.place_partitions over the rows x weight load map),
and runs the same multi-graph iterative search as the one-device
GraphProbeBatcher (ops/graph_search.py `graph_beam_search_iterative`
with `pids`) over its routed queries. `run` and `pids` are the batcher's,
so a PartitionedSearcher takes either as its `graph_batcher`; jobs bucket
on (ef, harvest) as the batcher groups them, and a job's queries ride on
its partition's device.

What each device holds to score: where the arena's int8 mirror is
lossless, the packed rows (core.build_packed_graph_rows, one row gather a
candidate), as the batcher takes them, so that a card runs the fused
graph search kernel (without them the search would take the step loop);
otherwise the arena's vectors, norms and bitsets. The reference
replicates vectors, norms and bits in both cases. All devices' operands
are uploaded before the first search is queued, and the results read
back after the last.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import get_logger
from ..core import DeviceArena, build_packed_graph_rows, packed_query_operands
from ..ops.graph_search import graph_beam_search_iterative
from ..ops.topk import merge_topk_host
from ..partition.graph_batch import _QCHUNK, _pow2
from ..utils.tracing import StageTimer
from .mesh import SHARD_AXIS
from .tiled_sharded import place_partitions

logger = get_logger("parallel.graph_sharded")


class ShardedGraphSearcher:
    """Logical HNSW partitions placed per device (the mesh's first replica
    row); multi-graph probes on each.

    graph_states: pid -> {"neighbors": (n, M0) int32, "entry": int,
    "row_map": (n,) int32 arena rows}: an HNSWIndex's graph and its row
    map (`_hgraph`, `entry`, `_hrmap`); a state whose "logical" is False
    (a physical index's) is refused, as the batcher refuses one."""

    def __init__(
        self,
        arena: DeviceArena,
        graph_states: Dict[int, dict],
        mesh,
        partition_weights: Optional[Dict[int, float]] = None,
        name: str = "graph_sharded",
    ):
        if not all(st.get("logical", True) for st in graph_states.values()):
            raise ValueError(
                "GraphProbeBatcher needs logical-mode HNSW partitions "
                "(shared-arena serving; cfg.index.hnsw_logical)")
        self.arena = arena
        self.mesh = mesh
        self.name = name
        self.timer = StageTimer()
        self.devices = mesh.devices[0]
        self.n_devices = n_dev = mesh.shape[SHARD_AXIS]
        self.pids = set(graph_states)
        self.metric = arena.metric

        w = partition_weights or {}
        loads = {pid: len(st["row_map"]) * float(w.get(pid, 1.0))
                 for pid, st in graph_states.items()}
        self.placement = place_partitions(loads, n_dev)

        # every partition's graph padded to the largest (graph bytes only)
        n_max = _pow2(max(len(st["row_map"]) for st in graph_states.values()))
        m_max = max(np.asarray(st["neighbors"]).shape[1]
                    for st in graph_states.values())
        per_dev: List[List[int]] = [[] for _ in range(n_dev)]
        for pid, devs in sorted(self.placement.items()):
            per_dev[devs[0]].append(pid)
        l_max = max(1, max(len(p) for p in per_dev))
        g4 = np.full((n_dev, l_max, n_max, m_max), -1, np.int32)
        rm3 = np.full((n_dev, l_max, n_max), -1, np.int32)
        self.slot_of: Dict[int, Tuple[int, int]] = {}   # pid -> (dev, slot)
        self.entry_of: Dict[int, int] = {}
        for dev in range(n_dev):
            for slot, pid in enumerate(per_dev[dev]):
                st = graph_states[pid]
                g = np.asarray(st["neighbors"], np.int32)
                rm = np.asarray(st["row_map"], np.int32)
                g4[dev, slot, :g.shape[0], :g.shape[1]] = g
                rm3[dev, slot, :len(rm)] = rm
                self.slot_of[pid] = (dev, slot)
                self.entry_of[pid] = int(np.asarray(st["entry"]).reshape(-1)[0])
        self._rm_host = rm3
        self._slabs = [(torch.from_numpy(g4[d]).to(dev),
                        torch.from_numpy(rm3[d]).to(dev))
                       for d, dev in enumerate(self.devices)]
        quant = arena.quant
        self.packed = quant is not None and quant.lossless
        if self.packed:
            rows = build_packed_graph_rows(arena)
            held = {dev: (rows.to(dev),) for dev in mesh.distinct_devices()}
        else:
            held = {dev: (arena.vectors.to(dev), arena.norms.to(dev),
                          arena.role_bits.to(dev))
                    for dev in mesh.distinct_devices()}
        self._held = [held[dev] for dev in self.devices]
        logger.info(
            "sharded graphs '%s': %d partitions over %d devices, slab (%d, "
            "%d, %d)/device = %.1f MB graph bytes/device, %s rows held",
            name, len(graph_states), n_dev, l_max, n_max, m_max,
            l_max * n_max * (m_max + 1) * 4 / 1e6,
            "packed" if self.packed else "arena")

    def run(
        self,
        queries: np.ndarray,      # (Q, d) float32: the whole batch
        qmasks: np.ndarray,       # (Q, W) uint32
        jobs: Sequence[Tuple[int, List[int], dict]],  # (pid, q idx, kw)
        k: int,
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """GraphProbeBatcher.run's contract: per job (dists (len(qsub), k),
        arena row ids). Jobs bucket on (ef, harvest), the batcher's group
        key; step budgets ride per query under the bucket's power-of-two
        bound, as there."""
        out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * len(jobs)
        buckets: Dict[Tuple[int, bool], List[int]] = {}
        for j, (pid, qsub, kw) in enumerate(jobs):
            key = (int(kw.get("ef_search", 64)),
                   bool(kw.get("harvest_2hop", False)))
            buckets.setdefault(key, []).append(j)
        for (ef, harvest), job_ids in sorted(buckets.items()):
            self._run_bucket(queries, qmasks, jobs, job_ids, k, ef, harvest,
                             out)
        return out  # type: ignore[return-value]

    def _run_bucket(self, queries, qmasks, jobs, job_ids, k, ef, harvest,
                    out):
        arena = self.arena
        with self.timer.stage("route"):
            # per device: (job, query, slot, entry, budget) rows
            dev_rows: List[List[Tuple[int, int, int, int, int]]] = [
                [] for _ in range(self.n_devices)]
            for j in job_ids:
                pid, qsub, kw = jobs[j]
                dev, slot = self.slot_of[pid]
                ent = int(kw.get("entry_local", self.entry_of[pid]))
                ms = int(kw.get("max_steps", 256))
                dev_rows[dev].extend((j, qi, slot, ent, ms) for qi in qsub)
            ms_bound = _pow2(max(r[4] for rows in dev_rows for r in rows))
            ef_eff = max(ef, k + 1)
            kk = min(k + 8, ef_eff)

        with self.timer.stage("pack"):
            if self.packed:
                dqs, qcd = packed_query_operands(arena, queries)
            chunks = []   # (dev, rows, device operands)
            for dev, rows in enumerate(dev_rows):
                for s in range(0, len(rows), _QCHUNK):
                    part = np.asarray(rows[s:s + _QCHUNK], np.int64)
                    qi = part[:, 1]
                    host = [queries[qi].astype(np.float32),
                            np.ascontiguousarray(qmasks[qi], np.uint32)
                            .view(np.int32),
                            *(part[:, c].astype(np.int32) for c in (3, 2, 4))]
                    if self.packed:
                        host.append(qcd[qi].astype(np.float32))
                    chunks.append((dev, part, [
                        torch.from_numpy(np.ascontiguousarray(a)).to(
                            self.devices[dev]) for a in host]))

        with self.timer.stage("device_scan"):
            pending = []
            for dev, part, ops in chunks:
                g3, rm2 = self._slabs[dev]
                held = self._held[dev]
                kw = (dict(packed_rows=held[0], dq_scale=float(dqs),
                           q_center_dot=ops[5]) if self.packed else {})
                scored = (None, None, None) if self.packed else held
                d, i = graph_beam_search_iterative(
                    ops[0], *scored, g3, ops[1], ops[2], kk, ef_eff,
                    ms_bound, harvest, row_map=rm2, metric=self.metric,
                    pids=ops[3], step_budget=ops[4], **kw)
                pending.append((dev, part, d, i))
            drained = [(dev, part, d.cpu().numpy().astype(np.float64),
                        i.cpu().numpy().astype(np.int64))
                       for dev, part, d, i in pending]

        with self.timer.stage("merge"):
            # local ids -> arena rows, dedupe to k, back to the jobs
            per_job: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
            for dev, part, d, i in drained:
                rows = np.where(i >= 0, self._rm_host[dev][
                    part[:, 2:3], np.maximum(i, 0)].astype(np.int64), -1)
                dd, ii = merge_topk_host([d], [rows], k)
                for r, j in enumerate(part[:, 0]):
                    per_job.setdefault(int(j), []).append((dd[r], ii[r]))
            for j in job_ids:
                pairs = per_job[j]
                out[j] = (np.stack([p[0] for p in pairs]),
                          np.stack([p[1] for p in pairs]))

    def storage_bytes(self) -> Dict[str, int]:
        """Device bytes of the searcher's own copies on all devices: the
        graph and row-map slabs, and the packed rows or arena tables each
        distinct device holds beside the arena's own (GraphProbeBatcher.
        storage_bytes's keys)."""
        slabs = sum(t.numel() * t.element_size()
                    for pair in self._slabs for t in pair)
        a = self.arena
        own = {id(t) for t in (a.vectors, a.norms, a.role_bits)}
        held = {id(t): t.numel() * t.element_size()
                for ts in self._held for t in ts if id(t) not in own}
        return {"graph_slabs": slabs, "packed_rows": sum(held.values())}

    def storage_report(self) -> Dict[str, float]:
        mb = 1024 * 1024
        a = self.arena
        arena_vec = a.n_padded * a.dim * a.vectors.element_size()
        arena_aux = a.n_padded * (4 + 4 * a.role_bits.shape[1])
        b = self.storage_bytes()
        return {
            "arena_vectors_mb": arena_vec / mb,
            "arena_aux_mb": arena_aux / mb,
            "replicated_rows_mb_total": b["packed_rows"] / mb,
            "graph_mb_total": b["graph_slabs"] / mb,
            "num_partitions": len(self.slot_of),
            "num_devices": self.n_devices,
        }
