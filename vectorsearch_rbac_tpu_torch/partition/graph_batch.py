"""GraphProbeBatcher: multi-partition graph search in slab dispatches.

Counterpart of vectorsearch_rbac_tpu/partition/graph_batch.py. A hybrid
(or HNSW) AnonySys searcher routes a query batch to many per-(comb,
partition) probe groups; here the HNSW partitions (which all serve from
the shared arena through their row maps: logical mode, which the batcher
requires) of one padded size stack into a (P, n_class, M0) graph slab and
a (P, n_class) row-map slab on the device, and every probe group that
shares (class, ef, harvest) joins ONE multi-graph iterative search
(ops/graph_search.py `pids` mode): each query carries its partition's slot
and traverses graph[slot], scoring rows of the shared arena. A group's step budgets ride
per query (`step_budget`), under the power-of-two bound of the group's
largest.

The slab merge rule, the 4096-query chunk and the host drain (local ids to
arena rows, dedupe to k) are the reference's. Scoring takes the packed
rows (core.build_packed_graph_rows) where the arena's int8 mirror is
lossless, as the reference's does; the slab dispatch then runs the fused
graph search kernel (ops/graph_search.py graph_search_fused) on the card,
or the step loop where a group takes the 2-hop harvest or a shape the
fused kernel does not take (ef above 512, M0 above 64, budgets past 4096
steps).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import get_logger
from ..core import DeviceArena, build_packed_graph_rows, packed_query_operands
from ..ops.graph_search import graph_beam_search_iterative
from ..ops.topk import merge_topk_host

logger = get_logger("partition.graph_batch")

_QCHUNK = 4096   # queries per dispatch (the reference's)


def _pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def slab_classes(shapes: Dict[int, Tuple[int, int]]
                 ) -> Dict[Tuple[int, int], List[int]]:
    """{pid: (n_pad, M0)} -> {slab shape: pids}: the reference's merge rule
    (:85-133). Every shape class joins one slab padded to the running
    largest (n, M0), smallest first, while the padded cells stay within
    3x the real cells; the classes after the first refusal keep their own
    slabs."""
    by_class: Dict[Tuple[int, int], List[int]] = {}
    for pid, shape in sorted(shapes.items()):
        by_class.setdefault(shape, []).append(pid)
    if len(by_class) <= 1:
        return by_class
    cells = {s: s[0] * (s[1] + 1) * len(p) for s, p in by_class.items()}
    merged: List[Tuple[int, int]] = []
    n_parts = 0
    for s in sorted(by_class):
        cand = merged + [s]
        n_cand = n_parts + len(by_class[s])
        n_run = max(c[0] for c in cand)
        m_run = max(c[1] for c in cand)
        if n_run * (m_run + 1) * n_cand <= 3 * sum(cells[c] for c in cand):
            merged, n_parts = cand, n_cand
        else:
            break
    if len(merged) <= 1:
        return by_class
    out = {(max(s[0] for s in merged), max(s[1] for s in merged)):
           sorted(p for s in merged for p in by_class[s])}
    for s in by_class:
        if s not in merged:
            out[s] = by_class[s]
    return out


class GraphProbeBatcher:
    """Stacks HNSW partitions into per-class device slabs and
    serves probe groups in batched multi-graph dispatches."""

    def __init__(self, arena: DeviceArena, hnsw_parts: Dict[int, object]):
        for idx in hnsw_parts.values():
            if not getattr(idx, "logical", False):
                raise ValueError(
                    "GraphProbeBatcher needs logical-mode HNSW partitions "
                    "(shared-arena serving; cfg.index.hnsw_logical)")
        self.arena = arena
        self.pids = set(hnsw_parts)
        self.metric = arena.metric
        self.entry_of = {pid: int(idx.entry)
                         for pid, idx in hnsw_parts.items()}
        classes = slab_classes({pid: idx._hgraph.shape
                                for pid, idx in hnsw_parts.items()})
        dev = arena.device
        self.class_of: Dict[int, Tuple[int, int]] = {}
        self.slot_of: Dict[int, int] = {}
        self.slabs: Dict[Tuple[int, int], Tuple[torch.Tensor,
                                                torch.Tensor]] = {}
        self.rowmap_host: Dict[Tuple[int, int], np.ndarray] = {}
        for (n_max, m_max), pids in classes.items():
            g3 = np.full((len(pids), n_max, m_max), -1, np.int32)
            rm2 = np.full((len(pids), n_max), -1, np.int32)
            for slot, pid in enumerate(pids):
                g, rm = hnsw_parts[pid]._hgraph, hnsw_parts[pid]._hrmap
                g3[slot, :g.shape[0], :g.shape[1]] = g
                rm2[slot, :len(rm)] = rm
                self.class_of[pid] = (n_max, m_max)
                self.slot_of[pid] = slot
            self.slabs[(n_max, m_max)] = (torch.from_numpy(g3).to(dev),
                                          torch.from_numpy(rm2).to(dev))
            self.rowmap_host[(n_max, m_max)] = rm2
        self._packed: Optional[torch.Tensor] = None
        logger.info("graph batcher: %d partitions in %d classes %s",
                    len(hnsw_parts), len(classes),
                    sorted((s[0], len(p)) for s, p in classes.items()))

    def storage_bytes(self) -> Dict[str, int]:
        """Device bytes of the batcher's own copies: the graph and row-map
        slabs, and the packed rows (built at the first run on a lossless
        arena, counted from then on as from the start)."""
        slabs = sum(t.numel() * t.element_size()
                    for pair in self.slabs.values() for t in pair)
        quant = self.arena.quant
        packed = 0
        if quant is not None and quant.lossless:
            packed = self.arena.n_padded * (
                quant.d_pad + 4 * self.arena.role_bits.shape[1] + 4)
        return {"graph_slabs": slabs, "packed_rows": packed}

    def run(self, queries: np.ndarray, qmasks: np.ndarray,
            jobs: Sequence[Tuple[int, List[int], dict]],
            k: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Execute all probe jobs (pid, query indices into `queries`,
        probe kwargs) in batched dispatches. Returns, per job, (dists
        (len(qsub), k), arena row ids (len(qsub), k))."""
        arena = self.arena
        dev = arena.device
        quant = arena.quant
        packed = quant is not None and quant.lossless
        if packed:
            if self._packed is None:
                self._packed = build_packed_graph_rows(arena)
            dqs, qcd = packed_query_operands(arena, queries)
        out: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * len(jobs)
        groups: Dict[tuple, List[int]] = {}
        for j, (pid, _, kw) in enumerate(jobs):
            key = (self.class_of[pid], int(kw.get("ef_search", 64)),
                   bool(kw.get("harvest_2hop", False)))
            groups.setdefault(key, []).append(j)
        for (shape, ef, harv), job_ids in sorted(groups.items()):
            g3, rm2 = self.slabs[shape]
            qis: List[int] = []
            pvec: List[int] = []
            evec: List[int] = []
            bvec: List[int] = []
            spans: List[Tuple[int, int, int]] = []
            for j in job_ids:
                pid, qsub, kw = jobs[j]
                spans.append((j, len(qis), len(qsub)))
                qis.extend(qsub)
                pvec.extend([self.slot_of[pid]] * len(qsub))
                evec.extend([int(kw.get("entry_local", self.entry_of[pid]))]
                            * len(qsub))
                bvec.extend([int(kw.get("max_steps", 256))] * len(qsub))
            qarr = np.asarray(qis, dtype=np.int64)
            parr = np.asarray(pvec, dtype=np.int32)
            earr = np.asarray(evec, dtype=np.int32)
            barr = np.asarray(bvec, dtype=np.int32)
            ms_bound = _pow2(int(barr.max()))
            ef_eff = max(ef, k + 1)
            kk = min(k + 8, ef_eff)
            rm_host = self.rowmap_host[shape]
            dd = np.empty((len(qarr), k), np.float32)
            ii = np.empty((len(qarr), k), np.int64)
            for s in range(0, len(qarr), _QCHUNK):
                e = min(s + _QCHUNK, len(qarr))
                bs = _QCHUNK if len(qarr) > _QCHUNK else _pow2(e - s)
                qb = np.zeros((bs, queries.shape[1]), np.float32)
                mb = np.zeros((bs, qmasks.shape[1]), np.uint32)
                pb, eb, bb = (np.zeros(bs, np.int32) for _ in range(3))
                qb[:e - s] = queries[qarr[s:e]]
                mb[:e - s] = qmasks[qarr[s:e]]
                pb[:e - s], eb[:e - s], bb[:e - s] = (
                    parr[s:e], earr[s:e], barr[s:e])
                t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                packed_kw = {}
                if packed:
                    qcd_b = np.zeros(bs, np.float32)
                    qcd_b[:e - s] = qcd[qarr[s:e]]
                    packed_kw = dict(packed_rows=self._packed,
                                     dq_scale=float(dqs),
                                     q_center_dot=t(qcd_b))
                d, i = graph_beam_search_iterative(
                    t(qb), arena.vectors, arena.norms, arena.role_bits, g3,
                    t(mb.view(np.int32)), t(eb), kk, ef_eff, ms_bound, harv,
                    row_map=rm2, metric=self.metric, pids=t(pb),
                    step_budget=t(bb), **packed_kw)
                with record_function("graph.drain"):
                    d = d.cpu().numpy()[:e - s].astype(np.float64)
                    i = i.cpu().numpy()[:e - s].astype(np.int64)
                    arena_i = np.where(
                        i >= 0, rm_host[parr[s:e, None], np.maximum(i, 0)]
                        .astype(np.int64), -1)
                    dd[s:e], ii[s:e] = merge_topk_host([d], [arena_i], k)
            for j, start, ln in spans:
                out[j] = (dd[start:start + ln], ii[start:start + ln])
        return out  # type: ignore[return-value]
