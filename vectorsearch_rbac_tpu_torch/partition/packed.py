"""Packed multi-partition execution: every partition of a size class
answers in one pass of the probed scan.

Counterpart of vectorsearch_rbac_tpu/partition/packed.py (`_bucket_len`,
`PackedBucket`, `PackedSearcher`): the partitions of one power-of-two
size bucket stack into (P, L_pad, ...) arrays, the IVF inverted-file
shape, and a query scores the rows of its partition's slot with the
probed scan's function (ops/ivf_scan.py) in the arena's metric. It serves
ROLE, USER, AnonySys and QDTree on every arena the TiledSearcher does not
take: ip and cosine arenas, and float32 and bfloat16 ones, l1 included.

Two things differ from the reference in how, not in what:

- a bucket's vectors, norms, bitsets and row ids are gathered on the
  device from the arena's tensors (the reference stages them in host
  numpy: ~10 GB for a 768-d ROLE bucket in bfloat16);
- the scan does not gather a (queries, L_pad, d) block of rows a query
  (100 MB a query for a 768-d ROLE bucket of 65,536 rows): a bucket's
  (query, slot) pairs are grouped by slot and each slot's rows score all
  of its queries in one product (`probed_topk` with one probe a query,
  the slot). Same products, same mask
  test, same outputs; only the order of summation differs.

The reference's PackedSearcher scores every arena in squared L2 (its
`_packed_search_fn` calls the probed scan without the metric), which on
an ip or l1 arena ranks by the wrong distance; here the arena's metric is
passed (ROADMAP queue 3, "Intentional divergences").

Routing is the other searchers': `batch_router`, then `vector_router`,
then the user router (base.route_batch). A pass is split by profiler
spans: packed.route (host), packed.scan (the buckets' scans, enqueue and
fetch) and packed.merge (the host's fan-out merge).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..config import get_logger
from ..core import DeviceArena
from ..index.ivf import gather_lists
from ..ops.ivf_scan import probed_topk
from ..ops.topk import merge_topk_host
from ..rbac import query_masks_for
from .base import route_batch

logger = get_logger("partition.packed")


def _bucket_len(n: int) -> int:
    """Pad partition row counts to power-of-two buckets (min 1024)."""
    return max(1024, 1 << (max(n, 1) - 1).bit_length())


class PackedBucket:
    """Partitions of one size bucket stacked into (P, L_pad, ...) tensors,
    gathered on the device from the arena along a (P, L_pad) row map."""

    def __init__(self, arena: DeviceArena, parts: Dict[int, np.ndarray],
                 l_pad: int):
        self.slot_of_pid: Dict[int, int] = {}
        rmap = np.full((len(parts), l_pad), -1, dtype=np.int32)
        for slot, (pid, rows) in enumerate(sorted(parts.items())):
            self.slot_of_pid[pid] = slot
            rmap[slot, :len(rows)] = rows
        self._rows = torch.from_numpy(rmap).to(arena.device)
        self._vec, self._norm, self._bits = gather_lists(
            arena.vectors, arena.norms, arena.role_bits, self._rows)
        self.l_pad = l_pad
        self.p = len(parts)
        self.metric = arena.metric

    def search(self, queries: torch.Tensor, masks: torch.Tensor,
               slots: np.ndarray, k: int):
        """(dists (Q, k), row ids (Q, k)) on the device: query j against
        the rows of slot slots[j]."""
        return probed_topk(queries, slots[:, None], self._vec, self._norm,
                           self._bits, self._rows, masks, k,
                           metric=self.metric)

    def storage_bytes(self) -> Dict[str, int]:
        slots = self.p * self.l_pad
        return {"vectors": int(slots * self._vec.shape[2]
                               * self._vec.element_size()),
                "index": int(slots * (4 + 4 * self._bits.shape[2] + 4))}


class PackedSearcher:
    """Strategy searcher over packed buckets: a pass scores each bucket's
    (query, partition) pairs in one call of the probed scan. mode is
    "exact" (index kind flat) or "approx" (flat_approx); both take the
    exact top-k here."""

    def __init__(self, arena: DeviceArena,
                 partition_rows: Dict[int, np.ndarray],
                 router: Callable[[int], Sequence[int]], name: str,
                 mode: str = "approx"):
        self.arena = arena
        self.router = router
        self.name = name
        self.mode = mode
        self.batch_router: Optional[Callable] = None
        self.vector_router: Optional[Callable] = None
        by_bucket: Dict[int, Dict[int, np.ndarray]] = {}
        for pid, rows in partition_rows.items():
            if len(rows):
                by_bucket.setdefault(_bucket_len(len(rows)), {})[pid] = \
                    np.asarray(rows)
        self.buckets: List[PackedBucket] = []
        self.bucket_of_pid: Dict[int, Tuple[int, int]] = {}
        for l_pad, parts in sorted(by_bucket.items()):
            b = PackedBucket(arena, parts, l_pad)
            for pid, slot in b.slot_of_pid.items():
                self.bucket_of_pid[pid] = (len(self.buckets), slot)
            self.buckets.append(b)
        self.partitions = {pid: None for pid in self.bucket_of_pid}
        logger.info("packed searcher '%s': %d partitions in %d buckets %s",
                    name, len(self.bucket_of_pid), len(self.buckets),
                    self.bucket_shapes)

    @property
    def bucket_shapes(self) -> List[Tuple[int, int]]:
        """(P, L_pad) of each bucket."""
        return [(b.p, b.l_pad) for b in self.buckets]

    def search_batch(self, queries: np.ndarray, user_ids: np.ndarray,
                     user_masks: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (dists (Q, k), arena row ids (Q, k)); -1 / +inf pads."""
        queries = np.asarray(queries, dtype=np.float32)
        user_ids = np.asarray(user_ids)
        nq = queries.shape[0]
        qmasks = query_masks_for(user_masks, user_ids)

        with record_function("packed.route"):
            per_bucket: Dict[int, Tuple[List[int], List[int]]] = {}
            n_pids = np.zeros(nq, dtype=np.int32)
            for qi, pids in enumerate(route_batch(self, queries, user_ids)):
                for pid in pids:
                    hit = self.bucket_of_pid.get(pid)
                    if hit is None:
                        continue
                    n_pids[qi] += 1
                    qs, ss = per_bucket.setdefault(hit[0], ([], []))
                    qs.append(qi)
                    ss.append(hit[1])

        results = []
        with record_function("packed.scan"):
            if per_bucket:
                dev = self.arena.device
                q_d = torch.from_numpy(queries).to(dev)
                m_d = torch.from_numpy(np.ascontiguousarray(
                    qmasks, np.uint32).view(np.int32)).to(dev)
                pending = []
                for bi, (qs, ss) in sorted(per_bucket.items()):
                    qidx = np.asarray(qs, dtype=np.int64)
                    sel = torch.from_numpy(qidx).to(dev)
                    pending.append((qidx, *self.buckets[bi].search(
                        q_d.index_select(0, sel), m_d.index_select(0, sel),
                        np.asarray(ss, dtype=np.int64), k)))
                results = [(qidx, d.cpu().numpy(),
                            i.cpu().numpy().astype(np.int64))
                           for qidx, d, i in pending]

        with record_function("packed.merge"):
            return _fan_in(results, n_pids, nq, k)

    def storage_report(self) -> Dict[str, float]:
        """MB of the shared arena and the buckets' own tensors."""
        mb = 1024 * 1024
        a = self.arena
        arena_vec = a.n_padded * a.dim * a.vectors.element_size()
        arena_aux = a.n_padded * (4 + 4 * a.role_bits.shape[1])
        pv = sum(b.storage_bytes()["vectors"] for b in self.buckets)
        pi = sum(b.storage_bytes()["index"] for b in self.buckets)
        return {
            "arena_vectors_mb": arena_vec / mb,
            "arena_aux_mb": arena_aux / mb,
            "partition_vectors_mb": pv / mb,
            "partition_index_mb": pi / mb,
            "total_mb": (arena_vec + arena_aux + pv + pi) / mb,
            "num_partitions": len(self.bucket_of_pid),
        }


def _fan_in(results, n_pids: np.ndarray, nq: int, k: int):
    """Each query's result: a one-partition query copies its row; the
    queries of several partitions gather their candidates into one
    (n_multi, fan_max * k) block, merged with row-id dedupe in one call
    (merge_topk_host is row-wise, so this equals a merge a query)."""
    out_d = np.full((nq, k), np.inf)
    out_i = np.full((nq, k), -1, dtype=np.int64)
    if not results:
        return out_d, out_i
    q = np.concatenate([r[0] for r in results])
    d = np.concatenate([r[1] for r in results])
    i = np.concatenate([r[2] for r in results])
    single = n_pids[q] == 1
    out_d[q[single]] = d[single]
    out_i[q[single]] = i[single]
    multi_q = np.flatnonzero(n_pids > 1)
    if len(multi_q):
        qm, dm, im = q[~single], d[~single], i[~single]
        order = np.argsort(qm, kind="stable")
        qs = qm[order]
        rank = np.arange(len(qs)) - np.searchsorted(qs, qs)
        slot_of = np.zeros(nq, dtype=np.int64)
        slot_of[multi_q] = np.arange(len(multi_q))
        f, fan_max = len(multi_q), int(n_pids.max())
        md = np.full((f, fan_max, k), np.inf)
        mi = np.full((f, fan_max, k), -1, dtype=np.int64)
        md[slot_of[qs], rank] = dm[order]
        mi[slot_of[qs], rank] = im[order]
        out_d[multi_q], out_i[multi_q] = merge_topk_host(
            [md.reshape(f, fan_max * k)], [mi.reshape(f, fan_max * k)], k)
    return out_d, out_i
