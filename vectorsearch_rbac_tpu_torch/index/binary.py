"""Binary-quantized index: a bit-packed scan and an exact rerank from the
shared arena (pgvector's bit(d) index and its binary_quantize recipe).

Counterpart of vectorsearch_rbac_tpu/index/binary.py `BinaryQuantIndex`
and `_rerank_fn`. The packed sign bits (per-dimension medians of the
index's rows as the pivot: SIFT-like values are all positive, so
binary_quantize's zero pivot would set every bit) are the index's only
payload; the rerank gathers full-precision rows from the arena by row
id, so the index copies no vectors. With rerank (the default) the scan
keeps rerank_mult * k bit-distance candidates (ops/binary_scan.py) and
the arena's metric ranks them: l2 as sum x^2 - 2 q.x + sum q^2 over the
gathered rows (not the arena's norms), in float32 with TF32 off; without
it the index returns the hamming or jaccard distances themselves. Arena
ids come through the row map. The rerank is cut by queries so that its
(queries, candidates, d) gather stays under _RERANK_BYTES (the
reference's is 1.2 GB at d 768, 1,024 queries, 400 candidates). The
reference's zero pivot (`thresholds="zero"`), `mode` and `recall_target`
are not carried: no caller sets them, and the bit scan is exact.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import DeviceArena
from ..ops.binary_scan import masked_binary_topk, pack_bits
from ..ops.scan import exact_f32_matmul
from .flat import _pad_to_bucket

_RERANK_BYTES = 1 << 28


def _rerank(q: torch.Tensor, rows: torch.Tensor, vectors: torch.Tensor,
            k: int, metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Q, d) float32 queries against their (Q, C) candidate arena rows (-1
    for none) -> (dists (Q, k) in the arena's metric, arena row ids (Q,
    k)); ties keep the candidates' order, as lax.top_k does."""
    if metric == "cosine":
        q = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-30)
    x = vectors.index_select(0, rows.clamp_min(0).reshape(-1)).to(
        torch.float32).view(*rows.shape, -1)                    # (Q, C, d)
    if metric == "l1":
        d = (x - q[:, None, :]).abs().sum(dim=2)
    else:
        with exact_f32_matmul():
            dots = torch.bmm(x, q[:, :, None])[:, :, 0]
        if metric == "l2":
            d = torch.clamp_min((x * x).sum(dim=2) - 2.0 * dots
                                + (q * q).sum(dim=1, keepdim=True), 0.0)
        elif metric == "cosine":
            d = torch.clamp(1.0 - dots, 0.0, 2.0)
        else:
            d = -dots
    d = torch.where(rows < 0, torch.inf, d)
    vals, pos = torch.sort(d, dim=1, stable=True)
    vals, ids = vals[:, :k], torch.gather(rows, 1, pos[:, :k])
    return vals, torch.where(torch.isinf(vals), -1, ids)


class BinaryQuantIndex:
    def __init__(self, arena: DeviceArena,
                 rows: Optional[np.ndarray] = None,
                 block_rows: int = 65536, query_batch: int = 1024,
                 rerank: bool = True, rerank_mult: int = 4,
                 bit_metric: str = "hamming"):
        """rows: arena row ids (None: the whole arena)."""
        if bit_metric not in ("hamming", "jaccard"):
            raise ValueError(f"unknown bit metric {bit_metric!r}")
        self.block_rows = block_rows
        self.query_batch = query_batch
        self.rerank = rerank
        self.rerank_mult = rerank_mult
        self.bit_metric = bit_metric
        self.metric = arena.metric
        self._arena = arena
        sel = (np.arange(arena.n, dtype=np.int64) if rows is None
               else np.asarray(rows, dtype=np.int64))
        self.n_rows = len(sel)
        npad = _pad_to_bucket(max(self.n_rows, 1), block_rows)
        v = arena.host_vectors[sel]
        self._thr = (np.median(v, axis=0).astype(np.float32) if self.n_rows
                     else np.zeros(arena.dim, dtype=np.float32))
        packed = pack_bits(v, self._thr)
        self._wd = packed.shape[1]
        bits = np.zeros((npad, self._wd), dtype=np.uint32)
        bits[:self.n_rows] = packed
        rmap = np.full(npad, -1, dtype=np.int64)
        rmap[:self.n_rows] = sel
        dev = arena.device
        self._bits = torch.from_numpy(bits.view(np.int32)).to(dev)
        self._row_map = torch.from_numpy(rmap).to(dev)
        self._rbits = arena.role_bits.index_select(
            0, self._row_map.clamp_min(0))
        self._rbits[self.n_rows:] = 0

    def search_deferred(self, queries: np.ndarray, query_masks: np.ndarray,
                        k: int):
        """Enqueue the scans (and reranks) without syncing; returns
        finalize() -> (dists (Q, k) float32, arena row ids (Q, k) int64)."""
        q = np.asarray(queries, dtype=np.float32)
        if self.metric == "cosine":
            # the thresholds were taken on unit rows: a raw query's scale
            # would set nearly every bit
            q = q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True),
                               1e-30)
        dev = self._bits.device
        cand_k = (min(max(self.rerank_mult * k, k), self._bits.shape[0])
                  if self.rerank else k)
        qbits = torch.from_numpy(
            pack_bits(q, self._thr, words=self._wd).view(np.int32)).to(dev)
        q_d = torch.from_numpy(q).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(
            query_masks, np.uint32).view(np.int32)).to(dev)
        chunk = max(1, _RERANK_BYTES // (cand_k * q.shape[1] * 4))
        pending = []
        for s in range(0, q.shape[0], self.query_batch):
            e = min(s + self.query_batch, q.shape[0])
            d, i = masked_binary_topk(qbits[s:e], self._bits, self._rbits,
                                      m[s:e], cand_k, self.block_rows,
                                      metric=self.bit_metric)
            rows = torch.where(i < 0, -1,
                               self._row_map[i.clamp_min(0).long()])
            if not self.rerank:
                pending.append((d[:, :k], rows[:, :k]))
                continue
            for c in range(s, e, chunk):
                pending.append(_rerank(
                    q_d[c:min(c + chunk, e)], rows[c - s:c - s + chunk],
                    self._arena.vectors, k, self.metric))

        def finalize():
            if not pending:
                return (np.empty((0, k), np.float32),
                        np.empty((0, k), np.int64))
            d = torch.cat([p[0] for p in pending]).cpu().numpy()
            i = torch.cat([p[1] for p in pending]).cpu().numpy()
            return d, i.astype(np.int64)

        return finalize

    def search(self, queries: np.ndarray, query_masks: np.ndarray,
               k: int) -> Tuple[np.ndarray, np.ndarray]:
        return self.search_deferred(queries, query_masks, k)()

    def storage_bytes(self) -> Dict[str, int]:
        """The packed bits, bitsets and row map (the reference's count);
        the vectors stay in the shared arena."""
        npad = self._bits.shape[0]
        return {"vectors": 0, "index": int(
            npad * (self._wd * 4 + self._rbits.shape[1] * 4 + 4))}
