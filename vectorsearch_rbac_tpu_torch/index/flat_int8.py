"""Int8 flat index: the quantized fused-scan serving path.

Counterpart of vectorsearch_rbac_tpu/index/flat_int8.py `Int8FlatIndex`
for the global (unpartitioned) index on a lossless L2 arena: int8
distances and the bitset permission check in one CUDA scan
(ops/scan_int8.py), the group-minima merge kernels (ops/merge.py), and the
result wire packed on the device.

Each query batch is quantized on the host with the reference's quantizer,
uploaded, scanned, merged and wire-packed on the device; finalize() copies
the wire rows back and unpacks them. The sizing rules that decide the
result are the reference's: the group width from the padded row count and
the wire's id width from the arena's padded row count. Three profiler
spans mark the host's share of a pass (flat_int8.quantize_upload,
.enqueue, .fetch_unpack; bench/profile.py reads them).

Not ported (ROADMAP.md): row subsets and the logical no-copy mode, the
rerank tiers (lossy corpora, ip/cosine), the wide d-split kernel, the
admit-dedup slot grouping, the resident user table behind the 2-byte uid
wire, and the bf16/u8 wires.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core import DeviceArena
from ..ops.scan_int8 import (int8_masked_topk, pack_results_device,
                             unpack_results_host)

MAX_GROUP = 128   # rows per packed minimum: the 7-bit lane field


class Int8FlatIndex:
    def __init__(
        self,
        arena: DeviceArena,
        query_batch: int = 8192,
        wire: str = "f32",              # "ids" | "f32"
    ):
        q = arena.quant
        if q is None:
            raise ValueError("Int8FlatIndex needs an int8-quantized arena")
        if not q.lossless:
            # the reference reranks these against the f32 mirror
            raise NotImplementedError(
                "the f32 rerank tiers (lossy corpora) are ROADMAP slice 2")
        d_pad = q.d_pad
        if d_pad > 256:
            raise NotImplementedError(
                f"d_pad {d_pad}: the wide d-split kernel is ROADMAP queue 2 "
                "item 2")
        if wire not in ("ids", "f32"):
            raise NotImplementedError(
                f"wire {wire!r}: the bf16 and u8 wires are ROADMAP items")
        self.score_shift = q.score_shift
        assert (3 * d_pad * q.qclip**2) >> self.score_shift < 2**23, (
            q.qclip, d_pad, self.score_shift)
        self._arena = arena
        self._quant = q
        self.query_batch = query_batch
        self.wire = wire
        self.n_rows = arena.n
        # group-min width scales with the row count (reference rule): keep
        # >= 8192 groups where the padded row count allows, since top-k
        # loses ~C(k,2)*group/npad results to same-group collisions
        fit = q.vectors_q.shape[0] // 8192
        self.group = (min(MAX_GROUP, 1 << (fit.bit_length() - 1)) if fit >= 8
                      else 8)
        # results carry arena row ids: size the wire to the padded arena
        self._id_bits = max((arena.n_padded - 1).bit_length(), 1)

    def search_deferred(self, queries: np.ndarray, query_masks: np.ndarray,
                        k: int):
        """Enqueue every batch's scan, merge and wire pack without syncing;
        returns finalize() -> (dists (Q, k) float32, ids (Q, k) int64).
        With the ids wire the dists are rank pseudo-distances 0..k-1."""
        quant = self._quant
        dev = self._arena.device
        qf = np.asarray(queries, dtype=np.float32)
        nq = qf.shape[0]
        if nq == 0:
            return lambda: (np.empty((0, k), np.float32),
                            np.empty((0, k), np.int64))
        with record_function("flat_int8.quantize_upload"):
            q8, _ = quant.quantize_queries(qf, with_norms=False)
            masks = np.ascontiguousarray(query_masks, dtype=np.uint32)
            q8_d = torch.from_numpy(q8).to(dev)
            m_d = torch.from_numpy(masks.view(np.int32)).to(dev)
        inv = 1.0 / quant.scale**2
        wires = []
        with record_function("flat_int8.enqueue"):
            for s in range(0, nq, self.query_batch):
                qb = q8_d[s:s + self.query_batch]
                qnb = (qb.to(torch.int32) ** 2).sum(dim=1, dtype=torch.int32)
                dd, ii = int8_masked_topk(
                    qb, qnb, quant.vectors_q, quant.norms_q,
                    self._arena.role_bits, m_d[s:s + self.query_batch], inv,
                    k, group=self.group, score_shift=self.score_shift)
                wires.append(pack_results_device(
                    dd, ii, id_bits=self._id_bits, dist=self.wire))

        def finalize():
            with record_function("flat_int8.fetch_unpack"):
                w = torch.cat(wires).cpu().numpy()
                d, i = unpack_results_host(w, k, id_bits=self._id_bits,
                                           dist=self.wire)
            return d.astype(np.float32), i.astype(np.int64)

        return finalize

    def search(self, queries, query_masks, k) -> Tuple[np.ndarray, np.ndarray]:
        return self.search_deferred(queries, query_masks, k)()

    def storage_bytes(self) -> Dict[str, int]:
        return {"vectors": 0, "index": 0}  # the shared arena, counted there
