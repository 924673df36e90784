"""Int8 flat index: the quantized fused-scan serving path.

Counterpart of vectorsearch_rbac_tpu/index/flat_int8.py `Int8FlatIndex`
for the global (unpartitioned) index: int8 distances and the bitset
permission check in one CUDA scan (ops/scan_int8.py; the wide kernel for
rows wider than 256), the group-minima merge kernels (ops/merge.py), the
float32 rerank tier where the int8 scores are not exact (ops/rerank.py),
and the result wire packed on the device.

Each pass quantizes its queries on the host with the reference's
quantizers and uploads them, with the per-query scales, biases and rerank
codes, once; each batch is then scanned, merged, reranked and wire-packed
on the device; finalize() copies the wire rows back and unpacks them. The
rules that decide the result are the reference's: the group width from
the padded row count, the rerank iff the corpus quantizes lossily or the
metric is not l2 (ip/cosine queries quantize with their own scales), the
k + 32 candidates a rerank starts from, the rerank mode's default, and the
wire's id width from the arena's padded row count. Profiler spans mark the
host's share of a pass (flat_int8.quantize_upload, .enqueue,
.fetch_unpack) and, inside the enqueue, each batch's stages (.scan,
.merge, .rerank, .wire); bench/profile.py reads them.

Not ported (ROADMAP.md): row subsets and the logical no-copy mode, the
admit-dedup slot grouping, the resident user table behind the 2-byte uid
wire, and the bf16/u8 wires. The reference's tile clamps for the wide
kernel (block_rows, q_tile, d_chunk) are VMEM rules of the TPU and have no
counterpart.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core import DeviceArena
from ..ops.rerank import RERANK_MODES, rebuild_query, rerank_topk
from ..ops.scan_int8 import (NARROW_MAX_D, int8_group_minima,
                             merge_group_minima, pack_results_device,
                             unpack_results_host)

MAX_GROUP = 128      # rows per packed minimum: the 7-bit lane field
RERANK_MARGIN = 32   # extra scan candidates the rerank starts from


class Int8FlatIndex:
    def __init__(
        self,
        arena: DeviceArena,
        query_batch: int = 8192,
        wire: str = "f32",              # "ids" | "f32"
        rerank_mode: Optional[str] = None,  # one of ops.rerank.RERANK_MODES;
                                        # None: "residual4" (ip/cosine) or
                                        # "dequant" (l2) on wide rows,
                                        # "f16" on narrow ones
    ):
        q = arena.quant
        if q is None:
            raise ValueError("Int8FlatIndex needs an int8-quantized arena")
        if wire not in ("ids", "f32"):
            raise NotImplementedError(
                f"wire {wire!r}: the bf16 and u8 wires are ROADMAP items")
        self.metric = arena.metric
        d_pad = q.d_pad
        self.wide = d_pad > NARROW_MAX_D
        self.score_shift = q.score_shift
        if (3 * d_pad * q.qclip**2) >> self.score_shift >= 2**23:
            raise ValueError(f"score shift {self.score_shift} leaves the "
                             f"packed epilogue out of range at d_pad {d_pad}")
        self.rerank = not q.lossless or self.metric != "l2"
        if rerank_mode is None:
            if self.wide:
                rerank_mode = "residual4" if self.metric != "l2" else "dequant"
            else:
                rerank_mode = "f16"
        if rerank_mode not in RERANK_MODES:
            raise ValueError(f"rerank mode {rerank_mode!r} is not one of "
                             f"{RERANK_MODES}")
        if rerank_mode in ("residual", "residual4") and self.metric == "l2":
            raise ValueError("the residual rerank needs per-query scales "
                             "(ip/cosine only)")
        self.rerank_mode = rerank_mode
        self._kernel_metric = "l2" if self.metric == "l2" else "ip"
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
        # the rerank's corpus constant: l2 rebuilds q8 / scale + center,
        # ip/cosine q8 * inv * scale (float32 values, as the reference's)
        if self.metric == "l2":
            self._q_dequant = float(np.float32(1.0 / q.scale))
            center = np.zeros(d_pad, np.float32)
            center[:len(q.center)] = q.center
            self._center = torch.from_numpy(center).to(arena.device)
        else:
            self._q_dequant = float(np.float32(q.scale))
            self._center = None

    def _quantize_upload(self, qf: np.ndarray) -> Dict[str, torch.Tensor]:
        """The pass's per-query operands on the device, each uploaded once
        (a pageable copy inside the batch loop would wait for the queued
        kernels): int8 codes, and for ip/cosine the per-query scales and
        biases, plus the rerank mode's codes or shipped queries."""
        quant = self._quant
        cosine = self.metric == "cosine"
        host = {}
        if self.metric == "l2":
            host["q8"], _ = quant.quantize_queries(qf, with_norms=False)
        else:
            host["q8"], host["inv"], host["bias"] = quant.quantize_queries_ip(
                qf, cosine=cosine)
        mode = self.rerank_mode if self.rerank else None
        if mode == "residual":
            host["res"] = quant.query_residual8(qf, host["q8"], host["inv"],
                                                cosine=cosine)
        elif mode == "residual4":
            host["res"] = quant.query_residual4(qf, host["q8"], host["inv"],
                                                cosine=cosine)
        elif mode in ("f16", "f32"):
            host["qf"] = np.ascontiguousarray(
                qf, dtype=np.float16 if mode == "f16" else np.float32)
        dev = self._arena.device
        return {name: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for name, a in host.items()}

    def search_deferred(self, queries: np.ndarray, query_masks: np.ndarray,
                        k: int):
        """Enqueue every batch's scan, merge, rerank and wire pack without
        syncing; returns finalize() -> (dists (Q, k) float32, ids (Q, k)
        int64). With the ids wire the dists are rank pseudo-distances
        0..k-1."""
        quant = self._quant
        arena = self._arena
        qf = np.asarray(queries, dtype=np.float32)
        nq = qf.shape[0]
        if nq == 0:
            return lambda: (np.empty((0, k), np.float32),
                            np.empty((0, k), np.int64))
        with record_function("flat_int8.quantize_upload"):
            ops = self._quantize_upload(qf)
            masks = np.ascontiguousarray(query_masks, dtype=np.uint32)
            m_d = torch.from_numpy(masks.view(np.int32)).to(arena.device)
        kk = k + RERANK_MARGIN if self.rerank else k
        inv_l2 = 1.0 / quant.scale**2
        wires = []
        with record_function("flat_int8.enqueue"):
            for s in range(0, nq, self.query_batch):
                b = {name: t[s:s + self.query_batch]
                     for name, t in ops.items()}
                with record_function("flat_int8.scan"):
                    packed = int8_group_minima(
                        b["q8"], quant.vectors_q, quant.norms_q,
                        arena.role_bits, m_d[s:s + self.query_batch],
                        self.group, self._kernel_metric, self.score_shift)
                with record_function("flat_int8.merge"):
                    qn = (None if "inv" in b else
                          (b["q8"].to(torch.int32) ** 2).sum(
                              dim=1, dtype=torch.int32))
                    dd, ii = merge_group_minima(
                        packed, qn, b.get("inv", inv_l2), kk, self.group,
                        "kernel", self._kernel_metric, self.score_shift,
                        b.get("bias"))
                if self.rerank:
                    with record_function("flat_int8.rerank"):
                        qr = rebuild_query(
                            self.rerank_mode, self.metric, arena.dim,
                            b["q8"], inv=b.get("inv"),
                            q_dequant=self._q_dequant, center=self._center,
                            residual=b.get("res"), shipped=b.get("qf"))
                        dd, ii = rerank_topk(qr, ii, arena.vectors,
                                             arena.norms, k, self.metric)
                with record_function("flat_int8.wire"):
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
