"""RBAC-masked scan over bit-packed rows (pgvector's `bit` type): hamming
and jaccard distances with top-k.

Counterpart of vectorsearch_rbac_tpu/ops/binary_scan.py: `pack_bits` (a
copy of the reference's numpy code) and `masked_binary_topk`, plain
PyTorch as the reference leaves its scan to XLA. Sign bits are packed 32
a word, little-endian within the word, pad dimensions zero;

- hamming(a, b) = sum over words of popcount(a XOR b);
- jaccard(a, b) = 1 - |a AND b| / |a OR b|, and 1 where the AND is empty
  (pgvector's BitJaccardDistance, both-empty included).

torch 2.13 has no population count (no `torch.bitwise_count`), so
`popcount32` counts the int32 view's bits with shifts, masks and adds: the low 31 bits by the SWAR
steps, each right shift masked (a negative int32 shifts in ones), no step
able to overflow, and the sign bit apart. The words are counted one at a
time, so one (Q, block) int32 plane a count is live, as in the reference.
The reference's `mode`/`recall_target` (an approximate per-block top-k)
is not carried: every block takes its exact top-k.

Bit distances tie often (hamming is an integer of at most d). Each
block's and the final top-k rank by the key (distance, row id), which is
the order `lax.top_k` gives ties (lower index first), so the candidates
are the reference's, ties included: every distance is >= 0 and finite or
+inf, so its float32 bits order as integers, and the key is those bits
shifted above the row id in an int64.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .scan import admissible


def pack_bits(vectors: np.ndarray, thresholds: Optional[np.ndarray] = None,
              words: Optional[int] = None) -> np.ndarray:
    """Pack the sign bits of (n, d) float rows into (n, ceil(d/32)) uint32:
    bit j of row i is set iff vectors[i, j] > thresholds[j] (default 0:
    pgvector's binary_quantize); dim j goes to word j // 32, bit j % 32,
    and pad dims beyond d are 0 in every row."""
    v = np.asarray(vectors)
    n, d = v.shape
    thr = (np.zeros(d, v.dtype) if thresholds is None
           else np.asarray(thresholds))
    w = (d + 31) // 32 if words is None else words
    if w * 32 < d:
        raise ValueError(f"{w} words cannot hold {d} dims")
    bits = np.zeros((n, w * 32), dtype=np.uint8)
    bits[:, :d] = (v > thr[None, :]).astype(np.uint8)
    lanes = bits.reshape(n, w, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (lanes << shifts[None, None, :]).sum(axis=2, dtype=np.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """The number of set bits of each int32 (the uint32 word's bits)."""
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = (v + (v >> 16)) & 0x3F
    return v + (x < 0).to(torch.int32)


def _key(scores: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered as (score, row) for scores >= 0 or +inf."""
    return (scores.view(torch.int32).to(torch.int64) << 32) | rows


def masked_binary_topk(
    query_bits: torch.Tensor,   # (Q, Wd) int32 view of the packed query bits
    bits: torch.Tensor,         # (Npad, Wd) int32 packed corpus bits
    role_bits: torch.Tensor,    # (Npad, W) int32; all-zero rows never return
    query_masks: torch.Tensor,  # (Q, W) int32 user role masks
    k: int,
    block_rows: int = 65536,
    metric: str = "hamming",    # "hamming" (<~>) | "jaccard" (<%>)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (dists (Q, k) ascending, idx (Q, k) int32 into the padded
    rows), ties by row id. Hamming distances are integer-valued floats,
    jaccard in [0, 1]. Empty slots: dist=+inf, idx=-1."""
    if metric not in ("hamming", "jaccard"):
        raise ValueError(f"unknown bit metric {metric!r}")
    npad, wd = bits.shape
    if npad % block_rows:
        raise ValueError(f"npad {npad} is not a multiple of {block_rows}")
    dev = bits.device
    cand = []
    for off in range(0, npad, block_rows):
        bb = bits[off:off + block_rows]
        if metric == "hamming":
            acc = popcount32(query_bits[:, 0, None] ^ bb[None, :, 0])
            for w in range(1, wd):
                acc += popcount32(query_bits[:, w, None] ^ bb[None, :, w])
            scores = acc.to(torch.float32)
        else:
            inter = torch.zeros((query_bits.shape[0], bb.shape[0]),
                                dtype=torch.int32, device=dev)
            union = torch.zeros_like(inter)
            for w in range(wd):
                qw, xw = query_bits[:, w, None], bb[None, :, w]
                inter += popcount32(qw & xw)
                union += popcount32(qw | xw)
            scores = torch.where(
                inter > 0,
                1.0 - inter.to(torch.float32)
                / union.clamp_min(1).to(torch.float32), 1.0)
        allowed = admissible(query_masks, role_bits[off:off + block_rows])
        scores = scores.masked_fill(~allowed, torch.inf)
        rows = torch.arange(off, off + bb.shape[0], device=dev)
        cand.append(torch.topk(_key(scores, rows[None, :]),
                               min(k, block_rows), dim=1,
                               largest=False).values)
    keys = torch.topk(torch.cat(cand, dim=1), k, dim=1, largest=False).values
    vals = (keys >> 32).to(torch.int32).view(torch.float32)
    idx = (keys & 0xFFFFFFFF).to(torch.int32)
    empty = torch.isinf(vals)
    return vals, torch.where(empty, -1, idx)
