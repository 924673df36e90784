"""RBAC-masked distance scans with top-k: the flat index's engine and the
ground-truth oracle.

Counterpart of vectorsearch_rbac_tpu/ops/scan.py: `masked_scan_topk` for
squared L2, negative inner product, cosine distance and l1, and
`masked_scan_topk_aug`, the augmented layout's scan, where the squared
norm rides inside the product (core.augment_with_norms). Plain PyTorch:
the reference leaves these scans to XLA, not to a Pallas kernel. Rows are
scanned in blocks; each block keeps its k best admissible rows and one
exact merge over all blocks' candidates follows, as in the reference.

Scores are computed as the reference computes them: the query is rounded
to the rows' dtype (bfloat16 on a bfloat16 arena or an int8 arena's
mirror) and every product is summed in float32, with TF32 off on float32
rows. On bfloat16 rows the product may run on TF32 tensor cores, whose
10-bit operands hold a bfloat16 value exactly, so every product is exact
and only the order of summation differs. On integer-valued corpora (SIFT
family, |q.x| < 2^24) every float32 score is exact. l1 has no product
form: it is the sum of |x - q| over float32 rows and the float32 query
(not rounded, as in the reference), by `torch.cdist(p=1)`, which keeps no
(Q, block, d) intermediate (the reference's broadcast is 8 GB at Q 1024,
block 16384, d 128).

Every block takes its exact top-k. The reference's approx mode (with its
`recall_target`) uses `lax.approx_min_k`, a recall-targeted approximation
of it; the port has no approx scan, so FlatIndex's approx mode returns
the exact results (ROADMAP queue 3, "Intentional divergences").
"""

from __future__ import annotations

import contextlib
from typing import Callable, Tuple

import torch

from ..core import augment_queries


@contextlib.contextmanager
def exact_f32_matmul():
    """Float32 matmuls in full float32 (TF32 off) inside the block; the
    previous setting is restored on exit."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


@contextlib.contextmanager
def products(dtype: torch.dtype):
    """Float32 products of operands upcast from `dtype`: TF32 allowed for
    bfloat16 operands (exact in TF32), full float32 otherwise."""
    if dtype != torch.bfloat16:
        with exact_f32_matmul():
            yield
        return
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def admissible(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(A, W) x (B, W) int32 bitsets -> (A, B) bool: any shared role bit."""
    allowed = torch.zeros((a_bits.shape[0], b_bits.shape[0]),
                          dtype=torch.bool, device=a_bits.device)
    for w in range(a_bits.shape[1]):
        allowed |= (a_bits[:, w, None] & b_bits[None, :, w]) != 0
    return allowed


def _unit(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(
        torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-30)


def blocked_topk(score_block: Callable[[int], torch.Tensor],
                 role_bits: torch.Tensor, query_bits: torch.Tensor, k: int,
                 npad: int, block_rows: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each block's k smallest admissible scores (score_block(off) gives
    the (Q, block_rows) scores of the block at row off), then one exact
    merge: (vals (Q, k), row ids (Q, k) int32); inadmissible rows +inf."""
    if npad % block_rows:
        raise ValueError(f"npad {npad} is not a multiple of {block_rows}")
    cand_vals, cand_idx = [], []
    for off in range(0, npad, block_rows):
        scores = score_block(off)
        allowed = admissible(query_bits, role_bits[off:off + block_rows])
        scores = scores.masked_fill(~allowed, torch.inf)
        bvals, bpos = torch.topk(scores, min(k, block_rows), dim=1,
                                 largest=False)
        cand_vals.append(bvals)
        cand_idx.append(bpos.to(torch.int32) + off)
    vals, pos = torch.topk(torch.cat(cand_vals, dim=1), k, dim=1,
                           largest=False)
    return vals, torch.gather(torch.cat(cand_idx, dim=1), 1, pos)


def scores_to_distances(vals: torch.Tensor, idx: torch.Tensor,
                        qn: torch.Tensor, metric: str
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scores -> the metric's distances: squared L2 (clamped at 0), -q.x,
    cosine distance in [0, 2], or l1 (the score itself); empty slots
    +inf / -1."""
    empty = torch.isinf(vals)
    if metric == "l2":
        dists = torch.clamp_min(vals + qn, 0.0)
    elif metric == "cosine":
        dists = torch.clamp(1.0 + vals, 0.0, 2.0)
    else:
        dists = vals
    dists = torch.where(empty, torch.inf, dists)
    return dists, torch.where(empty, -1, idx)


def masked_scan_topk(
    queries: torch.Tensor,      # (Q, d) float32
    vectors: torch.Tensor,      # (Npad, d), Npad % block_rows == 0
    norms: torch.Tensor,        # (Npad,) float32 squared norms
    role_bits: torch.Tensor,    # (Npad, W) int32; all-zero rows never return
    query_bits: torch.Tensor,   # (Q, W) int32 user role masks
    k: int,
    block_rows: int = 16384,
    metric: str = "l2",         # "l2" | "ip" | "cosine" (unit corpus rows:
                                # core.build_device_arena normalizes them)
                                # | "l1"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (dists (Q, k) ascending in the metric's distance: squared
    L2, -q.x, cosine distance 1 - cos, or the l1 distance; idx (Q, k)
    int32). Slots with no admissible vector get dist=+inf and idx=-1."""
    q = queries.to(torch.float32)
    if metric == "cosine":
        q = _unit(q)
    elif metric not in ("l2", "ip", "l1"):
        raise ValueError(f"unknown metric {metric!r}")
    qn = (q * q).sum(dim=1, keepdim=True)
    qc = q.to(vectors.dtype).to(torch.float32)

    def score_block(off):
        xb = vectors[off:off + block_rows].to(torch.float32)
        if metric == "l1":
            return torch.cdist(q, xb, p=1.0)
        with products(vectors.dtype):
            dots = qc @ xb.T
        return (norms[None, off:off + block_rows] - 2.0 * dots
                if metric == "l2" else -dots)

    vals, idx = blocked_topk(score_block, role_bits, query_bits, k,
                              vectors.shape[0], block_rows)
    return scores_to_distances(vals, idx, qn, metric)


def masked_scan_topk_aug(
    queries: torch.Tensor,      # (Q, d) float32, raw
    vectors_aug: torch.Tensor,  # (Npad, d_aug) [x | norm_hi | norm_lo | 0]
    role_bits: torch.Tensor,    # (Npad, W) int32
    query_bits: torch.Tensor,   # (Q, W) int32
    k: int,
    block_rows: int = 65536,
    metric: str = "l2",         # "l2" | "ip" | "cosine"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The augmented layout's scan: scores are one product of the
    augmented query [w_q q | w | w | 0] (core.augment_queries, rounded to
    the rows' dtype) with the augmented rows, the norm term inside it for
    l2, zeroed for ip and cosine. The same outputs as masked_scan_topk up
    to the norm's hi/lo split and the order of summation. l1 has no
    product form and is refused (its arenas have no augmented layout)."""
    if metric == "l1":
        raise ValueError("l1 has no augmented (product) form")
    q = queries.to(torch.float32)
    if metric == "cosine":
        q = _unit(q)
    elif metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    qn = (q * q).sum(dim=1, keepdim=True)
    q_aug = augment_queries(q, vectors_aug.shape[1], metric).to(
        vectors_aug.dtype).to(torch.float32)

    def score_block(off):
        xb = vectors_aug[off:off + block_rows].to(torch.float32)
        with products(vectors_aug.dtype):
            return q_aug @ xb.T

    vals, idx = blocked_topk(score_block, role_bits, query_bits, k,
                              vectors_aug.shape[0], block_rows)
    return scores_to_distances(vals, idx, qn, metric)
