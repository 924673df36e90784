"""RBAC-masked scan over sparse rows (pgvector's sparsevec) with top-k.

Counterpart of vectorsearch_rbac_tpu/ops/sparse_scan.py: `pad_sparse_rows`
and `densify_queries` (copies of the reference's numpy code) and
`masked_sparse_topk`, plain PyTorch as the reference leaves its scan to
XLA. The corpus keeps its sparsity as a padded CSR block layout (cols
(Npad, nnz_pad) with column `dim` as the pad slot, vals zero there), the
queries are dense (Q, dim + 1) rows with slot `dim` zero, and a row scores
against a query by a gather of the query at its columns:

    l2:     ||x||^2 - 2 sum_j vals_j q[cols_j]       (+ ||q||^2 at the end)
    ip:     -sum_j vals_j q[cols_j]
    cosine: the ip score on unit rows and queries     (1 + s at the end)
    l1:     sum_j (|vals_j - q[cols_j]| - |q[cols_j]|)   (+ ||q||_1 at the end)

l1's identity counts the query's dimensions outside the row's support as
the constant ||q||_1, so one pass over the row's support suffices; pad
slots add 0 to every metric. The (Q, rows, nnz_pad) gather is cut into
row chunks of at most _GATHER_BYTES; each block keeps its k best and one
exact merge follows, as in the reference (ops/scan.py's blocked top-k);
the reference's `mode`/`recall_target` (an approximate per-block top-k)
is not carried.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .scan import blocked_topk, scores_to_distances

_GATHER_BYTES = 1 << 28


def pad_sparse_rows(indptr: np.ndarray, indices: np.ndarray,
                    data: np.ndarray, dim: int, npad: int,
                    nnz_pad: Optional[int] = None, lane: int = 8
                    ) -> Tuple[np.ndarray, np.ndarray, int]:
    """CSR -> (cols (npad, nnz_pad) int32 with column `dim` as the pad
    slot, vals (npad, nnz_pad) float32 zero-padded, nnz_pad): nnz_pad the
    longest row rounded up to `lane`. Rows past n are all pads."""
    n = len(indptr) - 1
    row_nnz = np.diff(indptr)
    max_nnz = int(row_nnz.max()) if n else 0
    if nnz_pad is None:
        nnz_pad = max(((max_nnz + lane - 1) // lane) * lane, lane)
    if nnz_pad < max_nnz:
        raise ValueError(f"nnz_pad {nnz_pad} < the longest row {max_nnz}")
    cols = np.full((npad, nnz_pad), dim, dtype=np.int32)
    vals = np.zeros((npad, nnz_pad), dtype=np.float32)
    if n:
        rows_of = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
        slot = np.arange(len(indices), dtype=np.int64) - \
            np.repeat(indptr[:-1].astype(np.int64), row_nnz)
        dest = rows_of * nnz_pad + slot
        cols.reshape(-1)[dest] = indices
        vals.reshape(-1)[dest] = data
    return cols, vals, nnz_pad


def densify_queries(q_cols: np.ndarray, q_vals: np.ndarray,
                    dim: int) -> np.ndarray:
    """Padded sparse queries (Q, qnnz) -> dense (Q, dim + 1) float32, the
    pad slot (column dim) 0."""
    nq, _ = q_cols.shape
    qd = np.zeros((nq, dim + 1), dtype=np.float32)
    qd[np.arange(nq)[:, None], q_cols] = q_vals
    qd[:, dim] = 0.0
    return qd


def masked_sparse_topk(
    qdense: torch.Tensor,       # (Q, d+1) float32, slot d == 0
    cols: torch.Tensor,         # (Npad, nnz_pad) int32, pad slot = d
    vals: torch.Tensor,         # (Npad, nnz_pad) float32
    norms: torch.Tensor,        # (Npad,) float32 squared L2 norms of rows
    role_bits: torch.Tensor,    # (Npad, W) int32
    query_masks: torch.Tensor,  # (Q, W) int32
    k: int,
    block_rows: int = 2048,
    metric: str = "l2",         # "l2" | "ip" | "cosine" | "l1"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (dists (Q, k) ascending in the metric, idx (Q, k) int32).
    cosine expects unit rows and normalizes qdense here. Empty slots:
    dist=+inf, idx=-1."""
    if metric not in ("l2", "ip", "cosine", "l1"):
        raise ValueError(f"unknown metric {metric!r}")
    q = qdense.to(torch.float32)
    if metric == "cosine":
        q = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-30)
    nq = q.shape[0]
    npad, nnz = cols.shape
    step = max(1, min(block_rows, _GATHER_BYTES // max(1, 4 * nq * nnz)))

    def score_block(off):
        parts = []
        for r0 in range(off, off + block_rows, step):
            r1 = min(r0 + step, off + block_rows)
            vb = vals[r0:r1]
            qg = q.index_select(1, cols[r0:r1].reshape(-1)).view(
                nq, r1 - r0, nnz)
            if metric == "l1":
                parts.append(((vb[None] - qg).abs() - qg.abs()).sum(dim=2))
                continue
            dots = (vb[None] * qg).sum(dim=2)
            parts.append(norms[None, r0:r1] - 2.0 * dots
                         if metric == "l2" else -dots)
        return torch.cat(parts, dim=1)

    top, idx = blocked_topk(score_block, role_bits, query_masks, k, npad,
                             block_rows)
    if metric == "l1":
        empty = torch.isinf(top)
        top = torch.clamp_min(top + q.abs().sum(dim=1, keepdim=True), 0.0)
        return (torch.where(empty, torch.inf, top),
                torch.where(empty, -1, idx))
    return scores_to_distances(top, idx, (q * q).sum(dim=1, keepdim=True),
                               metric)
