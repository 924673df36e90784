"""Exact RBAC-masked distance scan with top-k: the ground-truth oracle.

Counterpart of vectorsearch_rbac_tpu/ops/scan.py `masked_scan_topk` in
exact mode, for squared L2, negative inner product and cosine distance.
Plain PyTorch: the reference leaves this scan to XLA, not to a Pallas
kernel. Rows are scanned in blocks; each block keeps its k best admissible
rows and one exact merge over all blocks' candidates follows, as in the
reference. Float32 throughout with TF32 off, so on integer-valued corpora
(SIFT family, |q.x| < 2^24) every score is exact.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch


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


def admissible(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """(A, W) x (B, W) int32 bitsets -> (A, B) bool: any shared role bit."""
    allowed = torch.zeros((a_bits.shape[0], b_bits.shape[0]),
                          dtype=torch.bool, device=a_bits.device)
    for w in range(a_bits.shape[1]):
        allowed |= (a_bits[:, w, None] & b_bits[None, :, w]) != 0
    return allowed


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (dists (Q, k) ascending in the metric's distance: squared
    L2, -q.x, or cosine distance 1 - cos; idx (Q, k) int32). Slots with no
    admissible vector get dist=+inf and idx=-1."""
    q = queries.to(torch.float32)
    if metric == "cosine":
        q = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-30)
    elif metric not in ("l2", "ip"):
        raise NotImplementedError(f"metric {metric!r} is not ported")
    npad = vectors.shape[0]
    if npad % block_rows:
        raise ValueError(f"npad {npad} is not a multiple of {block_rows}")
    qn = (q * q).sum(dim=1, keepdim=True)
    cand_vals, cand_idx = [], []
    with exact_f32_matmul():
        for off in range(0, npad, block_rows):
            xb = vectors[off:off + block_rows].to(torch.float32)
            dots = q @ xb.T
            scores = (norms[None, off:off + block_rows] - 2.0 * dots
                      if metric == "l2" else -dots)
            allowed = admissible(query_bits, role_bits[off:off + block_rows])
            scores = scores.masked_fill(~allowed, torch.inf)
            bvals, bpos = torch.topk(scores, min(k, block_rows), dim=1,
                                     largest=False)
            cand_vals.append(bvals)
            cand_idx.append(bpos.to(torch.int32) + off)
    vals, pos = torch.topk(torch.cat(cand_vals, dim=1), k, dim=1,
                           largest=False)
    idx = torch.gather(torch.cat(cand_idx, dim=1), 1, pos)
    empty = torch.isinf(vals)
    if metric == "l2":
        dists = torch.clamp_min(vals + qn, 0.0)
    elif metric == "cosine":
        dists = torch.clamp(1.0 + vals, 0.0, 2.0)
    else:
        dists = vals
    dists = torch.where(empty, torch.inf, dists)
    return dists, torch.where(empty, -1, idx)
