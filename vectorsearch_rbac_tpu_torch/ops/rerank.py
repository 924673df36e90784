"""The float32 rerank tier: re-score the int8 scan's candidates exactly.

Counterpart of the rerank block inside the reference's fused dispatch
(vectorsearch_rbac_tpu/index/flat_int8.py `_scan_pack`), which XLA
computes, not a Pallas kernel; here it is plain PyTorch. A lossy int8
arena (or any ip/cosine arena, whose queries quantize with their own
scales) takes the scan's k + margin best candidates, rebuilds a float
query, and re-scores every candidate against the arena's bfloat16 mirror
in float32 (TF32 off), keeping the k best.

The five query sources, the reference's rerank modes:
- "dequant":   rebuild from the int8 code alone; l2: q8 / scale + center,
               ip/cosine: q8 * inv * scale (inv = 1 / (qs * scale) is the
               query's own scale, so inv * scale = 1 / qs);
- "residual":  (q8 + r8 / 254) * inv * scale, r8 the int8 residual code;
- "residual4": (q8 + (nibble - 8) / 15) * inv * scale, two 4-bit codes per
               byte, component 2j in the low nibble and 2j+1 in the high;
- "f16"/"f32": the query itself, shipped in that type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .scan import exact_f32_matmul

RERANK_MODES = ("dequant", "residual", "residual4", "f16", "f32")
# the reference's float32 constants, as Python floats holding them exactly
_INV_254 = float(np.float32(1 / 254.0))
_INV_15 = float(np.float32(1 / 15.0))


def rebuild_query(mode: str, metric: str, dim: int, q8: torch.Tensor,
                  inv: Optional[torch.Tensor] = None, q_dequant: float = 1.0,
                  center: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  shipped: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, dim) float32 rerank queries of one batch.

    q8 (Q, d_pad) int8 codes; inv (Q,) float32 per-query scales (ip/cosine);
    q_dequant the corpus constant (l2: 1 / scale, ip/cosine: scale); center
    (d_pad,) float32 (l2 dequant); residual (Q, d_pad) int8 ("residual") or
    (Q, d_pad / 2) uint8 ("residual4"); shipped (Q, dim) float16/float32
    ("f16"/"f32"). Cosine queries are normalized again after the rebuild."""
    if mode in ("f16", "f32"):
        qf = shipped.to(torch.float32)
    elif mode == "dequant" and metric == "l2":
        qf = (q8.to(torch.float32) * q_dequant + center[None, :])[:, :dim]
    else:
        if metric == "l2":
            # l2 quantizes with one global scale that can clip a component;
            # a +-0.5 residual cannot recover that (the reference refuses
            # the combination too)
            raise ValueError(f"rerank mode {mode!r} needs per-query scales "
                             "(ip/cosine)")
        qx = q8.to(torch.float32)
        if mode == "residual":
            qx = qx + residual.to(torch.float32) * _INV_254
        elif mode == "residual4":
            # uint8 codes: & and >> on the unsigned byte
            lo = (residual & 0xF).to(torch.float32) - 8.0
            hi = (residual >> 4).to(torch.float32) - 8.0
            r = torch.stack([lo, hi], dim=2).reshape(qx.shape[0], -1)
            qx = qx + r * _INV_15
        elif mode != "dequant":
            raise ValueError(f"rerank mode {mode!r} is not one of "
                             f"{RERANK_MODES}")
        qf = (qx * (inv * q_dequant)[:, None])[:, :dim]
    if metric == "cosine":
        qf = qf / torch.clamp_min(
            torch.linalg.vector_norm(qf, dim=1, keepdim=True), 1e-30)
    return qf


def rerank_topk(qf: torch.Tensor, ids: torch.Tensor, mirror: torch.Tensor,
                mirror_norms: torch.Tensor, k: int,
                metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-score candidates exactly and keep the k best.

    qf (Q, d) float32 queries, ids (Q, kk) int32 arena rows (-1 = empty),
    mirror (Npad, d) the arena's full-precision rows (bfloat16 on int8
    arenas), mirror_norms (Npad,) float32 squared norms. Returns (dists
    (Q, k) float32 ascending, ids (Q, k) int32): squared L2 clamped at 0,
    cosine distance 1 - q.x clipped to [0, 2], or -q.x; empty slots +inf /
    -1. Ties may order differently from the reference's lax.top_k."""
    safe = ids.clamp_min(0).long()
    x = mirror[safe].to(torch.float32)                  # (Q, kk, d)
    with exact_f32_matmul():
        dots = torch.bmm(x, qf[:, :, None]).squeeze(2)  # (Q, kk)
    if metric == "l2":
        d2 = torch.clamp_min(mirror_norms[safe] - 2.0 * dots
                             + (qf * qf).sum(dim=1, keepdim=True), 0.0)
    elif metric == "cosine":
        d2 = torch.clamp(1.0 - dots, 0.0, 2.0)
    else:
        d2 = -dots
    d2 = torch.where(ids >= 0, d2, torch.inf)
    dists, pos = torch.topk(d2, k, dim=1, largest=False)
    return dists, torch.gather(ids, 1, pos)
