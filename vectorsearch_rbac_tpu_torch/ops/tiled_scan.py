"""Tiled contiguous partitioned scan (int8): the chunk engine.

Counterpart of vectorsearch_rbac_tpu/ops/tiled_scan.py, which the
reference leaves to XLA (no Pallas kernel): plain PyTorch here, until a
profile on the card says a hand kernel pays (ROADMAP queue 2). Each
partition's rows are stored once, contiguously, in fixed-size chunks; the
queries of a slot (up to q_tile of one partition) scan that partition's
chunks together, so each chunk is read once per slot.

Against the reference's arithmetic:

- admissibility reads chunked role bitsets (LC, chunk_rows, W) int32,
  all-zero for chunk 0 (the dummy chunk padding slots point at) and for
  pad rows, ANDed with the query's W mask words: the predicate of the
  reference's int8 one-hot matmul, as in the fused scan (ops/scan_int8);
- the dots are float32 bmms with TF32 off over column slices of at most
  768, whose int32 partials are summed (as ops/scan_int8.exact_dots does):
  every partial sum inside one slice is an integer with |.| <= 128 * 128 *
  768 < 2^24, which float32 holds exactly, so the dots are exact at any
  d_pad. CUDA has no int8 bmm in PyTorch;
- every top-k is a stable sort, which orders ties by position as
  lax.top_k does, so ids match the reference's up to nothing.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .scan import exact_f32_matmul

BIG_I32 = 2**30            # unpacked sentinel: no admissible row
MASKED_I32 = 0x7F000000    # packed sentinel of the grouped epilogue
_EXACT_D = 768             # columns per float32 partial dot


def _topk_smallest(vals: torch.Tensor, k: int):
    """The k smallest along the last axis, ties by position (lax.top_k's
    order on the negated values)."""
    srt, pos = torch.sort(vals, dim=-1, stable=True)
    return srt[..., :k], pos[..., :k]


def _exact_bmm(q3f: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(S, Q, C) int32 dots of float32 copies of int8 queries (S, Q, d)
    and int8 rows (S, C, d), as float32 bmms over column slices of at most
    768 whose int32 partials are summed (exact: see the module note). Call
    it inside exact_f32_matmul()."""
    dots = None
    for c0 in range(0, q3f.shape[2], _EXACT_D):
        part = torch.bmm(q3f[:, :, c0:c0 + _EXACT_D],
                         x[:, :, c0:c0 + _EXACT_D].to(torch.float32)
                         .transpose(1, 2)).to(torch.int32)
        dots = part if dots is None else dots + part
    return dots


def _chunk_step(q3f, m3, ids, vec_chunks, norm_chunks, role_chunks):
    """One chunk of every slot: (S, Q, C) int32 scores ||x||^2 - 2 q.x and
    (S, Q, C) bool admissibility."""
    x = vec_chunks.index_select(0, ids)                          # (S, C, d)
    dots = _exact_bmm(q3f, x)                                    # (S, Q, C)
    nrm = norm_chunks.index_select(0, ids)                       # (S, C)
    r = role_chunks.index_select(0, ids)                         # (S, C, W)
    admit = torch.zeros(dots.shape, dtype=torch.bool, device=dots.device)
    for w in range(r.shape[2]):
        admit |= (m3[:, :, None, w] & r[:, None, :, w]) != 0
    return nrm[:, None, :] - 2 * dots, admit


def tiled_scan_core(
    q3: torch.Tensor,           # (S, q_tile, d) int8
    m3: torch.Tensor,           # (S, q_tile, W) int32 query mask words
    chunk_ids: torch.Tensor,    # (S, chunks) int64; 0 = the dummy chunk
    vec_chunks: torch.Tensor,   # (LC, chunk_rows, d) int8
    norm_chunks: torch.Tensor,  # (LC, chunk_rows) int32
    role_chunks: torch.Tensor,  # (LC, chunk_rows, W) int32; zero = pad
    row_chunks: torch.Tensor,   # (LC, chunk_rows) int32 arena rows, -1 pad
    k: int,
    chunks: int,
    score_shift: int = 0,       # score >> shift before any pack
    scan_group: int = 0,        # 0: exact per-chunk top-k; g: packed
                                # (score << log2 g | lane) group minima
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot chunked scan: (S, q_tile, k) int32 partial scores
    (BIG_I32 where empty) and their arena rows."""
    s, q_tile, _ = q3.shape
    chunk_rows = vec_chunks.shape[1]
    if scan_group and scan_group < chunk_rows:
        return _tiled_scan_grouped(
            q3, m3, chunk_ids, vec_chunks, norm_chunks, role_chunks,
            row_chunks, k, chunks, scan_group, score_shift)
    kk = min(k, chunk_rows)
    q3f = q3.to(torch.float32)
    vals, rids = [], []
    with exact_f32_matmul():
        for c in range(chunks):
            ids = chunk_ids[:, c]
            score, admit = _chunk_step(q3f, m3, ids, vec_chunks,
                                       norm_chunks, role_chunks)
            score = torch.where(admit, score, BIG_I32)
            top, pos = _topk_smallest(score, kk)
            rows = row_chunks.index_select(0, ids)               # (S, C)
            rows = rows[:, None, :].expand(s, q_tile, chunk_rows)
            vals.append(top)
            rids.append(torch.gather(rows, 2, pos))
    vals = torch.cat(vals, dim=2)                     # (S, Q, chunks * kk)
    rids = torch.cat(rids, dim=2)
    if chunks * kk < k:
        pad = k - chunks * kk
        vals = torch.cat([vals, vals.new_full((s, q_tile, pad), BIG_I32)], 2)
        rids = torch.cat([rids, rids.new_full((s, q_tile, pad), -1)], 2)
    top, pos = _topk_smallest(vals, k)
    return top, torch.gather(rids, 2, pos)


def _tiled_scan_grouped(q3, m3, chunk_ids, vec_chunks, norm_chunks,
                        role_chunks, row_chunks, k: int, chunks: int, g: int,
                        score_shift: int = 0):
    """Grouped epilogue: per chunk, one packed (score << shift | lane)
    minimum per g rows, shift = bit_length(g - 1), and one top-k at the
    end; the packed value's low bits recover the row. The packed value is
    formed as score * 2^shift + lane (a left shift of a negative int is
    not defined in every language this engine has a counterpart in)."""
    s, q_tile, _ = q3.shape
    chunk_rows = vec_chunks.shape[1]
    if chunk_rows % g or g & (g - 1):
        raise ValueError(f"group {g} must be a power of two dividing "
                         f"{chunk_rows}")
    shift = max(g - 1, 1).bit_length()
    gpc = chunk_rows // g
    lane = torch.arange(g, dtype=torch.int32, device=q3.device)
    q3f = q3.to(torch.float32)
    mins = []
    with exact_f32_matmul():
        for c in range(chunks):
            score, admit = _chunk_step(q3f, m3, chunk_ids[:, c], vec_chunks,
                                       norm_chunks, role_chunks)
            if score_shift:
                score = score >> score_shift                 # arithmetic
            packed = torch.where(admit, score * (1 << shift) + lane.repeat(
                gpc), MASKED_I32)
            mins.append(packed.view(s, q_tile, gpc, g).amin(dim=3))
    mins = torch.cat(mins, dim=2)                     # (S, Q, chunks * gpc)
    kk = min(k, chunks * gpc)
    vals, pos = _topk_smallest(mins, kk)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((s, q_tile, k - kk),
                                              MASKED_I32)], 2)
        pos = torch.cat([pos, pos.new_zeros((s, q_tile, k - kk))], 2)
    c_idx = pos // gpc                                 # which chunk step
    grp = pos % gpc                                    # group within chunk
    in_lane = vals & (g - 1)
    top = vals >> shift                                # arithmetic
    if score_shift:
        top = top * (1 << score_shift)                 # restore magnitude
    empty = vals >= MASKED_I32
    top = torch.where(empty, BIG_I32, top)
    cids = torch.gather(chunk_ids[:, None, :].expand(s, q_tile, chunks), 2,
                        c_idx)
    flat = cids * chunk_rows + grp * g + in_lane.to(torch.int64)
    idx = row_chunks.reshape(-1).index_select(0, flat.reshape(-1)).view(
        flat.shape)
    return top, torch.where(empty, -1, idx)


def finish_scores(top: torch.Tensor, idx: torch.Tensor,
                  query_norms: torch.Tensor,
                  inv_scale_sq: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int32 partial scores -> squared L2 float32 (+inf / -1 on
    empty slots); query_norms broadcasts over the trailing k axis."""
    empty = top >= BIG_I32
    dists = (top + query_norms[..., None]).to(torch.float32) * inv_scale_sq
    dists = torch.where(empty, torch.inf, torch.clamp_min(dists, 0.0))
    return dists, torch.where(empty, -1, idx)


def tiled_bucket_topk(
    queries_q: torch.Tensor,    # (S * q_tile, d) int8, grouped by slot
    query_norms: torch.Tensor,  # (S * q_tile,) int32
    query_bits: torch.Tensor,   # (S * q_tile, W) int32 user masks
    chunk_ids: torch.Tensor,    # (S, chunks) int64; 0 = the dummy chunk
    vec_chunks: torch.Tensor,
    norm_chunks: torch.Tensor,
    role_chunks: torch.Tensor,
    row_chunks: torch.Tensor,
    inv_scale_sq: float,        # 1 / scale^2
    k: int,
    chunks: int,
    q_tile: int,
    scan_group: int = 0,
    score_shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (dists (S*q_tile, k) float32 ascending, arena rows (S*q_tile,
    k) int32; +inf / -1 pads). Slot s scans chunks chunk_ids[s, :]."""
    sq, d = queries_q.shape
    s = sq // q_tile
    top, idx = tiled_scan_core(
        queries_q.view(s, q_tile, d), query_bits.view(s, q_tile, -1),
        chunk_ids, vec_chunks, norm_chunks, role_chunks, row_chunks, k=k,
        chunks=chunks, score_shift=score_shift, scan_group=scan_group)
    return finish_scores(top.reshape(sq, k), idx.reshape(sq, k), query_norms,
                         inv_scale_sq)
