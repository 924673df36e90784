"""Fused int8 RBAC-masked scan, its decode, and the result wire.

Counterpart of vectorsearch_rbac_tpu/ops/pallas_scan_int8.py. The scan
itself is the hand-written CUDA kernel in csrc/scan_int8.cu (see the note
there); `int8_group_minima_plain` is its plain PyTorch version, used for CPU
tensors and as the reference the kernel is checked against on the card.

Admissibility is read from the (N, W) role bitsets directly, as an int32
view of the uint32 words, not from int8 role one-hots: the kernel ANDs
W words per pair, which is the same predicate as the TPU kernel's one-hot
matmul (core.bits_to_onehot8 is a bit-for-bit expansion).

Left out against the reference (ROADMAP.md): the wide d-split kernel
(d_pad > 256), the admit-dedup `mask_sub_block` form, the approx/cascade
merges, and the bf16/u8 wires.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import _build
from .merge import merge_supported, merge_topk
from .scan import admissible, exact_f32_matmul

LANE_MASK = 0x7F
MASKED_I32 = 0x7F000000  # > any packed score (|score| << 7 < 2^30)
EMPTY_I32 = 0x7E000000
TILE_ROWS = 128          # the kernel stages 128-row tiles
MAX_WORDS = 8            # role bitset words the kernel holds (256 roles)
_CHUNK_ELEMS = 1 << 27   # plain version: elements per (rows, Q) temporary


def _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group):
    nq, d_pad = queries_q.shape
    npad = vectors_q.shape[0]
    if vectors_q.shape[1] != d_pad or norms_q.shape != (npad,):
        raise ValueError(f"shape mismatch: q {tuple(queries_q.shape)}, x "
                         f"{tuple(vectors_q.shape)}, norms "
                         f"{tuple(norms_q.shape)}")
    if role_bits.shape[0] != npad or query_bits.shape != (
            nq, role_bits.shape[1]):
        raise ValueError(f"bitset shapes {tuple(role_bits.shape)} / "
                         f"{tuple(query_bits.shape)} do not match")
    if group not in (8, 16, 32, 64, 128) or npad % group:
        raise ValueError(f"group {group} must be a power of two in [8, 128] "
                         f"dividing npad {npad}")


def int8_group_minima_plain(queries_q, vectors_q, norms_q, role_bits,
                            query_bits, group: int = 128, metric: str = "l2",
                            score_shift: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the scan kernel: (n_groups, Q) int32 packed
    (score << 7 | lane) group minima, 0x7F000000 where no row is admissible.

    The dots run as a float32 matmul (CUDA has no int8/int32 matmul), chunked
    over rows so (Q, Npad) never exists. This is exact: every partial sum is
    an integer with |.| <= 128 * 128 * d_pad < 2^24 for d_pad <= 768, and
    float32 holds every integer below 2^24. TF32 is switched off around it."""
    _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group)
    nq = queries_q.shape[0]
    npad = vectors_q.shape[0]
    dev = queries_q.device
    qf = queries_q.to(torch.float32)
    chunk = max(group, min(npad, (_CHUNK_ELEMS // max(nq, 1)) // group * group))
    lane = torch.arange(group, dtype=torch.int32, device=dev).view(1, group, 1)
    out = torch.empty((npad // group, nq), dtype=torch.int32, device=dev)
    with exact_f32_matmul():
        for r0 in range(0, npad, chunk):
            r1 = min(r0 + chunk, npad)
            dots = (vectors_q[r0:r1].to(torch.float32) @ qf.T).to(torch.int32)
            if metric == "l2":
                score = norms_q[r0:r1, None] - 2 * dots
            else:
                score = -dots
            if score_shift:
                score = score >> score_shift             # arithmetic
            admit = admissible(role_bits[r0:r1], query_bits)  # (rows, Q)
            # score * 128 + lane is (score << 7) | lane without shifting a
            # negative int: |score| < 2^23 keeps it inside int32
            packed = torch.where(
                admit.view(-1, group, nq),
                score.view(-1, group, nq) * 128 + lane,
                torch.full((), MASKED_I32, dtype=torch.int32, device=dev))
            out[r0 // group:r1 // group] = packed.amin(dim=1)
    return out


def int8_group_minima(queries_q, vectors_q, norms_q, role_bits, query_bits,
                      group: int = 128, metric: str = "l2",
                      score_shift: int = 0) -> torch.Tensor:
    """(n_groups, Q) int32 packed group minima.

    queries_q (Q, d_pad) int8, vectors_q (Npad, d_pad) int8, norms_q (Npad,)
    int32, role_bits (Npad, W) int32, query_bits (Q, W) int32. CPU tensors
    take the plain version; CUDA tensors launch csrc/scan_int8.cu."""
    if queries_q.device.type == "cpu":
        return int8_group_minima_plain(queries_q, vectors_q, norms_q,
                                       role_bits, query_bits, group, metric,
                                       score_shift)
    _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group)
    nq, d_pad = queries_q.shape
    npad, w = vectors_q.shape[0], role_bits.shape[1]
    if d_pad not in (128, 256):
        raise NotImplementedError(
            f"d_pad {d_pad}: the CUDA scan takes d_pad 128 or 256; the wide "
            "d-split kernel is ROADMAP queue 2 item 2")
    if npad % TILE_ROWS or w > MAX_WORDS:
        raise ValueError(f"npad {npad} must be a multiple of {TILE_ROWS} and "
                         f"W {w} at most {MAX_WORDS}")
    tensors = (queries_q, vectors_q, norms_q, role_bits, query_bits)
    dtypes = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
    for t, dt in zip(tensors, dtypes):
        if t.device != queries_q.device or t.dtype != dt \
                or not t.is_contiguous() \
                or t.data_ptr() % (16 if dt == torch.int8 else 4):
            raise ValueError(f"scan_int8 takes contiguous {dt} tensors on one "
                             f"device, int8 rows 16-byte aligned; got "
                             f"{t.dtype} on {t.device}")
    out = torch.empty((npad // group, nq), dtype=torch.int32,
                      device=queries_q.device)
    err = _build.lib().vsr_scan_int8(
        *(t.data_ptr() for t in tensors), out.data_ptr(), nq, npad, d_pad, w,
        group, int(metric == "l2"), score_shift,
        _build.stream_ptr(queries_q.device))
    _build.check(err, "vsr_scan_int8")
    _build.LAUNCHES["scan_int8"] += 1
    return out


def int8_masked_topk(
    queries_q: torch.Tensor,    # (Q, d_pad) int8 quantized queries
    query_norms: torch.Tensor,  # (Q,) int32 ||q_q||^2
    vectors_q: torch.Tensor,    # (Npad, d_pad) int8
    norms_q: torch.Tensor,      # (Npad,) int32
    role_bits: torch.Tensor,    # (Npad, W) int32 view of the uint32 bitsets
    query_bits: torch.Tensor,   # (Q, W) int32 user masks
    inv_scale_sq: float,        # 1 / scale^2
    k: int,
    group: int = 128,
    merge: str = "kernel",      # "kernel" (merge.cu, the counterpart of the
                                # reference's "pallas") | "exact"
    metric: str = "l2",
    score_shift: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (dists (Q, k) float32 ascending, idx (Q, k) int32 arena rows;
    -1 / +inf on empty slots)."""
    packed = int8_group_minima(queries_q, vectors_q, norms_q, role_bits,
                               query_bits, group, metric, score_shift)
    return merge_group_minima(packed, query_norms, inv_scale_sq, k, group,
                              merge, metric, score_shift)


def merge_group_minima(packed, query_norms, inv_scale_sq: float, k, group,
                       merge, metric, score_shift=0):
    """(n_groups, Q) packed minima -> (dists (Q, k), idx (Q, k)): the
    reference's _merge_group_minima for its "pallas" and "exact" branches,
    squared L2. Shapes the merge kernels' gate refuses take the exact
    merge."""
    if metric != "l2":
        raise NotImplementedError(
            "the ip/cosine decode needs per-query scales and bias (ROADMAP "
            "slice 2)")
    n_groups = packed.shape[0]
    if merge == "kernel" and not merge_supported(n_groups, k):
        merge = "exact"
    if merge == "kernel":
        vals, pos = merge_topk(packed, k)
    elif merge == "exact":
        # a stable sort puts the lower group first among equal values, as
        # lax.top_k does
        srt, order = torch.sort(packed.T, dim=1, stable=True)
        vals, pos = srt[:, :k], order[:, :k].to(torch.int32)
    else:
        raise NotImplementedError(
            f"merge {merge!r}: the approx and cascade merges are not ported")
    idx = pos * group + (vals & LANE_MASK)
    score = vals >> 7                                    # arithmetic
    if score_shift:
        score = score << score_shift
    empty = vals >= EMPTY_I32
    # a Python scalar, not a device tensor: building one from host memory
    # is a pageable copy, which waits for the stream's queued kernels
    inv2 = float(inv_scale_sq)
    dists = torch.clamp_min(
        (score + query_norms[:, None]).to(torch.float32) * inv2, 0.0)
    dists = torch.where(empty, torch.inf, dists)
    idx = torch.where(empty, -1, idx)
    return dists, idx


# ------------------------------------------------------------- result wire

def _hi_pack_geometry(k: int, id_bits: int) -> Tuple[int, int, int]:
    """(hi_bits, ids-per-u16, packed-hi-u16-count) for the wire format."""
    hi_bits = max(id_bits - 16, 0)
    per = 16 // hi_bits if hi_bits else k
    return hi_bits, per, -(-k // per)


def _as_u16_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 65535] -> int16 with the same 16 bits (the host
    views them as uint16)."""
    return torch.where(x >= 32768, x - 65536, x).to(torch.int16)


def pack_results_device(dists: torch.Tensor, idx: torch.Tensor,
                        id_bits: int = 24, dist: str = "f32") -> torch.Tensor:
    """(Q, k) f32 dists + (Q, k) int32 ids -> one 16-bit wire row per query,
    byte for byte the reference's pack_results_device for the "ids" and
    "f32" wires (the rows come back as int16; the host views them as
    uint16). Empty slots travel as dist=+inf, id=0.

    - "ids": a u16 valid-count header, then the id sections; the host
      returns rank pseudo-distances 0..k-1;
    - "f32": the distances as two u16 halves, then the id sections.
    Ids travel as a u16 low half plus their high bits packed
    16 // (id_bits - 16) to a u16."""
    q, k = idx.shape
    hi_bits, per, n_hi = _hi_pack_geometry(k, id_bits)
    empty = ~torch.isfinite(dists)
    idc = torch.where(empty, 0, idx.to(torch.int32))
    if dist == "ids":
        d16 = (~empty).sum(dim=1, dtype=torch.int32)[:, None]
    elif dist == "f32":
        d32 = dists.contiguous().view(torch.int32)
        d16 = torch.cat([d32 & 0xFFFF, (d32 >> 16) & 0xFFFF], dim=1)
    else:
        raise NotImplementedError(
            f"wire {dist!r}: the bf16 and u8 wires are ROADMAP items")
    parts = [d16, idc & 0xFFFF]
    if hi_bits:
        hi = (idc >> 16) & ((1 << hi_bits) - 1)
        pad = n_hi * per - k
        if pad:
            hi = torch.cat([hi, hi.new_zeros((q, pad))], dim=1)
        shifts = torch.arange(per, dtype=torch.int32,
                              device=hi.device) * hi_bits
        # the fields do not overlap, so their sum is their OR
        parts.append((hi.view(q, n_hi, per) << shifts).sum(
            dim=2, dtype=torch.int32))
    return _as_u16_bits(torch.cat(parts, dim=1))


def unpack_results_host(arr, k: int, id_bits: int = 24, dist: str = "f32"):
    """Inverse of pack_results_device on the host (numpy), for the "ids"
    and "f32" wires: the reference's unpack_results_host."""
    hi_bits, per, n_hi = _hi_pack_geometry(k, id_bits)
    a = np.asarray(arr)
    if a.dtype == np.int16:
        a = a.view(np.uint16)
    if dist == "ids":
        count = a[:, :1].astype(np.int32)                  # (Q, 1)
        rank = np.arange(k, dtype=np.int32)[None, :]
        empty = rank >= count
        d = rank.astype(np.float32) * np.ones((a.shape[0], 1), np.float32)
        off = 1
    elif dist == "f32":
        d = (a[:, :k].astype(np.uint32)
             | (a[:, k:2 * k].astype(np.uint32) << 16)).view(np.float32)
        empty = ~np.isfinite(d)
        off = 2 * k
    else:
        raise NotImplementedError(
            f"wire {dist!r}: the bf16 and u8 wires are ROADMAP items")
    idx = a[:, off:off + k].astype(np.int32)
    if hi_bits:
        packed_hi = a[:, off + k:off + k + n_hi]           # (Q, n_hi)
        reps = np.repeat(packed_hi, per, axis=1)[:, :k]
        shifts = np.tile(np.arange(per, dtype=np.uint16) * hi_bits,
                         n_hi)[:k][None, :]
        idx |= ((reps >> shifts) & ((1 << hi_bits) - 1)).astype(np.int32) << 16
    return np.where(empty, np.inf, d), np.where(empty, -1, idx)

