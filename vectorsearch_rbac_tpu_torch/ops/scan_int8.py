"""Fused int8 RBAC-masked scan, its decode, and the result wire.

Counterpart of vectorsearch_rbac_tpu/ops/pallas_scan_int8.py. The scan
itself is two hand-written CUDA kernels, both with their dots on the int8
tensor cores: csrc/scan_int8.cu for d_pad <= 256 and csrc/scan_int8_wide.cu
for wider rows (see the notes there), chosen by d_pad as the reference
chooses between int8_masked_topk and int8_masked_topk_wide. `int8_group_minima_plain` is the plain PyTorch
version of both (`int8_group_minima_wide_plain` names it for the wide
kernel), used for CPU tensors and as the reference the kernels are checked
against on the card.

Admissibility is read from the (N, W) role bitsets directly, as an int32
view of the uint32 words, not from int8 role one-hots: the kernel ANDs
W words per pair (in the index's slot layout once per row and warp),
which is the same predicate as the TPU kernel's one-hot matmul
(core.bits_to_onehot8 is a bit-for-bit expansion). Past 8 words (256
roles) both kernels switch to their wide-world forms, which count a
pair's shared roles on the binary tensor cores: the same predicate again;
past 32 words (1,024 roles) to their huge forms, which count 32 words at
a time. Any role count runs in one launch.

The admit-dedup slot form of the narrow scan (`mask_sub_block`: one mask
row per slot of `mask_sub_block` queries, ROADMAP queue 2's S2) takes
query bits of shape (Q / mask_sub_block, W) in one of two layouts,
`slot_of_query` says which slot each query reads. Its plain version
expands the slots to per-query masks and calls the per-query plain
version: the slot form's output is defined as that.

The wide kernel takes the same slot form (its `mask_sb`), in both layouts;
the index keeps admit-dedup off on wide rows, as the reference does, so
only the kernel lab (bench/lab.py wide-admit) launches it.

The merges after the scan (`merge_group_minima`) are the reference's
_merge_group_minima: the merge kernels (ops/merge.py), the cascade and
the exact merge, in plain PyTorch where the reference used XLA ops (its
approx and auto select exactly here, so they are the exact merge). The
result wire (`pack_results_device` / `unpack_results_host`) is
the reference's byte for byte in its four codings: ids, f32, bf16, u8.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from . import _build
from .merge import merge_supported, merge_topk
from .scan import admissible, exact_f32_matmul

LANE_MASK = 0x7F
MASKED_I32 = 0x7F000000  # > any packed score (|score| << 7 < 2^30)
EMPTY_I32 = 0x7E000000
TILE_ROWS = 128          # the kernels stage 128-row tiles
NARROW_MAX_D = 256       # wider rows take the wide kernel
_CHUNK_ELEMS = 1 << 27   # plain version: elements per (rows, Q) temporary
_EXACT_D = 768           # plain version: columns per float32 partial dot


def _check_slots(nq: int, mask_sub_block: int, slot_tile: int) -> None:
    sb, tile = mask_sub_block, slot_tile
    if sb < 0 or tile < 0 or (tile and not sb):
        raise ValueError(f"mask_sub_block {sb}, slot_tile {tile}")
    if sb and (nq % sb or (tile and (tile % sb or nq % tile))):
        raise ValueError(f"{nq} queries do not tile into slots of {sb}"
                         + (f" within tiles of {tile}" if tile else ""))


def slot_of_query(nq: int, mask_sub_block: int, slot_tile: int = 0,
                  device=None) -> torch.Tensor:
    """(nq,) int64: the row of the (nq / mask_sub_block, W) slot masks that
    each query reads. slot_tile 0 is the contiguous layout (query j reads
    slot j // mask_sub_block); otherwise the interleaved one of the TPU
    kernel's tile-style repeat: within each tile of slot_tile queries,
    query j reads slot j % nsb of the tile's nsb = slot_tile /
    mask_sub_block (index/flat_int8.py's first_q rule, inverted)."""
    _check_slots(nq, mask_sub_block, slot_tile)
    q = torch.arange(nq, dtype=torch.int64, device=device)
    if not slot_tile:
        return q // mask_sub_block
    nsb = slot_tile // mask_sub_block
    return (q // slot_tile) * nsb + q % nsb


def _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group, mask_sub_block=0, slot_tile=0):
    nq, d_pad = queries_q.shape
    npad = vectors_q.shape[0]
    if vectors_q.shape[1] != d_pad or norms_q.shape != (npad,):
        raise ValueError(f"shape mismatch: q {tuple(queries_q.shape)}, x "
                         f"{tuple(vectors_q.shape)}, norms "
                         f"{tuple(norms_q.shape)}")
    _check_slots(nq, mask_sub_block, slot_tile)
    rows = nq // mask_sub_block if mask_sub_block else nq
    if role_bits.shape[0] != npad or query_bits.shape != (
            rows, role_bits.shape[1]):
        raise ValueError(f"bitset shapes {tuple(role_bits.shape)} / "
                         f"{tuple(query_bits.shape)} do not match")
    if group not in (8, 16, 32, 64, 128) or npad % group:
        raise ValueError(f"group {group} must be a power of two in [8, 128] "
                         f"dividing npad {npad}")


def int8_group_minima_plain(queries_q, vectors_q, norms_q, role_bits,
                            query_bits, group: int = 128, metric: str = "l2",
                            score_shift: int = 0, mask_sub_block: int = 0,
                            slot_tile: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the scan kernels: (n_groups, Q) int32 packed
    (score << 7 | lane) group minima, 0x7F000000 where no row is admissible.
    With mask_sub_block the query bits are slot masks, expanded here to
    one row per query (slot_of_query).

    The dots run as float32 matmuls (CUDA has no int8/int32 matmul), chunked
    over rows so (Q, Npad) never exists and over columns in slices of at
    most 768, whose int32 partials are summed. This is exact at any d_pad:
    every partial sum inside one slice is an integer with |.| <= 128 * 128 *
    768 < 2^24, and float32 holds every integer below 2^24. TF32 is switched
    off around it."""
    _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group, mask_sub_block, slot_tile)
    nq = queries_q.shape[0]
    if mask_sub_block:
        query_bits = query_bits.index_select(0, slot_of_query(
            nq, mask_sub_block, slot_tile, query_bits.device))
    npad = vectors_q.shape[0]
    dev = queries_q.device
    qf = queries_q.to(torch.float32)
    chunk = max(group, min(npad, (_CHUNK_ELEMS // max(nq, 1)) // group * group))
    lane = torch.arange(group, dtype=torch.int32, device=dev).view(1, group, 1)
    out = torch.empty((npad // group, nq), dtype=torch.int32, device=dev)
    with exact_f32_matmul():
        for r0 in range(0, npad, chunk):
            r1 = min(r0 + chunk, npad)
            dots = exact_dots(vectors_q[r0:r1], qf)
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


def exact_dots(vectors_q: torch.Tensor, qf: torch.Tensor) -> torch.Tensor:
    """(rows, Q) int32 dots of int8 rows with float32 copies of int8
    queries, as float32 matmuls over column slices of at most 768 whose
    int32 partials are summed (exact: see int8_group_minima_plain). Call
    it inside exact_f32_matmul()."""
    dots = None
    for c0 in range(0, qf.shape[1], _EXACT_D):
        part = (vectors_q[:, c0:c0 + _EXACT_D].to(torch.float32)
                @ qf[:, c0:c0 + _EXACT_D].T).to(torch.int32)
        dots = part if dots is None else dots + part
    return dots


# the plain version of the wide kernel (csrc/scan_int8_wide.cu) is the same
# function: the contract does not depend on d_pad
int8_group_minima_wide_plain = int8_group_minima_plain


def _check_kernel_tensors(tensors, w: int, max_words: Optional[int] = None
                          ) -> None:
    """What the scan kernels take: contiguous int8 / int32 tensors on one
    device, int8 rows 16-byte aligned, 128-row tiles, and any number of
    bitset words, or at most `max_words` (the kernel lab's forms)."""
    npad = tensors[1].shape[0]
    if npad % TILE_ROWS:
        raise ValueError(f"npad {npad} must be a multiple of {TILE_ROWS}")
    if max_words is not None and w > max_words:
        raise ValueError(f"W {w}: these scan forms take at most {max_words} "
                         "bitset words")
    dtypes = (torch.int8, torch.int8, torch.int32, torch.int32, torch.int32)
    for t, dt in zip(tensors, dtypes):
        if t.device != tensors[0].device or t.dtype != dt \
                or not t.is_contiguous() \
                or t.data_ptr() % (16 if dt == torch.int8 else 4):
            raise ValueError(f"scan_int8 takes contiguous {dt} tensors on one "
                             f"device, int8 rows 16-byte aligned; got "
                             f"{t.dtype} on {t.device}")


def int8_group_minima_wide(queries_q, vectors_q, norms_q, role_bits,
                           query_bits, group: int = 128, metric: str = "l2",
                           score_shift: int = 0, mask_sub_block: int = 0,
                           slot_tile: int = 0) -> torch.Tensor:
    """int8_group_minima for any d_pad that is a multiple of 128 (the
    reference's int8_masked_topk_wide), with its slot form. CPU tensors
    take the plain version; CUDA tensors launch csrc/scan_int8_wide.cu
    (the slot form counts under "scan_int8_wide" and
    "scan_int8_wide_slots")."""
    if queries_q.device.type == "cpu":
        return int8_group_minima_wide_plain(
            queries_q, vectors_q, norms_q, role_bits, query_bits, group,
            metric, score_shift, mask_sub_block, slot_tile)
    _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group, mask_sub_block, slot_tile)
    nq, d_pad = queries_q.shape
    npad, w = vectors_q.shape[0], role_bits.shape[1]
    if d_pad % 128:
        raise ValueError(f"d_pad {d_pad}: the wide scan takes multiples of "
                         "128")
    tensors = (queries_q, vectors_q, norms_q, role_bits, query_bits)
    _check_kernel_tensors(tensors, w)
    out = torch.empty((npad // group, nq), dtype=torch.int32,
                      device=queries_q.device)
    err = _build.lib().vsr_scan_int8_wide(
        *(t.data_ptr() for t in tensors), out.data_ptr(), nq, npad, d_pad, w,
        group, int(metric == "l2"), score_shift, mask_sub_block, slot_tile,
        _build.stream_ptr(queries_q.device))
    _build.check(err, "vsr_scan_int8_wide")
    _build.LAUNCHES["scan_int8_wide"] += 1
    if mask_sub_block:
        _build.LAUNCHES["scan_int8_wide_slots"] += 1
    return out


def int8_group_minima(queries_q, vectors_q, norms_q, role_bits, query_bits,
                      group: int = 128, metric: str = "l2",
                      score_shift: int = 0, mask_sub_block: int = 0,
                      slot_tile: int = 0) -> torch.Tensor:
    """(n_groups, Q) int32 packed group minima.

    queries_q (Q, d_pad) int8, vectors_q (Npad, d_pad) int8, norms_q (Npad,)
    int32, role_bits (Npad, W) int32, query_bits (Q, W) int32 per-query
    masks, or with mask_sub_block = sb > 0 (Q / sb, W) slot masks read as
    slot_of_query(Q, sb, slot_tile) says. Rows wider than 256 go to
    int8_group_minima_wide (the reference's `wide` rule). Otherwise CPU
    tensors take the plain version and CUDA tensors launch
    csrc/scan_int8.cu (the slot form counts under "scan_int8" and
    "scan_int8_slots")."""
    if queries_q.shape[1] > NARROW_MAX_D:
        return int8_group_minima_wide(queries_q, vectors_q, norms_q,
                                      role_bits, query_bits, group, metric,
                                      score_shift, mask_sub_block, slot_tile)
    if queries_q.device.type == "cpu":
        return int8_group_minima_plain(queries_q, vectors_q, norms_q,
                                       role_bits, query_bits, group, metric,
                                       score_shift, mask_sub_block, slot_tile)
    _check_scan_args(queries_q, vectors_q, norms_q, role_bits, query_bits,
                     group, mask_sub_block, slot_tile)
    nq, d_pad = queries_q.shape
    npad, w = vectors_q.shape[0], role_bits.shape[1]
    if d_pad not in (128, 256):
        raise ValueError(f"d_pad {d_pad}: the narrow scan takes d_pad 128 or "
                         "256")
    tensors = (queries_q, vectors_q, norms_q, role_bits, query_bits)
    _check_kernel_tensors(tensors, w)
    out = torch.empty((npad // group, nq), dtype=torch.int32,
                      device=queries_q.device)
    err = _build.lib().vsr_scan_int8(
        *(t.data_ptr() for t in tensors), out.data_ptr(), nq, npad, d_pad, w,
        group, int(metric == "l2"), score_shift, mask_sub_block, slot_tile,
        _build.stream_ptr(queries_q.device))
    _build.check(err, "vsr_scan_int8")
    _build.LAUNCHES["scan_int8"] += 1
    if mask_sub_block:
        _build.LAUNCHES["scan_int8_slots"] += 1
    return out


def int8_masked_topk(
    queries_q: torch.Tensor,    # (Q, d_pad) int8 quantized queries
    query_norms,                # (Q,) int32 ||q_q||^2 (l2); None for ip
    vectors_q: torch.Tensor,    # (Npad, d_pad) int8
    norms_q: torch.Tensor,      # (Npad,) int32
    role_bits: torch.Tensor,    # (Npad, W) int32 view of the uint32 bitsets
    query_bits: torch.Tensor,   # (Q, W) int32 user masks
    inv_scale_sq,               # float 1 / scale^2, or (Q,) float32 per query
    k: int,
    group: int = 128,
    merge: str = "kernel",      # one of MERGES: "kernel" (merge.cu, the
                                # counterpart of the reference's "pallas"),
                                # "cascade", "approx", "auto", "exact"
    metric: str = "l2",         # the kernel metric: "l2" | "ip"
    score_shift: int = 0,
    query_bias=None,            # (Q,) float32 added to ip distances
    mask_sub_block: int = 0,    # admit-dedup slot width (0: per-query masks)
    slot_tile: int = 0,         # 0: contiguous slots; else interleaved
                                # within tiles of slot_tile queries
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (dists (Q, k) float32 ascending, idx (Q, k) int32 arena rows;
    -1 / +inf on empty slots)."""
    packed = int8_group_minima(queries_q, vectors_q, norms_q, role_bits,
                               query_bits, group, metric, score_shift,
                               mask_sub_block, slot_tile)
    return merge_group_minima(packed, query_norms, inv_scale_sq, k, group,
                              merge, metric, score_shift, query_bias)


def smallest_k(keys: torch.Tensor, k: int):
    """(vals, pos) of the k smallest entries of each row of (Q, n) int32
    keys, ascending, equal keys lower position first: lax.top_k's order on
    the negated keys. A stable sort, not torch.topk, whose tie order is
    unspecified."""
    srt, order = torch.sort(keys, dim=1, stable=True)
    return srt[:, :k], order[:, :k].to(torch.int32)


def cascade_topk(mins: torch.Tensor, k: int, t: int, sub: int = 128):
    """The reference's cascade over (Q, n_groups) minima: the t smallest of
    each subgroup of `sub` groups, then the k smallest of those survivors
    (pallas_scan_int8.py:235-252, the round-3 lab's cascade_topk). Misses a
    true top-k entry only where more than t of them share a subgroup.
    Returns ((Q, k) values, (Q, k) int32 group positions)."""
    nq, ng = mins.shape
    if ng % sub:
        raise ValueError(f"{ng} groups do not split into subgroups of {sub}")
    sv, sp = torch.sort(mins.reshape(nq, ng // sub, sub), dim=2, stable=True)
    base = torch.arange(0, ng, sub, dtype=torch.int32,
                        device=mins.device)[None, :, None]
    cand_pos = (sp[:, :, :t].to(torch.int32) + base).reshape(nq, -1)
    vals, sel = smallest_k(sv[:, :, :t].reshape(nq, -1), k)
    return vals, cand_pos.gather(1, sel.long())


MERGES = ("kernel", "cascade", "approx", "auto", "exact")


def merge_group_minima(packed, query_norms, inv_scale_sq, k, group, merge,
                       metric, score_shift=0, query_bias=None):
    """(n_groups, Q) packed minima -> (dists (Q, k), idx (Q, k)): the
    reference's _merge_group_minima, merge by merge:

    - "kernel": the merge kernels (ops/merge.py merge_topk); shapes their
      gate refuses take the cascade, as the reference's "pallas" does;
    - "cascade": cascade_topk with t = min(24, max(k // 4 + 4, 8)) over
      subgroups of 128, from 2048 groups up; the exact merge below that;
    - "exact": the k smallest of all groups;
    - "approx" and "auto": the exact merge. The reference's approx takes
      the k smallest of approx_min_k's 2k, and its auto picks approx above
      32,768 groups; selected exactly, as JAX does on the CPU, the k
      smallest of the 2k smallest are the k smallest.
    Ties go to the lower position at every stage, as lax.top_k's do.

    The decode, as the reference's: l2 gives (score + ||q||^2) * inv,
    clamped at 0; ip gives score * inv. `inv_scale_sq` is one float (l2:
    1 / scale^2) or a (Q,) float32 tensor (ip/cosine: every query keeps its
    own int8 scale, core.ArenaQuant.quantize_queries_ip); `query_bias`
    (Q,) is then added (the corpus center's share of -q.x, and cosine's +1).
    """
    n_groups, nq = packed.shape
    if metric not in ("l2", "ip"):
        raise ValueError(f"kernel metric {metric!r}: the int8 scan scores l2 "
                         "or ip (cosine rides ip)")
    if merge not in MERGES:
        raise ValueError(f"merge {merge!r} is not one of {MERGES}")
    if torch.is_tensor(inv_scale_sq):
        if inv_scale_sq.shape != (nq,):
            raise ValueError(f"per-query inv {tuple(inv_scale_sq.shape)} for "
                             f"{nq} queries")
        inv2 = inv_scale_sq[:, None]
    else:
        # a Python scalar, not a device tensor: building one from host
        # memory is a pageable copy, which waits for the stream's queued
        # kernels
        inv2 = float(inv_scale_sq)
    if query_bias is not None and query_bias.shape != (nq,):
        raise ValueError(f"query_bias {tuple(query_bias.shape)} for {nq} "
                         "queries")
    if merge == "kernel" and not merge_supported(n_groups, k):
        merge = "cascade"
    if merge == "kernel":
        vals, pos = merge_topk(packed, k)
    elif merge == "cascade" and n_groups >= 2048:
        vals, pos = cascade_topk(packed.T, k, min(24, max(k // 4 + 4, 8)))
    else:
        vals, pos = smallest_k(packed.T, k)
    idx = pos * group + (vals & LANE_MASK)
    score = vals >> 7                                    # arithmetic
    if score_shift:
        score = score << score_shift
    empty = vals >= EMPTY_I32
    if metric == "l2":
        dists = torch.clamp_min(
            (score + query_norms[:, None]).to(torch.float32) * inv2, 0.0)
    else:
        dists = score.to(torch.float32) * inv2
    if query_bias is not None:
        dists = dists + query_bias[:, None]
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


WIRES = ("ids", "f32", "bf16", "u8")


def pack_results_device(dists: torch.Tensor, idx: torch.Tensor,
                        id_bits: int = 24, dist: str = "f32") -> torch.Tensor:
    """(Q, k) f32 dists + (Q, k) int32 ids -> one 16-bit wire row per query,
    byte for byte the reference's pack_results_device (the rows come back
    as int16; the host views them as uint16). Empty slots travel as
    dist=+inf, id=0. The distance section by `dist`:

    - "ids": a u16 valid-count header; the host returns rank
      pseudo-distances 0..k-1;
    - "f32": the distances as two u16 halves;
    - "bf16": the distances rounded to bfloat16, to nearest even;
    - "u8": a per-query affine code over the row's own finite span: an f32
      (dmin, range) header as four u16 (the two low halves, then the two
      high ones), then one byte a result, two to a u16, the first in the
      low byte: round((d - dmin) / range * 254) to nearest even, clipped
      to [0, 254], 255 on an empty slot. It needs an even k (the index
      sends an odd k on bf16, as the reference's does).
    Then the ids: a u16 low half each, and their high bits packed
    16 // (id_bits - 16) to a u16."""
    q, k = idx.shape
    if dist not in WIRES:
        raise ValueError(f"wire {dist!r} is not one of {WIRES}")
    hi_bits, per, n_hi = _hi_pack_geometry(k, id_bits)
    empty = ~torch.isfinite(dists)
    idc = torch.where(empty, 0, idx.to(torch.int32))
    if dist == "ids":
        d16 = (~empty).sum(dim=1, dtype=torch.int32)[:, None]
    elif dist == "f32":
        d32 = dists.contiguous().view(torch.int32)
        d16 = torch.cat([d32 & 0xFFFF, (d32 >> 16) & 0xFFFF], dim=1)
    elif dist == "bf16":
        # torch's float32 -> bfloat16 conversion rounds to nearest even
        d16 = dists.to(torch.bfloat16).view(torch.int16).to(torch.int32) \
            & 0xFFFF
    else:
        if k % 2:
            raise ValueError(f"the u8 wire needs an even k, not {k}")
        inf = torch.full((), torch.inf, dtype=dists.dtype,
                         device=dists.device)
        dmin = torch.where(empty, inf, dists).amin(dim=1)
        dmax = torch.where(empty, -inf, dists).amax(dim=1)
        dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
        rng = torch.clamp_min(
            torch.where(torch.isfinite(dmax), dmax, 0.0) - dmin, 1e-9)
        # the reference's order of operations: subtract, divide, scale;
        # torch.round rounds half to even, as jnp.round does
        du = torch.clamp(torch.round((dists - dmin[:, None]) / rng[:, None]
                                     * 254.0), 0, 254).to(torch.int32)
        du = torch.where(empty, 255, du)
        hdr = torch.stack([dmin, rng], dim=1).view(torch.int32)  # (Q, 2)
        d16 = torch.cat([hdr & 0xFFFF, (hdr >> 16) & 0xFFFF,
                         du[:, 0::2] | (du[:, 1::2] << 8)], dim=1)
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
    """Inverse of pack_results_device on the host (numpy): the reference's
    unpack_results_host. u8 distances come back as dmin + code / 254 *
    range (within half a code step of the packed distance)."""
    if dist not in WIRES:
        raise ValueError(f"wire {dist!r} is not one of {WIRES}")
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
    elif dist == "bf16":
        # bf16 -> f32: the bf16 bit pattern is the high half of the f32 one
        d = (a[:, :k].astype(np.uint32) << 16).view(np.float32)
        empty = ~np.isfinite(d)
        off = k
    elif dist == "u8":
        hdr = (a[:, :2].astype(np.uint32)
               | (a[:, 2:4].astype(np.uint32) << 16)).view(np.float32)
        dmin, rng = hdr[:, 0], hdr[:, 1]
        pd = a[:, 4:4 + k // 2]
        du = np.empty((a.shape[0], k), np.uint16)
        du[:, 0::2] = pd & 0xFF
        du[:, 1::2] = pd >> 8
        d = dmin[:, None] + du.astype(np.float32) / 254.0 * rng[:, None]
        empty = du == 255
        off = 4 + k // 2
    else:
        d = (a[:, :k].astype(np.uint32)
             | (a[:, k:2 * k].astype(np.uint32) << 16)).view(np.float32)
        empty = ~np.isfinite(d)
        off = 2 * k
    idx = a[:, off:off + k].astype(np.int32)
    if hi_bits:
        packed_hi = a[:, off + k:off + k + n_hi]           # (Q, n_hi)
        reps = np.repeat(packed_hi, per, axis=1)[:, :k]
        shifts = np.tile(np.arange(per, dtype=np.uint16) * hi_bits,
                         n_hi)[:k][None, :]
        idx |= ((reps >> shifts) & ((1 << hi_bits) - 1)).astype(np.int32) << 16
    return np.where(empty, np.inf, d), np.where(empty, -1, idx)

