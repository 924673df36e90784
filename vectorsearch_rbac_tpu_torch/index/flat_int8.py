"""Int8 flat index: the quantized fused-scan serving path.

Counterpart of vectorsearch_rbac_tpu/index/flat_int8.py `Int8FlatIndex`,
over the whole arena (the RLS strategy) or over a subset of its rows (a
partition of the partitioned strategies): int8 distances and the bitset
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
wire's id width from the arena's padded row count.

A partition's rows are either gathered once into the index's own tensors,
or (logical=True) kept as a row map and gathered from the shared arena at
the start of every pass. Either way the row count pads to a power-of-two
number of blocks (index/flat.py `_pad_to_bucket`), pad rows get zero
bitset words, which no query admits, and the row map turns local ids into
arena rows before any rerank. The reference's block_rows and q_tile
clamps are kept for what they decide here: block_rows a partition's
padded size, and through it the group width; q_tile admit-dedup's gate.

Admit-dedup (mask_dedup, on by default as in the reference): where a pass
holds few distinct masks, the host groups its queries by mask into slots
of MASK_SB queries, pads each mask's last slot with its first query, and
the scan reads one mask row per slot (the slot form of csrc/scan_int8.cu,
in its contiguous layout: query j reads slot j // MASK_SB, so each
half-warp shares one mask and a warp skips the rows none of its queries
may read). The reference's gate decides when: narrow rows, a tile of at
least 8 slots, at least one tile of queries, and a padded query count at
most 1.25x the unpadded one. The result rows go back to the caller's
order on the device, before they are copied to the host; `_last_dedup`
says whether the last pass grouped.

The result wire is any of the reference's four codings (ids, f32, bf16,
u8; an odd k sends u8 on bf16, as the reference's does). The merge is
`merge`, one of ops/scan_int8.py MERGES: "kernel" (the default, the
reference's "pallas": the merge kernels, and the cascade on a shape their
gate refuses, as the reference's), "cascade", "exact", "approx" or
"auto" (the last two the exact merge, as ops/scan_int8.py says).

The uid wire (`set_user_table`, then `search_deferred(..., user_ids=)`):
the (num_users, W) mask table is resident on the device, a pass uploads
one 2-byte user id a query (or a slot) in place of its 16-byte mask row,
and the device gathers the rows from the table. The table is keyed by a
digest of its content, so a revoked role replaces it at the next
set_user_table (keyed by identity, an in-place revocation would keep
serving the stale table: an RBAC leak). A table of more than 65,536 users
is not kept (a u16 cannot address it), and a pass with a user id outside
the table ships mask rows; both as the reference. Admit-dedup then groups
by the host copy of the table's rows. `_last_uid_wire` says whether the
last pass used the table.

Profiler spans mark the host's share of a pass: flat_int8.user_table
(set_user_table), .masks, .dedup, .quantize_upload (inside it .quantize,
the host quantizer, and .upload, the copies to the device), .enqueue
(inside it each batch's .scan, .merge, .rerank, .wire) and, in finalize(),
.fetch_unpack (inside it .fetch, the wait and the copy back, and .unpack).
A pass counts its queries and the query positions its scan runs
(utils/tracing.py COUNTS: flat_int8.queries, flat_int8.positions).
bench/profile.py and the benchmark's readers read them.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core import DeviceArena
from ..ops.rerank import RERANK_MODES, rebuild_query, rerank_topk
from ..ops.scan_int8 import (MERGES, NARROW_MAX_D, WIRES,
                             int8_group_minima, merge_group_minima,
                             pack_results_device, unpack_results_host)
from ..utils.tracing import count
from .flat import _pad_to_bucket

MAX_GROUP = 128      # rows per packed minimum: the 7-bit lane field
RERANK_MARGIN = 32   # extra scan candidates the rerank starts from
MASK_SB = 16         # admit-dedup slot width (the reference's)
MAX_TABLE_USERS = 65536   # users a 2-byte uid addresses


def dedup_slots(masks: np.ndarray, sb: int, bs: int):
    """Admit-dedup's host grouping (the reference's flat_int8.py:583-616,
    laid out contiguously): queries sorted by mask (lexicographically by
    word, as np.unique orders rows, then by query) fill slots of sb
    positions, a mask's last slot padded with that slot's first query.
    Returns (src, valid): position p holds query src[p], a real result
    where valid[p]; the padded count is a multiple of bs, the tail slots
    repeat query 0 and are discarded. None where the padding would pass
    1.25x the batches the queries fill unpadded (a fragmented mask
    population stays per query). Vectorized: the reference's np.unique
    over rows and per-slot loop took ~17 ms of host time per 8,192
    queries, more than the slot form saves on the card."""
    nq = masks.shape[0]
    order = np.lexsort(masks.T[::-1])        # stable: ties by query
    srt = masks[order]
    new = np.ones(nq, bool)
    new[1:] = (srt[1:] != srt[:-1]).any(axis=1)
    starts = np.flatnonzero(new)             # each mask's first position
    counts = np.diff(np.append(starts, nq))
    n_slots = -(-counts // sb)
    s_tot = int(n_slots.sum())
    npq2 = -(-(s_tot * sb) // bs) * bs
    if npq2 > max(bs, int(1.25 * (-(-nq // bs) * bs))):
        return None
    grp = np.cumsum(new) - 1                 # mask of each sorted position
    slot0 = np.cumsum(n_slots) - n_slots     # each mask's first slot
    rank = np.arange(nq) - starts[grp]
    pos = (slot0[grp] + rank // sb) * sb + rank % sb
    slot_grp = np.repeat(np.arange(len(starts)), n_slots)
    first = starts[slot_grp] + (np.arange(s_tot) - slot0[slot_grp]) * sb
    head = order[first]                      # each slot's first query
    src = np.zeros(npq2, np.int64)
    src[:s_tot * sb] = np.repeat(head, sb)
    src[pos] = order
    valid = np.zeros(npq2, bool)
    valid[pos] = True
    return src, valid


class Int8FlatIndex:
    def __init__(
        self,
        arena: DeviceArena,
        rows: Optional[np.ndarray] = None,   # arena row ids; None = whole
        query_batch: int = 8192,
        q_tile: int = 2048,             # admit-dedup's tile (its gate)
        block_rows: int = 4096,         # a partition pads to a power-of-two
                                        # number of these
        group: int = 128,               # widest group the row count allows
        wire: str = "f32",              # "ids" | "f32" | "bf16" | "u8"
        rerank_mode: Optional[str] = None,  # one of ops.rerank.RERANK_MODES;
                                        # None: "residual4" (ip/cosine) or
                                        # "dequant" (l2) on wide rows,
                                        # "f16" on narrow ones
        logical: bool = False,          # row subsets: gather from the
                                        # shared arena per pass, no copy
        mask_dedup: bool = True,        # admit-dedup (see the module note)
        merge: str = "kernel",          # one of ops.scan_int8.MERGES
    ):
        q = arena.quant
        if q is None:
            raise ValueError("Int8FlatIndex needs an int8-quantized arena")
        if wire not in WIRES:
            raise ValueError(f"wire {wire!r} is not one of {WIRES}")
        if merge not in MERGES:
            raise ValueError(f"merge {merge!r} is not one of {MERGES}")
        if wire == "ids" and rows is not None:
            # rank pseudo-distances cannot be merged across partitions
            raise ValueError(
                "wire='ids' returns rank pseudo-distances and cannot be used "
                "on a partitioned Int8FlatIndex whose results get merged: "
                "use 'u8'/'bf16'/'f32' for partition tiers")
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
        self.merge = merge
        self.mask_dedup = mask_dedup
        self._last_dedup = False
        self._last_uid_wire = False
        self._user_table = self._user_table_host = self._user_table_key = None

        # the reference's tile clamps (flat_int8.py:351-379), kept for the
        # padded partition size (block_rows) and the dedup gate (q_tile);
        # r_pad is the width of the TPU's role one-hots, 128 per 4 words
        self.q_tile = min(q_tile, query_batch)
        self.block_rows = block_rows
        unit = d_pad + 128 * -(-arena.role_bits.shape[1] // 4)
        if self.wide:
            self.block_rows = min(self.block_rows, 2048)
            self.q_tile = min(self.q_tile, 512)
            while (self.block_rows > 512
                   and self.block_rows * self.q_tile * 4 > 4_500_000):
                self.block_rows //= 2
        else:
            while (self.block_rows > 1024
                   and self.block_rows * unit > 3_700_000):
                self.block_rows //= 2
            while self.q_tile > 256 and self.q_tile * unit > 940_000:
                self.q_tile //= 2

        self.logical = logical and rows is not None
        if rows is None:
            self.n_rows = arena.n
            self._row_map = None
            self._rows = (q.vectors_q, q.norms_q, arena.role_bits)
            npad = q.vectors_q.shape[0]
        else:
            rows = np.asarray(rows, dtype=np.int64)
            self.n_rows = len(rows)
            npad = _pad_to_bucket(max(self.n_rows, 1), self.block_rows)
            rmap = np.full(npad, -1, np.int32)
            rmap[:self.n_rows] = rows
            self._row_map = torch.from_numpy(rmap).to(arena.device)
            self._rows = None if self.logical else self._gather()
        # group-min width scales with the padded row count (reference
        # rule): keep >= 8192 groups where it allows, since top-k loses
        # ~C(k,2)*group/npad results to same-group collisions
        fit = npad // 8192
        self.group = (min(group, MAX_GROUP, 1 << (fit.bit_length() - 1))
                      if fit >= 8 else 8)
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

    def _gather(self):
        """The partition's (vectors, norms, bitsets), gathered from the
        shared arena along the row map; pad rows are all zero, and zero
        bitset words admit no query."""
        q, bits = self._quant, self._arena.role_bits
        safe = self._row_map.clamp_min(0)
        vq = q.vectors_q.index_select(0, safe)
        nq = q.norms_q.index_select(0, safe)
        rb = bits.index_select(0, safe)
        n = self.n_rows
        vq[n:] = 0
        nq[n:] = 0
        rb[n:] = 0
        return vq, nq, rb

    def _quantize_host(self, qf: np.ndarray) -> Dict[str, np.ndarray]:
        """The pass's per-query operands on the host, for search_deferred
        to upload once (a pageable copy inside the batch loop would wait
        for the queued kernels): int8 codes, and for ip/cosine the
        per-query scales and biases, plus the rerank mode's codes or
        shipped queries."""
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
        return host

    def set_user_table(self, user_masks: np.ndarray) -> None:
        """Keep the (num_users, W) uint32 mask table on the device, so that
        search_deferred can take 2-byte user ids in place of mask rows.
        Keyed by a digest of the table's content, not its identity: an
        in-place revocation must replace the resident table. A table of
        more than 65,536 users, or not 2-D, drops the resident one, and
        passes ship mask rows."""
        with record_function("flat_int8.user_table"):
            tbl = np.ascontiguousarray(np.asarray(user_masks,
                                                  dtype=np.uint32))
            if tbl.ndim != 2 or tbl.shape[0] > MAX_TABLE_USERS:
                self._user_table = self._user_table_host = None
                self._user_table_key = None
                return
            key = (tbl.shape,
                   hashlib.blake2b(tbl.tobytes(), digest_size=16).digest())
            if self._user_table_key == key:
                return
            self._user_table = torch.from_numpy(tbl.view(np.int32)).to(
                self._arena.device)
            self._user_table_host = tbl   # admit-dedup groups by content
            self._user_table_key = key

    def search_deferred(self, queries: np.ndarray, query_masks, k: int,
                        user_ids: Optional[np.ndarray] = None):
        """Enqueue every batch's scan, merge, rerank and wire pack without
        syncing; returns finalize() -> (dists (Q, k) float32, ids (Q, k)
        int64 arena rows). With the ids wire the dists are rank
        pseudo-distances 0..k-1. With user_ids and a resident user table
        covering them, the masks are the table's rows (query_masks may be
        None); otherwise query_masks (Q, W) are shipped."""
        quant = self._quant
        arena = self._arena
        qf = np.asarray(queries, dtype=np.float32)
        nq0 = qf.shape[0]
        if nq0 == 0:
            return lambda: (np.empty((0, k), np.float32),
                            np.empty((0, k), np.int64))
        tbl = self._user_table_host
        with record_function("flat_int8.masks"):
            use_table = user_ids is not None and tbl is not None
            if use_table:
                uids = np.asarray(user_ids, dtype=np.int64)
                use_table = bool(uids.min() >= 0 and uids.max() < len(tbl))
            if use_table:
                masks = tbl[uids]        # the host copy, for admit-dedup
            elif query_masks is None:
                raise ValueError("no mask rows, and no resident user table "
                                 "covering the user ids")
            else:
                masks = np.ascontiguousarray(query_masks, dtype=np.uint32)
        self._last_uid_wire = use_table
        # the reference's batch and tile for the dedup gate: a pass below
        # one batch runs as one power-of-two batch of at least 32
        bs = min(self.query_batch, max(1 << (nq0 - 1).bit_length(), 32))
        q_tile = min(self.q_tile, bs)
        sb = MASK_SB if (self.mask_dedup and not self.wide) else 0
        plan = None
        with record_function("flat_int8.dedup"):
            if sb and q_tile % sb == 0 and q_tile // sb >= 8 \
                    and bs % q_tile == 0 and nq0 >= q_tile:
                plan = dedup_slots(masks, sb, bs)
            if plan is not None:
                src, valid = plan
                head = src[::sb]                          # one query a slot
                masks = np.ascontiguousarray(masks[head])
                if use_table:
                    uids = uids[head]
        self._last_dedup = plan is not None
        slot_sb = sb if plan is not None else 0
        step = bs if plan is not None else self.query_batch
        with record_function("flat_int8.quantize_upload"):
            # every per-query operand is row-local: quantize the caller's
            # queries once, then lay the codes out in slot order on the
            # device (the reference permutes first; the codes are the same)
            with record_function("flat_int8.quantize"):
                host = self._quantize_host(qf)
            with record_function("flat_int8.upload"):
                ops = {name: torch.from_numpy(np.ascontiguousarray(a)).to(
                    arena.device) for name, a in host.items()}
                if plan is not None:
                    # every position's query, and every query's real
                    # position (the wire rows go back to the caller's order
                    # on the device; pad and tail rows are dropped); both
                    # uploaded here, before the batches are queued
                    where = np.empty(nq0, np.int64)
                    where[src[valid]] = np.flatnonzero(valid)
                    src_d, where_d = (torch.from_numpy(a).to(arena.device)
                                      for a in (src, where))
                    ops = {name: t.index_select(0, src_d)
                           for name, t in ops.items()}
                if use_table:
                    # 2 bytes a query (a slot) up, as u16 bits in an int16;
                    # the mask rows come from the resident table
                    u16 = torch.from_numpy(
                        uids.astype(np.uint16).view(np.int16))
                    uid_d = u16.to(arena.device).to(torch.int32) & 0xFFFF
                    m_d = self._user_table.index_select(0, uid_d)
                else:
                    m_d = torch.from_numpy(masks.view(np.int32)).to(
                        arena.device)
        nq = next(iter(ops.values())).shape[0]
        count("flat_int8.queries", nq0)
        count("flat_int8.positions", nq)
        vq, nrm, bits = self._gather() if self.logical else self._rows
        kk = k + RERANK_MARGIN if self.rerank else k
        inv_l2 = 1.0 / quant.scale**2
        # u8 packs two results to a u16: an odd k goes on bf16 (reference)
        wire = self.wire if self.wire != "u8" or k % 2 == 0 else "bf16"
        wires = []
        with record_function("flat_int8.enqueue"):
            for s in range(0, nq, step):
                b = {name: t[s:s + step] for name, t in ops.items()}
                mb = (m_d[s // slot_sb:(s + step) // slot_sb] if slot_sb
                      else m_d[s:s + step])
                with record_function("flat_int8.scan"):
                    packed = int8_group_minima(
                        b["q8"], vq, nrm, bits, mb, self.group,
                        self._kernel_metric, self.score_shift,
                        mask_sub_block=slot_sb)
                with record_function("flat_int8.merge"):
                    qn = (None if "inv" in b else
                          (b["q8"].to(torch.int32) ** 2).sum(
                              dim=1, dtype=torch.int32))
                    dd, ii = merge_group_minima(
                        packed, qn, b.get("inv", inv_l2), kk, self.group,
                        self.merge, self._kernel_metric, self.score_shift,
                        b.get("bias"))
                if self._row_map is not None:
                    # local -> arena rows BEFORE the rerank, which reads
                    # the arena's full-precision mirror by arena row
                    ii = torch.where(ii < 0, -1, self._row_map.index_select(
                        0, ii.clamp_min(0).reshape(-1)).view(ii.shape))
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
                        dd, ii, id_bits=self._id_bits, dist=wire))

        def finalize():
            with record_function("flat_int8.fetch_unpack"):
                with record_function("flat_int8.fetch"):
                    w = torch.cat(wires)
                    if plan is not None:
                        w = w.index_select(0, where_d)
                    w = w.cpu().numpy()
                with record_function("flat_int8.unpack"):
                    d, i = unpack_results_host(w, k, id_bits=self._id_bits,
                                               dist=wire)
                    return d.astype(np.float32), i.astype(np.int64)

        return finalize

    def search(self, queries, query_masks, k) -> Tuple[np.ndarray, np.ndarray]:
        return self.search_deferred(queries, query_masks, k)()

    def storage_bytes(self) -> Dict[str, int]:
        """The index's own device bytes (the shared arena is counted by the
        searcher): a partition's gathered int8 rows ("vectors") and its
        bitsets, norms and row map ("index"); the row map alone in the
        logical mode."""
        if self._row_map is None:
            return {"vectors": 0, "index": 0}
        rmap = self._row_map.numel() * self._row_map.element_size()
        if self._rows is None:
            return {"vectors": 0, "index": rmap}
        vq, nrm, bits = self._rows
        return {"vectors": vq.numel() * vq.element_size(),
                "index": (nrm.numel() * nrm.element_size()
                          + bits.numel() * bits.element_size() + rmap)}
