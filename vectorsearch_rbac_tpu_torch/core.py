"""The corpus, its int8 quantization, and the device arena.

Counterpart of vectorsearch_rbac_tpu/core.py. The host half (`Corpus`,
`pad_rows`, `score_shift_for`, `quantize_corpus`, the query quantizers and
the cosine normalization at ingest) is a copy of the reference's numpy
code, so that the port runs where the JAX package is absent;
tests/test_torch_host.py holds it equal to the reference. The device half
(`DeviceArena`, `build_device_arena`, the augmented layout's
`augment_with_norms` and `augment_queries`) puts the tensors on an
explicit torch device. Row deletes come in two phases, as in the
reference: `tombstone_rows` zeroes the rows' role bitsets (every scan's
permission test then rejects them), `compact_corpus` drops them from the
corpus for a rebuild. The arena holds no augmented layout (the
reference's `vectors_aug`): FlatIndex builds it in approx mode, the one
scan that reads it (index/flat.py).

An arena stores its rows as float32, bfloat16 (pgvector's halfvec) or
int8 with a bfloat16 mirror, for squared L2, negative inner product,
cosine distance or l1 (the sum of |x - q|; not on int8 arenas, as in the
reference).

Role bitsets stay (Npad, W) on the device as an int32 view of the uint32
words (torch's uint32 support for bitwise ops is thin). The int8 role
one-hot the TPU kernel multiplies is not kept: the CUDA scan ANDs the
bitsets directly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from .rbac import RBACWorld


@dataclass(frozen=True)
class Corpus:
    """Host corpus: (N, d) float32 vectors plus the (doc_id, block_id) of
    every row. A document owns one or more rows ("blocks")."""

    vectors: np.ndarray    # (N, d) float32
    doc_ids: np.ndarray    # (N,) int32, 0-based document index
    block_ids: np.ndarray  # (N,) int32, block index within the document

    def __post_init__(self):
        n = self.vectors.shape[0]
        if self.vectors.ndim != 2 or self.doc_ids.shape != (n,) \
                or self.block_ids.shape != (n,):
            raise ValueError("Corpus takes (N, d) vectors and (N,) id columns")

    @property
    def n(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @cached_property
    def num_docs(self) -> int:
        return int(self.doc_ids.max()) + 1 if self.n else 0

    @cached_property
    def avg_blocks_per_doc(self) -> float:
        return self.n / max(1, self.num_docs)

    @cached_property
    def doc_row_index(self) -> np.ndarray:
        """Row ids ordered by doc id (stable): document d owns
        doc_row_index[offs[d]:offs[d + 1]]."""
        return np.argsort(self.doc_ids, kind="stable")

    @cached_property
    def doc_row_offsets(self) -> np.ndarray:
        """(num_docs + 1,) int64: document d owns offs[d + 1] - offs[d]
        rows."""
        counts = np.bincount(self.doc_ids, minlength=self.num_docs)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def rows_for_docs(self, doc_ids: np.ndarray) -> np.ndarray:
        """All row ids of the given documents, sorted."""
        order, offs = self.doc_row_index, self.doc_row_offsets
        parts = [order[offs[d]:offs[d + 1]]
                 for d in np.asarray(doc_ids, dtype=np.int64)]
        if not parts:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.concatenate(parts))

    def vector_role_bits(self, world: RBACWorld) -> np.ndarray:
        """(N, W) uint32 role bitset of every row, from its document's."""
        return world.doc_role_bits[self.doc_ids]


def pad_rows(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


def score_shift_for(d_pad: int, qclip: int) -> int:
    """The right shift that keeps the packed (score << 7 | lane) epilogue
    in range: the smallest s with (3 * d_pad * qclip^2) >> s < 2^23, the
    bound on |score| for components clipped to [-qclip, qclip]. 0 at
    d_pad 128; 3 at d_pad 768."""
    worst = 3 * d_pad * qclip * qclip
    s = 0
    while (worst >> s) >= (1 << 23):
        s += 1
    return s


_QUANT_ROWS = 65536   # quantize_corpus works in row chunks of this size


def quantize_corpus(vectors: np.ndarray, npad: int):
    """Symmetric int8 quantization. Returns (x_q (npad, d_pad) int8,
    norms (npad,) int32 ||x_q||^2, scale, center (d,), lossless, qclip).
    Integer-valued corpora in [0, 255] (the SIFT family) take center 128
    and scale 1, which is exact.

    Every step after the column range is row-local, so the port runs it in
    row chunks: the same output as the reference's whole-array code, with
    host temporaries of one chunk instead of several corpus-sized ones (the
    reference's int64 copy alone is 6.3 GB at 1M x 768)."""
    n, d = vectors.shape
    d_pad = ((d + 127) // 128) * 128
    lo = vectors.min(axis=0) if n else np.zeros(d, np.float32)
    hi = vectors.max(axis=0) if n else np.ones(d, np.float32)
    center = ((lo + hi) / 2.0).astype(np.float32)
    span = float(np.max(hi - center)) or 1.0
    is_int_valued = bool(
        n and np.all(lo >= 0) and np.all(hi <= 255)
        and np.allclose(vectors[:min(n, 4096)],
                        np.rint(vectors[:min(n, 4096)])))
    if is_int_valued:
        center = np.full(d, 128.0, dtype=np.float32)
        scale, lossless, qclip = 1.0, True, 128
    else:
        qclip = 127
        scale, lossless = qclip / span, False
    xq, norms = quantize_rows(vectors, scale, center, qclip, npad)
    return xq, norms, scale, center, lossless, qclip


def quantize_rows(vectors: np.ndarray, scale: float, center: np.ndarray,
                  qclip: int, npad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Rows quantized with given parameters (quantize_corpus's, or a
    corpus's global ones applied to one slice of it): (x_q (npad, d_pad)
    int8, norms (npad,) int32 ||x_q||^2), rows past len(vectors) zero."""
    n, d = vectors.shape
    d_pad = ((d + 127) // 128) * 128
    xq = np.zeros((npad, d_pad), dtype=np.int8)
    norms = np.zeros(npad, dtype=np.int32)
    for r0 in range(0, n, _QUANT_ROWS):
        r1 = min(r0 + _QUANT_ROWS, n)
        xs = (vectors[r0:r1] - center[None, :]) * scale
        xq[r0:r1, :d] = np.clip(np.rint(xs), -qclip,
                                min(qclip, 127)).astype(np.int8)
        x64 = xq[r0:r1].astype(np.int64)
        norms[r0:r1] = np.einsum("nd,nd->n", x64, x64).astype(np.int32)
    return xq, norms


@dataclass(frozen=True)
class ArenaQuant:
    """Symmetric int8 quantization of the arena: x_q = round((x - center)
    * scale) clipped to qclip, exact for SIFT-family corpora (center 128,
    scale 1)."""

    vectors_q: torch.Tensor   # (Npad, d_pad) int8
    norms_q: torch.Tensor     # (Npad,) int32 ||x_q||^2
    scale: float
    center: np.ndarray        # (d,) float32
    lossless: bool
    qclip: int = 127

    @property
    def d_pad(self) -> int:
        return self.vectors_q.shape[1]

    @property
    def score_shift(self) -> int:
        return score_shift_for(self.d_pad, self.qclip)

    def quantize_queries(self, q: np.ndarray, with_norms: bool = True
                         ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(Q, d) float32 -> ((Q, d_pad) int8, (Q,) int32 ||q_q||^2 or
        None), on the host, with the arena's center, scale and clip."""
        qs = (np.asarray(q, dtype=np.float32) - self.center[None, :]) \
            * self.scale
        qq = np.clip(np.rint(qs), -self.qclip,
                     min(self.qclip, 127)).astype(np.int8)
        if qq.shape[1] < self.d_pad:
            qq = np.concatenate([qq, np.zeros(
                (qq.shape[0], self.d_pad - qq.shape[1]), np.int8)], axis=1)
        if not with_norms:
            return qq, None
        q64 = qq.astype(np.int64)
        return qq, np.einsum("qd,qd->q", q64, q64).astype(np.int32)

    def quantize_queries_ip(self, q: np.ndarray, cosine: bool = False
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ip/cosine query quantization. Returns (q8 (Q, d_pad) int8, inv
        (Q,) float32, bias (Q,) float32) such that the kernel's -q8.x8 score
        times inv[q] plus bias[q] is the metric's distance. Every query
        keeps its own scale (one outlier component would otherwise coarsen
        a whole batch's codes); the corpus center contributes the constant
        -q.center, folded into bias, and cosine normalizes q first and adds
        the +1 of 1 - cos."""
        qf = np.asarray(q, dtype=np.float32)
        if cosine:
            qf = qf / np.maximum(
                np.linalg.norm(qf, axis=1, keepdims=True), 1e-30)
        clip = min(self.qclip, 127)
        qs = clip / np.maximum(np.max(np.abs(qf), axis=1), 1e-30)  # (Q,)
        qq = np.clip(np.rint(qf * qs[:, None]), -self.qclip,
                     clip).astype(np.int8)
        if qq.shape[1] < self.d_pad:
            qq = np.concatenate([qq, np.zeros(
                (qq.shape[0], self.d_pad - qq.shape[1]), np.int8)], axis=1)
        inv = (1.0 / (qs * self.scale)).astype(np.float32)
        bias = -(qf @ self.center.astype(np.float64)).astype(np.float32)
        if cosine:
            bias = bias + 1.0
        return qq, inv, bias

    def query_residual8(self, q: np.ndarray, q8: np.ndarray,
                        inv: np.ndarray, cosine: bool = False) -> np.ndarray:
        """(Q, d) float queries and their int8 codes -> (Q, d_pad) int8
        residual codes r8 = round((q * qs - q8) * 254), from which the
        device rebuilds a ~16-bit fixed-point query (q8 + r8 / 254) / qs."""
        qf = np.asarray(q, dtype=np.float32)
        if cosine:
            qf = qf / np.maximum(
                np.linalg.norm(qf, axis=1, keepdims=True), 1e-30)
        # qs from quantize_queries_ip: inv = 1 / (qs * scale)
        qs = 1.0 / (np.asarray(inv, dtype=np.float32) * self.scale)
        d = qf.shape[1]
        r = qf * qs[:, None] - q8[:, :d].astype(np.float32)
        r8 = np.clip(np.rint(r * 254.0), -127, 127).astype(np.int8)
        if d < q8.shape[1]:
            r8 = np.concatenate(
                [r8, np.zeros((r8.shape[0], q8.shape[1] - d), np.int8)],
                axis=1)
        return r8

    def query_residual4(self, q: np.ndarray, q8: np.ndarray,
                        inv: np.ndarray, cosine: bool = False) -> np.ndarray:
        """Nibble-packed residual codes: (Q, d_pad // 2) uint8, each byte
        two 4-bit codes (component 2j in the low nibble, 2j+1 in the high),
        code = clip(round(r * 15), -8, 7) + 8 with r = q * qs - q8 in
        [-0.5, 0.5]. The device rebuilds q8 + (code - 8) / 15, a ~12-bit
        query at half the residual8 codes' bytes."""
        qf = np.asarray(q, dtype=np.float32)
        if cosine:
            qf = qf / np.maximum(
                np.linalg.norm(qf, axis=1, keepdims=True), 1e-30)
        qs = 1.0 / (np.asarray(inv, dtype=np.float32) * self.scale)
        d = qf.shape[1]
        d_pad = q8.shape[1]
        r = qf * qs[:, None] - q8[:, :d].astype(np.float32)
        code = (np.clip(np.rint(r * 15.0), -8, 7) + 8).astype(np.uint8)
        if d < d_pad:
            code = np.concatenate(
                [code, np.full((code.shape[0], d_pad - d), 8, np.uint8)],
                axis=1)
        return (code[:, 0::2] | (code[:, 1::2] << 4)).astype(np.uint8)


@dataclass(frozen=True)
class DeviceArena:
    """Device-resident arena padded to a block multiple. Padding rows have
    zero role bits, so every query rejects them."""

    vectors: torch.Tensor     # (Npad, d) float32 or bfloat16 (the int8
                              # arenas' mirror is bfloat16)
    norms: torch.Tensor       # (Npad,) float32 squared L2 norms
    role_bits: torch.Tensor   # (Npad, W) int32 view of the uint32 bitsets
    n: int
    doc_ids: np.ndarray
    block_ids: np.ndarray
    host_bits: np.ndarray     # (Npad, W) uint32 host mirror of role_bits
    quant: Optional[ArenaQuant] = None
    # "l2" squared L2, "ip" negative inner product, "cosine" 1 - cos (the
    # rows are L2-normalized at ingest, so cosine scores on the ip path),
    # "l1" the sum of |x - q|
    metric: str = "l2"
    # (Npad, d) float32 host mirror of the full-precision rows (cosine rows
    # normalized): the HNSW builders and the binary index read it, as the
    # reference's do; host_norms its (Npad,) squared norms
    host_vectors: Optional[np.ndarray] = None
    host_norms: Optional[np.ndarray] = None

    @property
    def n_padded(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.vectors.device


def _put(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _bits_tensor(bits: np.ndarray, device) -> torch.Tensor:
    return _put(np.ascontiguousarray(bits, dtype=np.uint32).view(np.int32),
                device)


METRICS = ("l2", "ip", "cosine", "l1")
_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.bfloat16}   # int8 arenas keep a bfloat16 mirror


def augment_with_norms(vecs: torch.Tensor, norms: torch.Tensor
                       ) -> torch.Tensor:
    """(N, d) float32 rows and their (N,) float32 squared norms -> (N,
    d_aug) float32 [x | norm_hi | norm_lo | 0-pad to 8], so that a query
    row [-2q | 1 | 1 | 0] dotted with it gives ||x||^2 - 2 q.x in one
    product. hi is the norm rounded to bfloat16 and lo the rest: a
    bfloat16 arena keeps ~1e-5 relative norm precision (bfloat16 alone
    has ~0.4%, enough to reorder close neighbours). The reference's
    numpy function, on tensors."""
    n, d = vecs.shape
    hi = norms.to(torch.bfloat16).to(torch.float32)
    d_aug = ((d + 2 + 7) // 8) * 8
    out = torch.zeros((n, d_aug), dtype=torch.float32, device=vecs.device)
    out[:, :d] = vecs
    out[:, d] = hi
    out[:, d + 1] = norms - hi
    return out


def augment_queries(q: torch.Tensor, d_aug: int, metric: str = "l2"
                    ) -> torch.Tensor:
    """(Q, d) float32 queries -> (Q, d_aug) [w_q q | w | w | 0-pad], the
    query side of augment_with_norms: [-2q | 1 | 1 | 0] for l2 (the
    reference's augment_queries), [-q | 0 | 0 | 0] for ip and cosine,
    whose scores drop the norm term."""
    nq, d = q.shape
    l2 = metric == "l2"
    out = torch.zeros((nq, d_aug), dtype=torch.float32, device=q.device)
    out[:, :d] = (-2.0 if l2 else -1.0) * q
    out[:, d:d + 2] = 1.0 if l2 else 0.0
    return out


def _assemble(vecs, norms, bits, n, doc_ids, block_ids, quant_parts,
              metric, device, store: torch.dtype) -> DeviceArena:
    quant = None
    if quant_parts is not None:
        xq, nq_, scale, center, lossless, qclip = quant_parts
        quant = ArenaQuant(
            vectors_q=_put(xq, device), norms_q=_put(nq_, device),
            scale=float(scale), center=np.asarray(center, np.float32),
            lossless=bool(lossless), qclip=int(qclip))
    return DeviceArena(
        vectors=_put(vecs, device).to(store), norms=_put(norms, device),
        role_bits=_bits_tensor(bits, device),
        n=int(n), doc_ids=doc_ids, block_ids=block_ids, host_bits=bits,
        quant=quant, metric=metric, host_vectors=vecs, host_norms=norms)


def build_device_arena(corpus: Corpus, world: RBACWorld, *, device,
                       block_rows: int = 16384, dtype: str = "float32",
                       metric: str = "l2") -> DeviceArena:
    """Upload the corpus once, padded to pad_rows(n, block_rows) rows.
    dtype "float32" | "bfloat16" stores the rows so; "int8" adds the
    quantized serving copy (ArenaQuant) beside a bfloat16 mirror. metric
    "l2" | "ip" | "cosine" | "l1"; cosine rows are L2-normalized here,
    once."""
    if dtype not in _STORE:
        raise ValueError(f"arena dtype {dtype!r}: one of {tuple(_STORE)}")
    if metric not in METRICS:
        raise ValueError(f"metric {metric!r}: one of {METRICS}")
    if dtype == "int8" and metric == "l1":
        # the reference's rule (core.py build_device_arena)
        raise ValueError("l1 cannot ride the int8 path (it has no dot-"
                         "product form); use dtype float32 or bfloat16")
    n, d = corpus.n, corpus.dim
    npad = pad_rows(max(n, 1), block_rows)
    vecs = np.zeros((npad, d), dtype=np.float32)
    vecs[:n] = corpus.vectors
    if metric == "cosine" and n:
        nrm = np.linalg.norm(vecs[:n], axis=1, keepdims=True)
        vecs[:n] /= np.maximum(nrm, 1e-30)
    norms = np.zeros(npad, dtype=np.float32)
    norms[:n] = np.einsum("nd,nd->n", vecs[:n], vecs[:n], dtype=np.float64)
    bits = np.zeros((npad, world.words), dtype=np.uint32)
    bits[:n] = corpus.vector_role_bits(world)
    quant_parts = quantize_corpus(vecs[:n], npad) if dtype == "int8" else None
    return _assemble(vecs, norms, bits, n, corpus.doc_ids, corpus.block_ids,
                     quant_parts, metric, device, _STORE[dtype])


def build_packed_graph_rows(arena: DeviceArena,
                            rows: Optional[np.ndarray] = None,
                            n_pad: int = 0) -> torch.Tensor:
    """(Npad, d_pad + 4W + 4) int8 device table for the packed-row graph
    step (ops/graph_search.py packed mode): [int8 code | W uint32 bitset
    words | f32 squared norm of the dequantized row], 148 bytes at SIFT
    shape. One row gather brings a candidate's vector, permissions and
    norm. `rows`: the table of those arena rows only, in their order, with
    zero rows after them up to n_pad (a physical HNSW partition's own copy,
    addressed by local id); the whole arena otherwise.

    The reference's row (core.py build_packed_graph_rows) carries the
    128-lane int8 role one-hot its TPU kernel multiplies, 260 bytes; this
    row carries the bitset words K1 already ANDs, for the same predicate.
    The norm is the reference's: the float32 sum over the dequantized row
    (vq / scale + center), computed on the host in row chunks (row-local,
    so the same float32 values), zero on pad rows."""
    q = arena.quant
    if q is None:
        raise ValueError("packed graph rows need the int8 quantized arena")
    codes, bits, n = q.vectors_q, arena.role_bits, arena.n
    if rows is not None:
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(arena.device)
        codes, bits, n = codes[idx], bits[idx], len(idx)
    vq = codes.cpu().numpy()
    d = len(q.center)
    nrm = np.zeros(vq.shape[0], np.float32)
    for r0 in range(0, n, _QUANT_ROWS):
        r1 = min(r0 + _QUANT_ROWS, n)
        v = vq[r0:r1, :d].astype(np.float32) / q.scale + q.center[None, :]
        nrm[r0:r1] = (v * v).sum(1, dtype=np.float32)
    table = torch.cat([codes, bits.contiguous().view(torch.int8),
                       _put(nrm.view(np.int8).reshape(-1, 4), arena.device)],
                      dim=1)
    if n_pad > table.shape[0]:
        table = torch.cat([table, table.new_zeros(
            (n_pad - table.shape[0], table.shape[1]))])
    return table.contiguous()


def packed_query_operands(arena: DeviceArena, queries: np.ndarray
                          ) -> Tuple[float, np.ndarray]:
    """Per-query operands for packed-row graph scoring: (dq_scale,
    q_center_dot (Q,) float32) with dots = (q . vq) * dq_scale + q . center
    (the reference's packed_query_operands)."""
    q = arena.quant
    qf = np.asarray(queries, dtype=np.float32)
    if arena.metric == "cosine":
        qf = qf / np.maximum(
            np.linalg.norm(qf, axis=1, keepdims=True), 1e-30)
    return 1.0 / q.scale, (qf @ q.center).astype(np.float32)


def tombstone_rows(arena: DeviceArena, rows: np.ndarray) -> DeviceArena:
    """Row delete, phase 1 (pgvector's delete before vacuum): a new arena
    whose `rows` have zero role bitsets, on the device and in host_bits,
    sharing every other buffer with `arena` (which keeps its bits). Pad
    rows already carry zero bits, so every scan and graph admit test
    rejects a tombstoned row with no new branch. Engines that copied the
    bits before (the chunk engine's chunks, the IVF lists, a graph slab's
    packed rows) serve the old bits until they are rebuilt, as an index
    serves deleted tuples until VACUUM; the arena-backed paths see the
    tombstone at once. The int8 one-hots the reference also zeroes are
    not kept in the port (see the module docstring)."""
    rows = np.asarray(rows, dtype=np.int64)
    bits = np.array(arena.host_bits)
    bits[rows] = 0
    role_bits = arena.role_bits.clone()
    role_bits[torch.from_numpy(rows).to(role_bits.device)] = 0
    return replace(arena, role_bits=role_bits, host_bits=bits)


def compact_corpus(corpus: Corpus, deleted: np.ndarray
                   ) -> Tuple[Corpus, np.ndarray]:
    """Row delete, phase 2 (VACUUM): (the corpus without the deleted rows,
    remap) with remap[old row] the new row, or -1 for a deleted one.
    Rebuild the arena and indexes from the new corpus and carry persisted
    row ids through remap."""
    deleted = np.asarray(deleted, dtype=np.int64)
    keep = np.ones(corpus.n, dtype=bool)
    keep[deleted] = False
    remap = np.full(corpus.n, -1, dtype=np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    return Corpus(vectors=np.ascontiguousarray(corpus.vectors[keep]),
                  doc_ids=np.ascontiguousarray(corpus.doc_ids[keep]),
                  block_ids=np.ascontiguousarray(corpus.block_ids[keep])
                  ), remap


def arena_from_reference(ref, device) -> DeviceArena:
    """Build the port's arena from a reference DeviceArena's numpy mirrors
    (host_vectors, host_norms, host_bits and the quant's host_vectors_q,
    host_norms_q, scale, center, lossless, qclip), in the reference's
    storage dtype, so that both packages compute on the same state."""
    q = ref.quant
    quant_parts = None if q is None else (
        q.host_vectors_q, q.host_norms_q, q.scale, q.center, q.lossless,
        q.qclip)
    store = (torch.bfloat16 if str(ref.vectors.dtype) == "bfloat16"
             else torch.float32)
    return _assemble(ref.host_vectors, ref.host_norms, ref.host_bits, ref.n,
                     ref.doc_ids, ref.block_ids, quant_parts, ref.metric,
                     device, store)
