"""The corpus, its int8 quantization, and the device arena.

Counterpart of vectorsearch_rbac_tpu/core.py. The host half (`Corpus`,
`pad_rows`, `score_shift_for`, `quantize_corpus` and the query quantizer)
is a copy of the reference's numpy code, so that the port runs where the
JAX package is absent; tests/test_torch_host.py holds it equal to the
reference. The device half (`DeviceArena`, `build_device_arena`) puts the
tensors on an explicit torch device.

Role bitsets stay (Npad, W) on the device as an int32 view of the uint32
words (torch's uint32 support for bitwise ops is thin). The int8 role
one-hot the TPU kernel multiplies is not kept: the CUDA scan ANDs the
bitsets directly.
"""

from __future__ import annotations

from dataclasses import dataclass
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
    def doc_row_offsets(self) -> np.ndarray:
        """(num_docs + 1,) int64: document d owns offs[d + 1] - offs[d]
        rows."""
        counts = np.bincount(self.doc_ids, minlength=self.num_docs)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

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


def quantize_corpus(vectors: np.ndarray, npad: int):
    """Symmetric int8 quantization. Returns (x_q (npad, d_pad) int8,
    norms (npad,) int32 ||x_q||^2, scale, center (d,), lossless, qclip).
    Integer-valued corpora in [0, 255] (the SIFT family) take center 128
    and scale 1, which is exact."""
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
    xq = np.zeros((npad, d_pad), dtype=np.int8)
    xs = (vectors - center[None, :]) * scale
    xq[:n, :d] = np.clip(np.rint(xs), -qclip, min(qclip, 127)).astype(np.int8)
    norms = np.zeros(npad, dtype=np.int32)
    x64 = xq[:n].astype(np.int64)
    norms[:n] = np.einsum("nd,nd->n", x64, x64).astype(np.int32)
    return xq, norms, scale, center, lossless, qclip


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


@dataclass(frozen=True)
class DeviceArena:
    """Device-resident arena padded to a block multiple. Padding rows have
    zero role bits, so every query rejects them."""

    vectors: torch.Tensor     # (Npad, d) float32; bfloat16 on int8 arenas
    norms: torch.Tensor       # (Npad,) float32 squared L2 norms
    role_bits: torch.Tensor   # (Npad, W) int32 view of the uint32 bitsets
    n: int
    doc_ids: np.ndarray
    block_ids: np.ndarray
    host_bits: np.ndarray     # (Npad, W) uint32 host mirror of role_bits
    quant: Optional[ArenaQuant] = None   # distances are squared L2

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


def _assemble(vecs, norms, bits, n, doc_ids, block_ids, quant_parts,
              device) -> DeviceArena:
    quant = None
    if quant_parts is not None:
        xq, nq_, scale, center, lossless, qclip = quant_parts
        quant = ArenaQuant(
            vectors_q=_put(xq, device), norms_q=_put(nq_, device),
            scale=float(scale), center=np.asarray(center, np.float32),
            lossless=bool(lossless), qclip=int(qclip))
    # int8 arenas keep a bfloat16 full-precision mirror, as the reference does
    store = torch.bfloat16 if quant is not None else torch.float32
    return DeviceArena(
        vectors=_put(vecs, device).to(store),
        norms=_put(norms, device),
        role_bits=_bits_tensor(bits, device),
        n=int(n), doc_ids=doc_ids, block_ids=block_ids, host_bits=bits,
        quant=quant)


def build_device_arena(corpus: Corpus, world: RBACWorld, *, device,
                       block_rows: int = 16384,
                       dtype: str = "float32") -> DeviceArena:
    """Upload the corpus once, padded to pad_rows(n, block_rows) rows, for
    squared L2 (ip/cosine arenas are ROADMAP slice 2). dtype "int8" adds
    the quantized serving copy (ArenaQuant)."""
    if dtype not in ("float32", "int8"):
        raise NotImplementedError(f"arena dtype {dtype!r} is not ported")
    n, d = corpus.n, corpus.dim
    npad = pad_rows(max(n, 1), block_rows)
    vecs = np.zeros((npad, d), dtype=np.float32)
    vecs[:n] = corpus.vectors
    norms = np.zeros(npad, dtype=np.float32)
    norms[:n] = np.einsum("nd,nd->n", vecs[:n], vecs[:n], dtype=np.float64)
    bits = np.zeros((npad, world.words), dtype=np.uint32)
    bits[:n] = corpus.vector_role_bits(world)
    quant_parts = quantize_corpus(vecs[:n], npad) if dtype == "int8" else None
    return _assemble(vecs, norms, bits, n, corpus.doc_ids, corpus.block_ids,
                     quant_parts, device)


def arena_from_reference(ref, device) -> DeviceArena:
    """Build the port's arena from a reference DeviceArena's numpy mirrors
    (host_vectors, host_norms, host_bits and the quant's host_vectors_q,
    host_norms_q, scale, center, lossless, qclip), so that both packages
    compute on the same state."""
    if ref.metric != "l2":
        raise NotImplementedError(
            f"metric {ref.metric!r}: ip/cosine arenas are ROADMAP slice 2")
    q = ref.quant
    quant_parts = None if q is None else (
        q.host_vectors_q, q.host_norms_q, q.scale, q.center, q.lossless,
        q.qclip)
    return _assemble(ref.host_vectors, ref.host_norms, ref.host_bits, ref.n,
                     ref.doc_ids, ref.block_ids, quant_parts, device)
