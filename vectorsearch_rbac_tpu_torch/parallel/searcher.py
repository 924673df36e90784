"""The global (RLS) searcher over a device mesh.

Counterpart of vectorsearch_rbac_tpu/parallel/searcher.py: the
single-arena scan with the rows sharded over the mesh's `shard` axis and
query batches split over `repl`, behind the strategies' search_batch API.
float32 and bfloat16 arenas take the exact masked scan on every shard;
int8 takes the flagship (K1 and the K3/K4 merge on every shard of a
card). Results are quantized-domain on int8 (no rerank tier), as in the
reference.

Two rules differ from the reference's: a batch pads only to a multiple of
the replica count (the reference pads to replicas x its q_tile; no
query's result depends on its batch here), and the int8 shards merge with
the merge kernels where their gate takes the shape (the reference's
sharded searcher asks for "auto", which on the card would be the exact
merge and launch neither K3 nor K4; at the shapes the gate refuses the
port takes the cascade, below 2,048 groups the exact merge, as the
reference's CPU mesh does).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config import get_logger
from ..core import ArenaQuant, Corpus, quantize_corpus
from ..rbac import RBACWorld, query_masks_for
from .mesh import REPL_AXIS, SHARD_AXIS, make_mesh
from .sharded import (shard_arena_arrays, shard_quant_arrays,
                      sharded_int8_topk, sharded_masked_topk)

logger = get_logger("parallel.searcher")

_STORE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class ShardedGlobalSearcher:
    """RLS over a mesh: the fused-bitmask exact scan (float32, bfloat16)
    or the int8 flagship, rows sharded across devices."""

    name = "rls_sharded"

    def __init__(
        self,
        corpus: Corpus,
        world: RBACWorld,
        mesh=None,
        n_devices: Optional[int] = None,
        n_replicas: int = 1,
        block_rows: int = 16384,
        dtype: str = "float32",
    ):
        if dtype not in (*_STORE, "int8"):
            raise ValueError(f"dtype {dtype!r}: float32, bfloat16 or int8")
        self.mesh = mesh or make_mesh(n_devices, n_replicas=n_replicas)
        self.n_shards = self.mesh.shape[SHARD_AXIS]
        self.n_repl = self.mesh.shape[REPL_AXIS]
        self.block_rows = block_rows
        self.world = world

        n, d = corpus.n, corpus.dim
        # pad so every shard holds a whole number of blocks
        unit = block_rows * self.n_shards
        npad = ((n + unit - 1) // unit) * unit
        bits = np.zeros((npad, world.words), dtype=np.uint32)
        bits[:n] = corpus.vector_role_bits(world)

        self.quantized = dtype == "int8"
        if self.quantized:
            xq, nq_, scale, center, lossless, qclip = quantize_corpus(
                corpus.vectors, npad)
            vq, nqd, self._bits = shard_quant_arrays(self.mesh, xq, nq_, bits)
            self._quant = ArenaQuant(
                vectors_q=vq, norms_q=nqd, scale=float(scale),
                center=np.asarray(center, np.float32),
                lossless=bool(lossless), qclip=int(qclip))
        else:
            vecs = np.zeros((npad, d), dtype=np.float32)
            vecs[:n] = corpus.vectors
            norms = np.zeros(npad, dtype=np.float32)
            norms[:n] = np.einsum("nd,nd->n", corpus.vectors, corpus.vectors)
            self._vectors, self._norms, self._bits = shard_arena_arrays(
                self.mesh, torch.from_numpy(vecs).to(_STORE[dtype]), norms,
                bits)
        self.n = n
        self.npad = npad
        logger.info("sharded arena: %d rows over %d shards x %d replicas "
                    "(%s)", npad, self.n_shards, self.n_repl, dtype)

    def search_batch(
        self, queries: np.ndarray, user_ids: np.ndarray,
        user_masks: np.ndarray, k: int,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(dists (Q, k) float32, row ids (Q, k) int64); +inf / -1 pads."""
        q = np.asarray(queries, dtype=np.float32)
        masks = query_masks_for(user_masks, np.asarray(user_ids))
        nq = q.shape[0]
        pad = (-nq) % self.n_repl       # only to split over the replicas
        if pad:
            q = np.concatenate([q, np.zeros((pad, q.shape[1]), np.float32)])
            masks = np.concatenate(
                [masks, np.zeros((pad, masks.shape[1]), np.uint32)])
        if self.quantized:
            quant = self._quant
            q8, qn = quant.quantize_queries(q)
            d, i = sharded_int8_topk(
                self.mesh, q8, qn, quant.vectors_q, quant.norms_q,
                self._bits, masks, 1.0 / quant.scale**2, k,
                group=self._int8_group(), score_shift=quant.score_shift)
        else:
            d, i = sharded_masked_topk(
                self.mesh, q, self._vectors, self._norms, self._bits, masks,
                k, block_rows=self.block_rows)
        return (d.cpu().numpy()[:nq],
                i.cpu().numpy()[:nq].astype(np.int64))

    def _int8_group(self) -> int:
        """Per-shard group-min width: keep >= 8192 group minima a shard
        (Int8FlatIndex's collision-floor rule, on the shard's rows)."""
        fit = (self.npad // self.n_shards) // 8192
        if fit >= 8:
            return min(128, 1 << (fit.bit_length() - 1))
        return 8

    def storage_report(self):
        mb = 1024 * 1024
        words = self._bits.shape[1]
        if self.quantized:
            row = self._quant.d_pad + 4 + 4 * words
        else:
            row = (self._vectors.shape[1] * self._vectors.parts[0][0]
                   .element_size() + 4 + 4 * words)
        total = self.npad * row
        return {
            "total_mb": total / mb,
            "per_shard_mb": total / mb / self.n_shards,
            "num_partitions": self.n_shards,
        }
