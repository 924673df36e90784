"""Sparse flat index: the masked sparse scan over a SparseCorpus or a row
subset of one (pgvector's sparsevec columns).

Counterpart of vectorsearch_rbac_tpu/index/sparse.py `SparseFlatIndex`.
The index's rows are sliced from the corpus's CSR on the host (cosine
rows normalized there), padded to the block layout of
ops/sparse_scan.py and uploaded with their norms, role bitsets and row
map, on the card unless the caller names another device. Queries come
sparse (`search_sparse`, (Q, qnnz) columns padded with
`dim` and their values) or dense (`search`, (Q, dim)); either becomes a
dense (Q, dim + 1) buffer. Ids return through the row map as corpus row
ids. The reference's `mode` and `recall_target` (an approximate
per-block top-k) are not carried: the scan is exact.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data import SparseCorpus
from ..ops.sparse_scan import (densify_queries, masked_sparse_topk,
                               pad_sparse_rows)
from ..rbac import RBACWorld
from .flat import _pad_to_bucket


class SparseFlatIndex:
    def __init__(self, corpus: SparseCorpus, world: RBACWorld,
                 rows: Optional[np.ndarray] = None, *, device="cuda",
                 block_rows: int = 2048, query_batch: int = 256,
                 metric: str = "l2"):
        if metric not in ("l2", "ip", "cosine", "l1"):
            raise ValueError(f"unknown metric {metric!r}")
        self.block_rows = block_rows
        self.query_batch = query_batch
        self.metric = metric
        self.dim = corpus.dim
        sel = (np.arange(corpus.n, dtype=np.int64) if rows is None
               else np.asarray(rows, dtype=np.int64))
        self.n_rows = len(sel)
        npad = _pad_to_bucket(max(self.n_rows, 1), block_rows)
        counts = np.diff(corpus.indptr)[sel]
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        take = (np.repeat(corpus.indptr[sel].astype(np.int64) - indptr[:-1],
                          counts) + np.arange(indptr[-1], dtype=np.int64))
        indices = corpus.indices[take]
        data = corpus.data[take].astype(np.float32)
        if metric == "cosine":
            nrm = np.sqrt(np.maximum(corpus.norms[sel], 1e-30))
            data = data / np.repeat(nrm, counts).astype(np.float32)
        cols, vals, self.nnz_pad = pad_sparse_rows(indptr, indices, data,
                                                   corpus.dim, npad)
        norms = np.zeros(npad, dtype=np.float32)
        norms[:self.n_rows] = (np.ones(self.n_rows) if metric == "cosine"
                               else corpus.norms[sel])
        rbits = np.zeros((npad, world.words), np.uint32)
        rbits[:self.n_rows] = corpus.vector_role_bits(world)[sel]
        rmap = np.full(npad, -1, dtype=np.int64)
        rmap[:self.n_rows] = sel
        put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self._cols, self._vals, self._norms = put(cols), put(vals), put(norms)
        self._bits = put(rbits.view(np.int32))
        self._row_map = put(rmap)

    def search_sparse(self, q_cols: np.ndarray, q_vals: np.ndarray,
                      query_masks: np.ndarray, k: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, qnnz) int32 query columns padded with self.dim and their
        float32 values (0 on pads)."""
        return self._search_dense_buffer(
            densify_queries(np.asarray(q_cols), np.asarray(q_vals),
                            self.dim), query_masks, k)

    def search(self, queries: np.ndarray, query_masks: np.ndarray,
               k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Dense (Q, dim) queries: the other indexes' protocol."""
        q = np.asarray(queries, dtype=np.float32)
        return self._search_dense_buffer(np.concatenate(
            [q, np.zeros((q.shape[0], 1), np.float32)], axis=1),
            query_masks, k)

    def _search_dense_buffer(self, qd: np.ndarray, query_masks: np.ndarray,
                             k: int) -> Tuple[np.ndarray, np.ndarray]:
        dev = self._cols.device
        q = torch.from_numpy(np.ascontiguousarray(qd, np.float32)).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(
            query_masks, np.uint32).view(np.int32)).to(dev)
        ds = [torch.empty((0, k), device=dev)]
        ids = [torch.empty((0, k), dtype=torch.int64, device=dev)]
        for s in range(0, q.shape[0], self.query_batch):
            d, i = masked_sparse_topk(
                q[s:s + self.query_batch], self._cols, self._vals,
                self._norms, self._bits, m[s:s + self.query_batch], k,
                self.block_rows, metric=self.metric)
            ds.append(d)
            ids.append(torch.where(i < 0, -1,
                                   self._row_map[i.clamp_min(0).long()]))
        return torch.cat(ds).cpu().numpy(), torch.cat(ids).cpu().numpy()

    def storage_bytes(self) -> Dict[str, int]:
        """Padded CSR (cols and vals), and norms, bitsets and row map, as
        the reference counts them."""
        npad = self._cols.shape[0]
        return {"vectors": int(npad * self.nnz_pad * (4 + 4)),
                "index": int(npad * (4 + 4 * self._bits.shape[1] + 4))}
