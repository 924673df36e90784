"""The plain reference: exact RBAC-filtered top-k by brute force.

Plain torch over the arrays the harness made (the uint8 rows, each row's
document, each document's role bitset, each user's role mask); it imports
nothing of the program and takes nothing the program made. A row is
readable by a query iff its document's bitset and the query's user's mask
share a bit. Queries are grouped by their user's mask; for each mask the
readable rows are gathered once, every distance to them is computed, and
the kk smallest are kept, sorted ascending.

The distance is the configuration's metric, found by name:
`rbacbench/distances/<metric>.py` (`pairwise`, `norms`, `exact`); a metric
without a file raises. It runs in float32 with TF32 off.

`control=<name>` runs the same search over the codes of
`rbacbench/controls/<name>.py` (rows and queries alike): the control that
the check has to call not correct.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from .manifest import generator

Q_CHUNK = 512


def metric(name: str):
    """The distance module of a metric; ManifestError names a missing
    one."""
    return generator("distances", name)


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def shares_bit(bits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The readability rule: (...,) bool, whether each int32 bitset
    (..., W) shares a bit with the int32 mask broadcast against it."""
    return ((bits & mask) != 0).any(dim=-1)


def filtered_topk(rows: torch.Tensor, doc_of_row: torch.Tensor,
                  doc_bits: torch.Tensor, query_masks: np.ndarray,
                  queries: np.ndarray, kk: int, metric_name: str,
                  control: Optional[str] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Exact filtered top-kk of every query.

    rows (N, d) uint8 and doc_of_row (N,) int64 on the device, doc_bits
    (num_docs, W) int32 on the device, query_masks (Q, W) uint32 and
    queries (Q, d) float32 on the host. Returns (dists (Q, kk) float32
    ascending, +inf past the readable rows; ids (Q, kk) int64, -1 there;
    readable (Q,) int64 rows each query may read)."""
    dist = metric(metric_name)
    if control is None:
        def codes(x):
            return x.to(torch.float32)
    else:
        codes = generator("controls", control).codes
    dev = rows.device
    nq = queries.shape[0]
    out_d = np.full((nq, kk), np.inf, np.float32)
    out_i = np.full((nq, kk), -1, np.int64)
    readable = np.zeros(nq, np.int64)
    masks = np.ascontiguousarray(query_masks, dtype=np.uint32)
    uniq, inv = np.unique(masks, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    with tf32_off():
        for g in range(len(uniq)):
            m = torch.from_numpy(uniq[g].view(np.int32).copy()).to(dev)
            idx = torch.nonzero(shares_bit(doc_bits, m[None, :])[doc_of_row]
                                ).squeeze(1)
            qi = np.flatnonzero(inv == g)
            readable[qi] = idx.numel()
            if idx.numel() == 0:
                continue
            xm = codes(rows.index_select(0, idx))
            xn = dist.norms(xm)
            k_eff = min(kk, idx.numel())
            for c0 in range(0, len(qi), Q_CHUNK):
                sel = qi[c0:c0 + Q_CHUNK]
                q = codes(torch.from_numpy(queries[sel]).to(dev))
                d = dist.pairwise(q, xm, xn)
                v, j = torch.topk(d, k_eff, dim=1, largest=False,
                                  sorted=True)
                out_d[sel, :k_eff] = v.cpu().numpy()
                out_i[sel, :k_eff] = idx[j].cpu().numpy()
    return out_d, out_i, readable
