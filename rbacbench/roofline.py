"""Peaks and the least time of a call's filtered search.

The arithmetic is frozen from chip_smoke.py `bound_ms` at commit 67fd89a
(the larger of the bytes over the HBM rate and the operations over the
int8 tensor-core rate, the NVIDIA data sheet's H100 SXM peaks at 700 W).

What a filtered top-k call needs, whatever implements it:
- operations: 2 * d for every (query, row) pair whose row the query's user
  may read;
- bytes: each row's int8 codes (d bytes) read once, each document's role
  bitset (4 * W bytes) read once (a document's rows share it; the
  block-major layout makes a row's document implicit, so no row-to-document
  map is charged), the int8 queries (d bytes each) read once, and the k
  results (a 4-byte row id each) written once.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Tuple

# card name (torch.cuda.get_device_name) -> (HBM bytes/s, dense int8 ops/s)
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 1.979e15)}


def peaks(kind: str) -> Optional[Tuple[float, float]]:
    return PEAKS.get(kind)


def bound_s(nbytes: float, ops: float, bytes_s: float, ops_s: float
            ) -> Tuple[float, str]:
    """(least seconds, "bytes" or "operations")."""
    t_bytes = nbytes / bytes_s
    t_ops = ops / ops_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def filtered_search_work(n_rows: int, n_docs: int, dim: int, words: int,
                         queries: int, k: int, admitted_pairs: int
                         ) -> Tuple[float, float]:
    """(bytes, operations) that one call over these inputs needs."""
    nbytes = (n_rows * dim + n_docs * 4 * words + queries * dim
              + queries * k * 4)
    return float(nbytes), 2.0 * dim * float(admitted_pairs)


def least_s(kind: str, work: Iterable[Mapping]) -> Optional[float]:
    """The least seconds of these calls on this card (None for a card
    without peaks, or no calls). Each call's work: n_rows, n_docs, dim,
    words, queries, k, admitted (pairs)."""
    p = peaks(kind)
    work = list(work)
    if p is None or not work:
        return None
    return sum(bound_s(*filtered_search_work(
        w["n_rows"], w["n_docs"], w["dim"], w["words"], w["queries"],
        w["k"], w["admitted"]), *p)[0] for w in work)
