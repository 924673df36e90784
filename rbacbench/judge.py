"""The comparison that decides `correct`.

Every answer the window received is judged against the plain reference's
exact filtered top-kk of its query (reference.py), by three numbers:

- `invalid_rows`: returned rows that break the configuration's guarantee:
  an id out of range, a row the query's user may not read, or a row
  returned twice for one query. Limit 0.
- `miss_rate`: 1 - mean recall@k. A returned row is a hit when it is valid
  and its exact distance is at most the reference's k-th smallest (so a
  tie at the k-th distance counts whichever tied row comes back); a
  query's recall is its hits, at most k_eff = min(k, rows its user may
  read), over k_eff. A missing answer (-1) is a miss.
- `rank_excess`: over every valid returned row, the number of readable
  rows strictly closer to the query, less k_eff - 1, at least 0; the
  largest over the window. A sound top-k whose selection lost m true
  neighbours returns rows of rank below k_eff + m; a row the search did
  not find among the nearest reads far beyond, up to the reference's
  depth kk.

Identical answers to one query batch are judged once and counted as often
as they came.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import shares_bit

J_CHUNK = 2048


@dataclass
class Verdict:
    answered: int = 0        # queries judged
    failed: int = 0          # queries with an invalid row
    invalid_rows: int = 0
    recall_sum: float = 0.0
    rank_excess: int = 0

    def add(self, other: "Verdict", times: int = 1) -> None:
        self.answered += other.answered * times
        self.failed += other.failed * times
        self.invalid_rows += other.invalid_rows * times
        self.recall_sum += other.recall_sum * times
        self.rank_excess = max(self.rank_excess, other.rank_excess)

    @property
    def recall(self) -> float:
        return self.recall_sum / self.answered if self.answered else 0.0

    @property
    def miss_rate(self) -> float:
        return 1.0 - self.recall

    def numbers(self) -> Dict[str, float]:
        """The three numbers compared with the cell's limits."""
        return {"miss_rate": self.miss_rate, "rank_excess": self.rank_excess,
                "invalid_rows": self.invalid_rows}


def judge_batch(rows: torch.Tensor, doc_of_row: torch.Tensor,
                doc_bits: torch.Tensor, queries: np.ndarray,
                masks: np.ndarray, ids: np.ndarray, ref_d: np.ndarray,
                readable: np.ndarray, k: int, dist) -> Verdict:
    """One batch of answers: queries (Q, d), their users' masks (Q, W)
    uint32, the returned ids (Q, k), the reference's sorted distances
    (Q, kk) and readable-row counts (Q,), and the metric's distance module
    (reference.metric)."""
    dev = rows.device
    n = rows.shape[0]
    v = Verdict()
    for c0 in range(0, ids.shape[0], J_CHUNK):
        sl = slice(c0, c0 + J_CHUNK)
        got = torch.from_numpy(np.ascontiguousarray(ids[sl],
                                                    dtype=np.int64)).to(dev)
        if got.shape[1] != k:
            raise ValueError(f"answers carry {got.shape[1]} ids, not {k}")
        q = torch.from_numpy(np.ascontiguousarray(queries[sl])).to(dev)
        m = torch.from_numpy(np.ascontiguousarray(
            masks[sl], dtype=np.uint32).view(np.int32)).to(dev)
        present = got >= 0
        in_range = present & (got < n)
        safe = got.clamp(0, n - 1)
        bits = doc_bits.index_select(0, doc_of_row.index_select(
            0, safe.reshape(-1))).view(*got.shape, -1)
        can_read = shares_bit(bits, m[:, None, :])
        srt, order = torch.sort(torch.where(present, got, -1 - torch.arange(
            k, device=dev)[None, :]), dim=1)
        again = torch.zeros_like(present)
        again[:, 1:] = srt[:, 1:] == srt[:, :-1]
        dup = torch.zeros_like(present).scatter_(1, order, again)
        ok = in_range & can_read & ~dup
        bad = present & ~ok
        dist_got = dist.exact(rows, q, got)
        rd = torch.from_numpy(ref_d[sl]).to(dev)
        k_eff = torch.from_numpy(np.minimum(readable[sl], k)).to(dev)
        has = k_eff > 0
        kth = rd.gather(1, (k_eff - 1).clamp_min(0)[:, None])
        hits = (ok & (dist_got <= kth)).sum(dim=1)
        rec = torch.where(has, torch.minimum(hits, k_eff).to(torch.float64)
                          / k_eff.clamp_min(1), 1.0)
        rank = torch.searchsorted(rd.contiguous(), dist_got.contiguous(),
                                  side="left")
        excess = torch.where(ok, (rank - (k_eff[:, None] - 1)).clamp_min(0),
                             0)
        v.answered += got.shape[0]
        v.failed += int(bad.any(dim=1).sum())
        v.invalid_rows += int(bad.sum())
        v.recall_sum += float(rec.sum())
        v.rank_excess = max(v.rank_excess, int(excess.max()))
    return v


def distinct_answers(answers: Sequence[Tuple[int, np.ndarray]]
                     ) -> Dict[int, List[Tuple[np.ndarray, int]]]:
    """bank index -> [(ids, times received)], identical arrays merged."""
    out: Dict[int, List[Tuple[np.ndarray, int]]] = {}
    for b, ids in answers:
        seen = out.setdefault(b, [])
        for j, (prev, times) in enumerate(seen):
            if prev.shape == ids.shape and np.array_equal(prev, ids):
                seen[j] = (prev, times + 1)
                break
        else:
            seen.append((ids, 1))
    return out
