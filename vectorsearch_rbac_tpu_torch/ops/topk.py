"""Host-side top-k merge across partitions with (doc, block) dedupe.

A copy of vectorsearch_rbac_tpu/ops/topk.py (numpy only), held equal to
it by tests/test_torch_partition.py.

Replaces the reference's Python merge of per-partition SQL results
(reference controller/dynamic_partition/search.py:347 merge_results and
controller/baseline/prefilter/prefilter_role.py per-role merge): results
are sorted by distance and deduplicated. Because every partition reports
*arena row ids* (logical partitions share the one vector arena — reference
shared_vector_table.h semantics), dedupe by (doc, block) reduces to dedupe
by row id.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def merge_topk_host(
    dists_list: Sequence[np.ndarray],  # each (Q, k_i) ascending, +inf = empty
    idx_list: Sequence[np.ndarray],    # each (Q, k_i) arena row ids, -1 = empty
    k: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge per-partition top-k result blocks into one (Q, k) result.

    Duplicate row ids (a row replicated into several partitions) keep the
    smallest distance. Empty slots are dist=+inf / idx=-1.
    """
    dists = np.concatenate([np.asarray(d, dtype=np.float64) for d in dists_list], axis=1)
    idx = np.concatenate([np.asarray(i, dtype=np.int64) for i in idx_list], axis=1)
    q, c = dists.shape

    # fully vectorized (the round-1 per-query Python loop walled at ~100k
    # queries): (1) sort by distance, (2) group equal row ids with a stable
    # by-id sort — within a group the best distance comes first, the rest
    # are duplicates — (3) re-sort survivors by distance and cut to k
    order = np.argsort(dists, axis=1, kind="stable")
    sd = np.take_along_axis(dists, order, axis=1)
    si = np.take_along_axis(idx, order, axis=1)

    by_id = np.argsort(si, axis=1, kind="stable")
    sr = np.take_along_axis(si, by_id, axis=1)
    dup_sorted = np.zeros_like(sr, dtype=bool)
    dup_sorted[:, 1:] = (sr[:, 1:] == sr[:, :-1]) & (sr[:, 1:] >= 0)
    dup = np.zeros_like(dup_sorted)
    np.put_along_axis(dup, by_id, dup_sorted, axis=1)

    sd = np.where(dup | (si < 0), np.inf, sd)
    si = np.where(dup | (si < 0), -1, si)
    final = np.argsort(sd, axis=1, kind="stable")[:, :k]
    out_d = np.full((q, k), np.inf)
    out_i = np.full((q, k), -1, dtype=np.int64)
    kk = final.shape[1]
    out_d[:, :kk] = np.take_along_axis(sd, final, axis=1)
    out_i[:, :kk] = np.take_along_axis(si, final, axis=1)
    out_i[:, :kk] = np.where(np.isfinite(out_d[:, :kk]), out_i[:, :kk], -1)
    return out_d, out_i
