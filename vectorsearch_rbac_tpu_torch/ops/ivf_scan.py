"""The probed-list scan with the fused RBAC mask: the IVF index's engine and
the PackedSearcher's.

Counterpart of vectorsearch_rbac_tpu/ops/ivf_scan.py (`probed_topk`,
`ivf_search_fn`), plain PyTorch as the reference is plain JAX. Lists are
padded to one length L_pad; pad slots carry zero role bits (and row id
-1), so the permission test rejects them like any row the user may not
read.

A list's rows are scored against a query as the reference scores them:
the query is rounded to the lists' dtype (bfloat16 on an int8 arena's
mirror) and every product is summed in float32. Here both operands are
upcast to float32 first, which is exact for bfloat16, and multiplied in a
float32 product with float32 output: on bfloat16 lists the product may run
on TF32 tensor cores, whose 10-bit operands hold a bfloat16 value exactly
(so every product is exact and the sum float32), on float32 lists with
TF32 off. A bfloat16 product's bfloat16 output would round the scores and
change ids. Only the order of summation differs from the reference.

The reference's probed scan has no l1 form (its IVF refuses l1, and its
PackedSearcher ranks every arena by squared L2). Here l1 scores are the
sum of |x - q| over the float32 rows and the float32 query, as the flat
scan's, by `torch.cdist(p=1)`: the PackedSearcher serves an l1 arena in
its own metric (ROADMAP queue 3, "Intentional divergences").

`probed_topk` takes a (Q, nprobe) list id a query (the PackedSearcher's
is one partition slot a query). It does not gather a (Q, L_pad, d) block
of rows a probe as the reference's scan does: the (query, probe) pairs
are grouped by list and each list's rows score all of its queries in one
batched product, so a pass reads a list once, not once a query; a list
too long for one step is scored in row chunks whose top-k merge as
probes do. Same products, same mask test, same outputs.

`mode="approx"` takes the exact top-k (the reference's approx_min_k is a
recall-targeted approximation of it: ROADMAP queue 3, "Intentional
divergences").
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .scan import exact_f32_matmul, products

_GATHER_BYTES = 1 << 30   # device bytes of one scoring step's temporaries


def _prepare(queries: torch.Tensor, metric: str, dtype: torch.dtype):
    """(the query as the lists' dtype sees it, in float32; ||q||^2 (Q, 1))
    after cosine's normalization. l1 takes the float32 query unrounded, as
    the flat scan's l1 does."""
    q = queries.to(torch.float32)
    if metric == "cosine":
        q = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-30)
    elif metric not in ("l2", "ip", "l1"):
        raise ValueError(f"unknown metric {metric!r}")
    qc = q if metric == "l1" else q.to(dtype).to(torch.float32)
    return qc, (q * q).sum(dim=1, keepdim=True)


def _score_lists(qb: torch.Tensor, mb: torch.Tensor, lists: torch.Tensor,
                 inv_vectors, inv_norms, inv_bits, inv_rows, kk: int,
                 metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """qb (S, m, d) float32 queries and mb (S, m, W) their masks, lists
    (S,) the list each row of queries scores -> each query's kk smallest
    scores (S, m, kk) and their row ids; inadmissible slots score +inf."""
    xb = inv_vectors.index_select(0, lists).to(torch.float32)   # (S, L, d)
    if metric == "l1":
        scores = torch.cdist(qb, xb, p=1.0)                     # (S, m, L)
    else:
        with products(inv_vectors.dtype):
            dots = torch.bmm(qb, xb.transpose(1, 2))            # (S, m, L)
        if metric == "l2":
            scores = (inv_norms.index_select(0, lists)[:, None, :]
                      - 2.0 * dots)
        else:
            scores = -dots
    del xb
    bits = inv_bits.index_select(0, lists)                      # (S, L, W)
    allowed = torch.zeros(scores.shape, dtype=torch.bool,
                          device=scores.device)
    for w in range(bits.shape[2]):
        allowed |= (mb[:, :, None, w] & bits[:, None, :, w]) != 0
    scores = scores.masked_fill(~allowed, torch.inf)
    vals, pos = torch.topk(scores, kk, dim=2, largest=False)
    s, m = pos.shape[:2]
    ids = inv_rows.index_select(0, lists).gather(1, pos.reshape(s, m * kk))
    return vals, ids.reshape(s, m, kk)


def _finish(cand_vals: torch.Tensor, cand_ids: torch.Tensor,
            qn: torch.Tensor, k: int, metric: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k smallest of each query's candidates, as distances: squared L2
    (clamped at 0), -q.x, cosine distance in [0, 2], or l1; empty slots
    +inf / -1."""
    nq, c = cand_vals.shape
    if c < k:
        cand_vals = torch.cat([cand_vals, torch.full(
            (nq, k - c), torch.inf, device=cand_vals.device)], dim=1)
        cand_ids = torch.cat([cand_ids, torch.full(
            (nq, k - c), -1, dtype=cand_ids.dtype,
            device=cand_ids.device)], dim=1)
    vals, pos = torch.topk(cand_vals, k, dim=1, largest=False)
    idx = cand_ids.gather(1, pos)
    empty = torch.isinf(vals)
    if metric == "l2":
        dists = torch.clamp_min(vals + qn, 0.0)
    elif metric == "cosine":
        dists = torch.clamp(1.0 + vals, 0.0, 2.0)
    else:
        dists = vals
    return (torch.where(empty, torch.inf, dists),
            torch.where(empty, -1, idx))


def probed_topk(
    queries: torch.Tensor,       # (Q, d) float32
    probe_ids,                   # (Q, nprobe) list ids a query (a tensor
                                 # or a host array)
    inv_vectors: torch.Tensor,   # (nlist, L_pad, d) float32 or bfloat16
    inv_norms: torch.Tensor,     # (nlist, L_pad) float32 squared norms
    inv_bits: torch.Tensor,      # (nlist, L_pad, W) int32, 0 = padding
    inv_rows: torch.Tensor,      # (nlist, L_pad) int32 row ids, -1 = pad
    query_masks: torch.Tensor,   # (Q, W) int32
    k: int,
    mode: str = "exact",
    metric: str = "l2",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dists (Q, k) ascending in the metric's distance, row ids (Q, k));
    -1 / +inf where fewer than k admissible rows were probed. Each
    (query, probe) pair keeps its min(k, L_pad) best and one exact merge a
    query follows, as in the reference; the pairs are scored grouped by
    list (_grouped_scores), so a list's rows are read once for all the
    queries that probe it. A list whose rows do not fit a quarter of
    _GATHER_BYTES (as float32 beside their own dtype) is cut into row
    chunks, each a list of its own that the query probes. Both modes take
    the exact top-k."""
    if mode not in ("exact", "approx"):
        raise ValueError(f"unknown mode {mode!r}")
    qc, qn = _prepare(queries, metric, inv_vectors.dtype)
    nq, d = qc.shape
    n_lists, l_pad = inv_vectors.shape[:2]
    w = inv_bits.shape[2]
    probes = (probe_ids.cpu().numpy() if isinstance(probe_ids, torch.Tensor)
              else np.asarray(probe_ids)).astype(np.int64).reshape(nq, -1)
    chunks = 1
    row_bytes = d * (4 + inv_vectors.element_size())
    while (l_pad // chunks) * row_bytes > _GATHER_BYTES // 4 \
            and (l_pad // chunks) % 2 == 0 and l_pad // chunks > 1024:
        chunks *= 2
    lc = l_pad // chunks
    kk = min(k, lc)
    per_query = probes.shape[1] * chunks
    pair_q = np.repeat(np.arange(nq, dtype=np.int64), per_query)
    pair_list = (probes[:, :, None] * chunks
                 + np.arange(chunks)).reshape(-1)
    vals, ids = _grouped_scores(
        qc, query_masks, pair_q, pair_list,
        inv_vectors.view(n_lists * chunks, lc, d),
        inv_norms.view(n_lists * chunks, lc),
        inv_bits.view(n_lists * chunks, lc, w),
        inv_rows.view(n_lists * chunks, lc), kk, metric)
    return _finish(vals.view(nq, per_query * kk),
                   ids.view(nq, per_query * kk), qn, k, metric)


def ivf_search_fn(queries, centroids, inv_vectors, inv_norms, inv_bits,
                  inv_rows, query_masks, k: int, nprobe: int,
                  metric: str = "l2"):
    """The full IVF search: route each query to its nprobe nearest
    centroids by squared L2 (on unit vectors for cosine: angular routing;
    a proxy for ip, as the reference's), then the probed scan."""
    q = queries.to(torch.float32)
    if metric == "cosine":
        q = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-30)
    qn = (q * q).sum(dim=1, keepdim=True)
    cn = (centroids * centroids).sum(dim=1)
    with exact_f32_matmul():
        cd = qn + cn[None, :] - 2.0 * (q @ centroids.T)
    probe_ids = torch.topk(cd, nprobe, dim=1, largest=False).indices
    return probed_topk(queries, probe_ids, inv_vectors, inv_norms, inv_bits,
                       inv_rows, query_masks, k, metric=metric)


def _grouped_scores(qc, query_masks, pair_q: np.ndarray,
                    pair_list: np.ndarray, inv_vectors, inv_norms, inv_bits,
                    inv_rows, kk: int, metric: str):
    """Each (query pair_q[j], list pair_list[j]) pair's kk best (scores,
    row ids), (n_pairs, kk): the pairs grouped by list (host-side), each
    list's pairs cut into units that fit _GATHER_BYTES, units ordered by
    size and batched, and a batch of S units scores its (S, m, d) queries
    against its S lists' rows in one product."""
    dev = qc.device
    d, w = qc.shape[1], inv_bits.shape[2]
    l_pad = inv_vectors.shape[1]
    n_pairs = len(pair_q)
    row_bytes = l_pad * d * (4 + inv_vectors.element_size())
    pair_bytes = l_pad * 16          # scores, the mask test, top-k input
    unit_cap = max(1, (_GATHER_BYTES - row_bytes) // pair_bytes)
    order = np.argsort(pair_list, kind="stable")
    bounds = np.flatnonzero(np.diff(pair_list[order])) + 1
    units = []                       # (list, pair ids)
    for grp in np.split(order, bounds) if n_pairs else []:
        for u in range(0, len(grp), unit_cap):
            units.append((int(pair_list[grp[0]]), grp[u:u + unit_cap]))
    units.sort(key=lambda u: -len(u[1]))
    batches, b0 = [], 0
    while b0 < len(units):
        m = len(units[b0][1])
        s = max(1, _GATHER_BYTES // (row_bytes + m * pair_bytes))
        batches.append(units[b0:b0 + s])
        b0 += s
    # pair n_pairs pads the units of a batch: a zero query with a zero mask
    # admits nothing, and its row of the output is dropped
    sel_all, lists_all = [], []
    for batch in batches:
        sel = np.full((len(batch), len(batch[0][1])), n_pairs, np.int64)
        for j, (_, pids) in enumerate(batch):
            sel[j, :len(pids)] = pids
        sel_all.append(sel)
        lists_all.append(np.asarray([u[0] for u in batch], dtype=np.int64))
    sel_h = np.concatenate([x.reshape(-1) for x in sel_all]
                           or [np.zeros(0, np.int64)])
    sel_d = torch.from_numpy(sel_h).to(dev)
    qsel_d = torch.from_numpy(np.append(pair_q, len(qc))[sel_h]).to(dev)
    lists_d = torch.from_numpy(np.concatenate(
        lists_all or [np.zeros(0, np.int64)])).to(dev)
    q_ext = torch.cat([qc, torch.zeros((1, d), device=dev)])
    m_ext = torch.cat([query_masks, torch.zeros(
        (1, w), dtype=query_masks.dtype, device=dev)])
    out_v = torch.full((n_pairs + 1, kk), torch.inf, device=dev)
    out_i = torch.full((n_pairs + 1, kk), -1, dtype=inv_rows.dtype,
                       device=dev)
    so = lo = 0
    for sel, lists in zip(sel_all, lists_all):
        s, m = sel.shape
        qidx = qsel_d[so:so + s * m]
        v, i = _score_lists(q_ext.index_select(0, qidx).view(s, m, d),
                            m_ext.index_select(0, qidx).view(s, m, w),
                            lists_d[lo:lo + s], inv_vectors, inv_norms,
                            inv_bits, inv_rows, kk, metric)
        # pad units all land on row n_pairs, which is dropped
        dest = sel_d[so:so + s * m]
        out_v.index_copy_(0, dest, v.reshape(s * m, kk))
        out_i.index_copy_(0, dest, i.reshape(s * m, kk))
        so, lo = so + s * m, lo + s
    return out_v[:n_pairs], out_i[:n_pairs]
