"""Batched HNSW graph beam search, in PyTorch with the graph step's kernels.

Counterpart of vectorsearch_rbac_tpu/ops/graph_search.py: Q queries
advance together; each step expands one frontier node per query, gathers
its neighbour row, scores the neighbours and merges them into an
unfiltered traversal beam and a permission-filtered result list.
Traversal ignores permissions (inadmissible nodes still route); results
admit only rows whose bitset meets the query's mask.

- `graph_beam_search` (the reference's :45): the fixed-budget traversal
  the builder's refinement pass runs.
- `graph_beam_search_iterative` (:343): the iterative rescan the HNSW
  executor serves with: per-query termination against the ef-wide visited
  window, multi-graph slabs (`pids`), per-query step budgets, the 2-hop
  harvest, and the packed-row scoring. Its step runs the two kernels of
  ops/graph_step.py (score and merge); the neighbour gather and the dedup
  against beam and history stay PyTorch.

The state layout is the reference's: a pop leaves +inf and id -1 in the
popped slot, and every merge keeps the lower position first among equal
values (lax.top_k's order), so ids and distances come out equal to the
reference's on the same inputs. The reference's lax.while_loop becomes a
Python loop that asks the device whether every query is done only every
`sync_every` steps: a query that is done keeps popping its beam, but every
candidate it adds is -1/+inf, so its results, its window and its done
test do not move, and the outputs equal those of a test at every step.

Metric: l2 only (the port's partitions serve l2); ip, cosine and l1 graph
scoring raise (ROADMAP queue 1 item 11). The ACORN filtered traversal
(`graph_beam_search_filtered`, :187) waits with the ACORN builder.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from .graph_step import candidate_rows, graph_merge_step, graph_score_packed

INF = float("inf")
SYNC_EVERY = 8   # steps between the host's "all done?" reads


def _check_metric(metric: str) -> None:
    if metric != "l2":
        raise NotImplementedError(
            f"graph search with metric {metric!r}: the port's graph step "
            "scores l2 only; ip, cosine and l1 graph scoring are ROADMAP "
            "queue 1 item 11")


def _stable_smallest(d, width, *carried):
    """The `width` smallest values of each row, ascending, ties in position
    order, and the carried tensors gathered alike."""
    v, pos = torch.sort(d, dim=1, stable=True)
    pos = pos[:, :width]
    return (v[:, :width], *(c.gather(1, pos) for c in carried))


def _unpacked_scorer(vectors, norms, role_bits, query_masks, q, row_map,
                     pids=None):
    """(scores, admissible) of (Q, C) candidate ids from the separate
    vector, norm and bitset tables (the reference's dist_to and allowed).
    The query is rounded to the table's dtype, as the reference's is; the
    dots are float32 sums of products that are exact in float32 (bfloat16
    or float32 operands)."""
    qc = q.to(vectors.dtype).float()

    def score_admit(ids):
        rows = candidate_rows(ids, row_map, pids).clamp_min(0).long()
        valid = ids >= 0
        x = vectors[rows].float()                                 # (Q, C, d)
        dots = torch.einsum("qd,qcd->qc", qc, x)
        s = torch.where(valid, norms[rows] - 2.0 * dots, INF)
        bits = role_bits[rows]                                    # (Q, C, W)
        ok = ((bits & query_masks[:, None, :]) != 0).any(dim=-1)
        return s, ok & valid
    return score_admit


def _finish(res_d, res_ids, q):
    """The reference's finalisation (:610-619, l2): squared distances with
    the query norm added back, +inf / -1 where a slot is empty."""
    empty = torch.isinf(res_d)
    qn = (q * q).sum(dim=1, keepdim=True)
    dists = torch.where(empty, INF, (res_d + qn).clamp_min(0.0))
    return dists, torch.where(empty, -1, res_ids)


def graph_beam_search(queries, vectors, norms, role_bits, graph, query_masks,
                      entry: int, k: int, ef: int, row_map=None,
                      metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-budget traversal: ef - 1 expansions from one entry node,
    the beam keeps expanded nodes (flagged), the results admit permitted
    rows. Returns (dists (Q, k) ascending, local ids (Q, k))."""
    _check_metric(metric)
    q = queries.float()
    nq = q.shape[0]
    dev = q.device
    score_admit = _unpacked_scorer(vectors, norms, role_bits, query_masks, q,
                                   row_map)
    entry_ids = torch.full((nq, 1), int(entry), dtype=torch.int32,
                           device=dev)
    entry_d, e_ok = score_admit(entry_ids)
    beam_ids = torch.cat([entry_ids, torch.full((nq, ef - 1), -1,
                                                dtype=torch.int32,
                                                device=dev)], 1)
    beam_d = torch.cat([entry_d, torch.full((nq, ef - 1), INF, device=dev)],
                       1)
    beam_exp = torch.ones((nq, ef), dtype=torch.bool, device=dev)
    beam_exp[:, 0] = False
    res_ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    res_d = torch.full((nq, k), INF, device=dev)
    res_ids[:, 0] = torch.where(e_ok[:, 0], entry_ids[:, 0], -1)
    res_d[:, 0] = torch.where(e_ok[:, 0], entry_d[:, 0], INF)
    history = torch.full((nq, ef), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(nq, device=dev)
    for t in range(1, ef):
        masked = torch.where(beam_exp, INF, beam_d)
        sel = masked.argmin(dim=1)
        active = torch.isfinite(masked[rows, sel])
        node = torch.where(active, beam_ids[rows, sel], -1)
        beam_exp[rows, sel] = True
        history[:, t] = node
        nb = graph[node.clamp_min(0).long()]
        nb = torch.where((node >= 0)[:, None], nb, -1)
        seen = ((nb[:, :, None] == beam_ids[:, None, :]).any(-1)
                | (nb[:, :, None] == history[:, None, :]).any(-1))
        nb = torch.where(seen, -1, nb)
        nd, ok = score_admit(nb)
        beam_d, beam_ids, beam_exp = _stable_smallest(
            torch.cat([beam_d, nd], 1), ef, torch.cat([beam_ids, nb], 1),
            torch.cat([beam_exp, torch.zeros_like(ok)], 1))
        res_d, res_ids = _stable_smallest(
            torch.cat([res_d, torch.where(ok, nd, INF)], 1), k,
            torch.cat([res_ids, nb], 1))
    return _finish(res_d, res_ids, q)


def graph_beam_search_iterative(
    queries: torch.Tensor,       # (Q, d) float32
    vectors: Optional[torch.Tensor],   # (n_pad, d); unused in packed mode
    norms: Optional[torch.Tensor],     # (n_pad,) float32
    role_bits: Optional[torch.Tensor],  # (n_pad, W) int32
    graph: torch.Tensor,         # (n_pad, M0) or, with pids, (P, n_class, M0)
    query_masks: torch.Tensor,   # (Q, W) int32
    entries: torch.Tensor,       # (Q,) int32 per-query entry nodes (local)
    k: int,
    ef: int,
    max_steps: int,
    harvest_2hop: bool = False,
    row_map: Optional[torch.Tensor] = None,   # (n_local,) or (P, n_class)
    metric: str = "l2",
    pids: Optional[torch.Tensor] = None,      # (Q,) int32 slab slots
    step_budget: Optional[torch.Tensor] = None,  # (Q,) int32 step caps
    packed_rows: Optional[torch.Tensor] = None,  # core.build_packed_graph_rows
    dq_scale: float = 1.0,
    q_center_dot: Optional[torch.Tensor] = None,  # (Q,) float32
    sync_every: int = SYNC_EVERY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The iterative-rescan filtered beam search (the reference's :343, see
    its docstring for the termination rule and the dedup by beam and
    history). Returns (dists (Q, k) ascending, local ids (Q, k))."""
    _check_metric(metric)
    q = queries.float()
    nq, d = q.shape
    dev = q.device
    multi = pids is not None
    m0 = graph.shape[-1]

    def neighbors(node):
        safe = node.clamp_min(0).long()
        return graph[pids.long(), safe] if multi else graph[safe]

    if packed_rows is not None:
        d_pad = packed_rows.shape[1] - 4 * query_masks.shape[1] - 4
        qp = q if d == d_pad else torch.nn.functional.pad(q, (0, d_pad - d))
        qcd = (torch.zeros(nq, device=dev) if q_center_dot is None
               else q_center_dot)

        def score_admit(ids):
            return graph_score_packed(ids.contiguous(), packed_rows, qp,
                                      query_masks, qcd, dq_scale, row_map,
                                      pids)
    else:
        score_admit = _unpacked_scorer(vectors, norms, role_bits,
                                       query_masks, q, row_map, pids)

    entry_ids = entries.to(torch.int32).reshape(nq, 1)
    entry_d, e_ok = score_admit(entry_ids)
    beam_ids = torch.cat([entry_ids, torch.full((nq, ef - 1), -1,
                                                dtype=torch.int32,
                                                device=dev)], 1)
    beam_d = torch.cat([entry_d, torch.full((nq, ef - 1), INF, device=dev)],
                       1)
    res_ids = torch.full((nq, k), -1, dtype=torch.int32, device=dev)
    res_d = torch.full((nq, k), INF, device=dev)
    res_ids[:, 0] = torch.where(e_ok[:, 0], entry_ids[:, 0], -1)
    res_d[:, 0] = torch.where(e_ok[:, 0], entry_d[:, 0], INF)
    w_d = beam_d.clone()
    history = torch.full((nq, max_steps), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(nq, device=dev)
    tri = (torch.arange(k, device=dev)[None, :]
           < torch.arange(k, device=dev)[:, None])[None]   # (1, k, k) j < i

    def done_at(t):
        fmin = beam_d.min(dim=1).values
        done = ~torch.isfinite(fmin) | ((fmin >= w_d[:, -1])
                                        & torch.isfinite(res_d[:, -1]))
        if step_budget is not None:
            done = done | (t >= step_budget)
        return done

    for t in range(max_steps):
        if t % sync_every == 0 and bool(done_at(t).all()):
            break
        with record_function("graph.step"):
            with record_function("graph.dedup"):
                sel = beam_d.argmin(dim=1)
                fmin = beam_d[rows, sel]
                active = torch.isfinite(fmin) & ~done_at(t)
                node = torch.where(active, beam_ids[rows, sel], -1)
                beam_d[rows, sel] = INF        # the pop, in place
                beam_ids[rows, sel] = -1
                history[:, t] = node
                nb = neighbors(node)
                nb = torch.where((node >= 0)[:, None], nb, -1)
                seen = ((nb[:, :, None] == beam_ids[:, None, :]).any(-1)
                        | (nb[:, :, None] == history[:, None, :]).any(-1))
                nb = torch.where(seen, -1, nb).contiguous()
            with record_function("graph.score"):
                nd, nb_ok = score_admit(nb)
            with record_function("graph.merge"):
                if harvest_2hop:
                    cand_ids, cand_d = _harvest(
                        graph, pids, nb, nd, nb_ok, res_ids, score_admit, k,
                        m0, tri)
                else:
                    cand_ids, cand_d = nb, torch.where(nb_ok, nd, INF)
                beam_d, beam_ids, w_d, res_d, res_ids = graph_merge_step(
                    beam_d, beam_ids, nd, nb, w_d, res_d, res_ids,
                    cand_d.contiguous(), cand_ids.contiguous())
    return _finish(res_d, res_ids, q)


def _harvest(graph, pids, nb, nd, nb_ok, res_ids, score_admit, k, m0, tri):
    """The 2-hop harvest's result candidates (the reference's :564-595):
    the admissible k nearest of the step's 2-hop ring, deduplicated
    against the results and within the hop, after the 1-hop arrivals."""
    nq = nb.shape[0]
    safe = nb.clamp_min(0).long()
    nb2 = graph[pids.long()[:, None], safe] if pids is not None \
        else graph[safe]
    nb2 = torch.where((nb >= 0)[:, :, None], nb2, -1).reshape(nq, m0 * m0)
    seen_res = (nb2[:, :, None] == res_ids[:, None, :]).any(-1)
    d2_raw, ok2_raw = score_admit(nb2.contiguous())
    ok2 = ok2_raw & ~seen_res
    nd2 = torch.where(ok2, d2_raw, INF)
    nb2 = torch.where(ok2, nb2, -1)
    hv_d, hv_ids = _stable_smallest(nd2, k, nb2)
    dup = ((hv_ids[:, :, None] == hv_ids[:, None, :]) & tri).any(-1)
    hv_d = torch.where(dup, INF, hv_d)
    hv_ids = torch.where(dup, -1, hv_ids)
    nb_in_res = (nb[:, :, None] == res_ids[:, None, :]).any(-1)
    cand_ids = torch.cat([nb, hv_ids], 1)
    cand_d = torch.cat([torch.where(nb_ok & ~nb_in_res, nd, INF), hv_d], 1)
    return cand_ids, cand_d
