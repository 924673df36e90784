"""Batched HNSW graph beam search: the fused search kernel, and the step
loop in PyTorch with the graph step's kernels.

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
  harvest, and the packed-row scoring. On CUDA tensors in packed mode
  without the harvest (the hybrid executor's path), at a shape the fused
  kernel takes (`fused_shape_problems`), the whole search is one launch
  of `graph_search_fused` (csrc/graph_step.cu, see the note there), which
  keeps each query's state on chip from the first pop to the last merge.
  Every other combination runs the step loop: its step
  runs the two kernels of ops/graph_step.py (score and merge); the
  neighbour gather and the dedup against beam and history stay PyTorch.
- `graph_beam_search_iterative_plain`: the step loop with the plain score
  and merge on any device, the fused kernel's plain version.

The step loop's state layout is the reference's: a pop leaves +inf and id
-1 in the popped slot, and every merge keeps the lower position first
among equal values (lax.top_k's order), so ids and distances come out
equal to the reference's on the same inputs. The reference's
lax.while_loop becomes a Python loop that asks the device whether every
query is done only every `sync_every` steps: a query that is done keeps
popping its beam, but every candidate it adds is -1/+inf, so its results,
its window and its done test do not move, and the outputs equal those of
a test at every step.

Metric: l2 only (the port's partitions serve l2); ip, cosine and l1 graph
scoring raise (ROADMAP queue 1 item 11). The ACORN filtered traversal
(`graph_beam_search_filtered`, :187) waits with the ACORN builder.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from . import _build
from .graph_step import (_same_device, candidate_rows, graph_merge_step,
                         graph_merge_step_plain, graph_score_packed,
                         graph_score_packed_plain)

INF = float("inf")
SYNC_EVERY = 8   # steps between the host's "all done?" reads
# the fused kernel's shapes (csrc/graph_step.cu vsr_graph_search_fused)
FUSED_D_PAD = (128, 256, 768)
FUSED_MAX_M0 = 64
FUSED_MAX_EF = 512
FUSED_MAX_STEPS = 4096


def fused_shape_problems(w: int, d_pad: int, d: int, m0: int, k: int,
                         ef: int, max_steps: int) -> list:
    """What the fused kernel does not take of a search's shape (empty if
    it takes it): any number of bitset words, d_pad 128, 256 or 768 (at
    least d), M0 <= 64, 1 <= k <= ef <= 512, max_steps <= 4096."""
    return [msg for bad, msg in (
        (w < 1, f"{w} bitset words (at least 1)"),
        (d_pad not in FUSED_D_PAD or d > d_pad,
         f"d_pad {d_pad} for d {d} (one of {FUSED_D_PAD})"),
        (not 1 <= m0 <= FUSED_MAX_M0, f"M0 {m0} (1-{FUSED_MAX_M0})"),
        (not 1 <= k <= ef <= FUSED_MAX_EF,
         f"k {k}, ef {ef} (1 <= k <= ef <= {FUSED_MAX_EF})"),
        (not 0 <= max_steps <= FUSED_MAX_STEPS,
         f"max_steps {max_steps} (0-{FUSED_MAX_STEPS})"),
    ) if bad]


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
    history). Returns (dists (Q, k) ascending, local ids (Q, k)).

    On CUDA tensors in packed mode without the 2-hop harvest, at a shape
    the fused kernel takes (`fused_shape_problems`), the whole search is
    one launch of it (`graph_search_fused`). Every other combination, and
    every CPU call, runs the step loop, whose score and merge launch KS7
    and KS6 on the card and take their plain versions on the CPU."""
    _check_metric(metric)
    if packed_rows is not None and queries.device.type == "cuda":
        w = query_masks.shape[1]
        d_pad = packed_rows.shape[1] - 4 * w - 4
        if not harvest_2hop and not fused_shape_problems(
                w, d_pad, queries.shape[1], graph.shape[-1], k, ef,
                max_steps):
            with record_function("graph.search"):
                return graph_search_fused(
                    queries, graph, query_masks, entries, k, ef, max_steps,
                    packed_rows, dq_scale, q_center_dot, row_map, pids,
                    step_budget)
    return _step_loop(queries, vectors, norms, role_bits, graph, query_masks,
                      entries, k, ef, max_steps, harvest_2hop, row_map, pids,
                      step_budget, packed_rows, dq_scale, q_center_dot,
                      sync_every, graph_score_packed, graph_merge_step)


def graph_beam_search_iterative_plain(
    queries, vectors, norms, role_bits, graph, query_masks, entries, k, ef,
    max_steps, harvest_2hop=False, row_map=None, metric="l2", pids=None,
    step_budget=None, packed_rows=None, dq_scale=1.0, q_center_dot=None,
    sync_every=SYNC_EVERY, stats=None):
    """The step loop with the plain score and merge on any device: the
    fused kernel's plain version (and the harvest's). `stats`, a (2,) int64
    tensor, gains the expansions and the scored 1-hop candidates, as the
    fused kernel counts them."""
    _check_metric(metric)
    return _step_loop(queries, vectors, norms, role_bits, graph, query_masks,
                      entries, k, ef, max_steps, harvest_2hop, row_map, pids,
                      step_budget, packed_rows, dq_scale, q_center_dot,
                      sync_every, graph_score_packed_plain,
                      graph_merge_step_plain, stats)


def graph_search_fused(queries, graph, query_masks, entries, k, ef,
                       max_steps, packed_rows, dq_scale=1.0,
                       q_center_dot=None, row_map=None, pids=None,
                       step_budget=None, stats=None):
    """The packed-row iterative search without harvest, the whole loop in
    one launch of csrc/graph_step.cu graph_search_fused_kernel on CUDA
    tensors; CPU tensors take its plain version, the step loop with the
    plain score and merge. Arguments as graph_beam_search_iterative's;
    `stats` as graph_beam_search_iterative_plain's.

    The kernel takes the shapes `fused_shape_problems` passes, with int32
    graph, row map, slots, entries and budgets; anything else raises
    ValueError."""
    q = queries.float()
    nq, d = q.shape
    w = query_masks.shape[1]
    d_pad = packed_rows.shape[1] - 4 * w - 4
    m0 = graph.shape[-1]
    multi = pids is not None
    problems = fused_shape_problems(w, d_pad, d, m0, k, ef, max_steps) + [
        msg for bad, msg in (
            (graph.dim() != (3 if multi else 2) or (row_map is not None and (
                row_map.dim() != graph.dim() - 1 or (multi and tuple(
                    row_map.shape) != tuple(graph.shape[:2])))),
             f"graph {tuple(graph.shape)}, row map "
             f"{None if row_map is None else tuple(row_map.shape)}"),
            (multi and row_map is None, "slots without a (P, n_class) row map"),
            (query_masks.shape[0] != nq or entries.numel() != nq or any(
                t is not None and t.numel() != nq
                for t in (pids, step_budget, q_center_dot)),
             "per-query operands that do not pair with the queries"),
        ) if bad]
    if problems:
        raise ValueError("graph_search_fused does not take: "
                         + "; ".join(problems))
    dev = _same_device(q, graph, query_masks, entries, packed_rows,
                       q_center_dot, row_map, pids, step_budget, stats)
    if dev.type == "cpu":
        return graph_beam_search_iterative_plain(
            queries, None, None, None, graph, query_masks, entries, k, ef,
            max_steps, False, row_map, "l2", pids, step_budget, packed_rows,
            dq_scale, q_center_dot, stats=stats)
    for name, t, dt in (("graph", graph, torch.int32),
                        ("query_masks", query_masks, torch.int32),
                        ("entries", entries, torch.int32),
                        ("packed_rows", packed_rows, torch.int8),
                        ("row_map", row_map, torch.int32),
                        ("pids", pids, torch.int32),
                        ("step_budget", step_budget, torch.int32),
                        ("q_center_dot", q_center_dot, torch.float32),
                        ("stats", stats, torch.int64)):
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError(f"graph_search_fused: {name} must be a "
                             f"contiguous {dt} tensor, not {t.dtype}")
    qp = (q if d == d_pad else torch.nn.functional.pad(q, (0, d_pad - d))
          ).contiguous()
    qcd = (torch.zeros(nq, device=dev) if q_center_dot is None
           else q_center_dot)
    res_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    res_ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().vsr_graph_search_fused(
        qp.data_ptr(), query_masks.data_ptr(), qcd.data_ptr(),
        ctypes.c_float(dq_scale), packed_rows.data_ptr(),
        packed_rows.shape[1], graph.data_ptr(), m0, ptr(row_map), ptr(pids),
        graph.shape[1] if multi else 0, entries.data_ptr(), ptr(step_budget),
        res_d.data_ptr(), res_ids.data_ptr(), ptr(stats), nq, d_pad, w, ef,
        k, max_steps, _build.stream_ptr(dev))
    _build.check(err, "vsr_graph_search_fused")
    _build.LAUNCHES["graph_search"] += 1
    return _finish(res_d, res_ids, q)


def _step_loop(queries, vectors, norms, role_bits, graph, query_masks,
               entries, k, ef, max_steps, harvest_2hop, row_map, pids,
               step_budget, packed_rows, dq_scale, q_center_dot, sync_every,
               score_packed, merge_step, stats=None):
    """The reference's lax.while_loop as a Python loop over steps, with the
    given packed-row scorer and merge (the kernels' wrappers or their plain
    versions)."""
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
            return score_packed(ids.contiguous(), packed_rows, qp,
                                query_masks, qcd, dq_scale, row_map, pids)
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
            if stats is not None:
                stats += torch.stack([(node >= 0).sum(),
                                      torch.isfinite(nd).sum()])
            with record_function("graph.merge"):
                if harvest_2hop:
                    cand_ids, cand_d = _harvest(
                        graph, pids, nb, nd, nb_ok, res_ids, score_admit, k,
                        m0, tri)
                else:
                    cand_ids, cand_d = nb, torch.where(nb_ok, nd, INF)
                beam_d, beam_ids, w_d, res_d, res_ids = merge_step(
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
