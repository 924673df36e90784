"""Batched HNSW graph beam search: the fused search kernel, and the step
loop in PyTorch with the graph step's kernels.

Counterpart of vectorsearch_rbac_tpu/ops/graph_search.py: Q queries
advance together; each step expands one frontier node per query, gathers
its neighbour row, scores the neighbours and merges them into an
unfiltered traversal beam and a permission-filtered result list.
Traversal ignores permissions (inadmissible nodes still route); results
admit only rows whose bitset meets the query's mask.

- `graph_beam_search` (the reference's :45): the fixed-budget traversal
  the builder's refinement pass runs, and HNSWIndex's default search.
- `graph_beam_search_filtered` (:187): the ACORN two-hop harvest over the
  fixed-budget traversal (HNSWIndex's filtered_traversal): navigation
  takes the unfiltered one-hop beam update, the results take the
  admissible nodes of the expanded node's 1- and 2-hop rings.
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

A physical HNSW partition's own packed table (`PackedCopy`) serves the
iterative search as packed rows with no row map; the fixed-budget and
filtered traversals read it as unpacked rows, each gathered code
dequantized (exact on the lossless arenas such a table is built for).

The step loop's state layout is the reference's: a pop leaves +inf and id
-1 in the popped slot, and every merge keeps the lower position first
among equal values (lax.top_k's order), so ids and distances come out
equal to the reference's on the same inputs. The reference's
lax.while_loop becomes a Python loop that asks the device whether every
query is done only every `sync_every` steps: a query that is done keeps
popping its beam, but every candidate it adds is -1/+inf, so its results,
its window and its done test do not move, and the outputs equal those of
a test at every step.

Metric, as the reference's dist_to: l2 scores norm - 2 dots (the query
norm is added back at the finish), ip and cosine -dots (cosine queries are
normalised at the top; the finish maps cosine to clip(1 + s, 0, 2)), l1
the float32 sum of |x - q| (no dot-product form: unpacked rows only).
Packed rows serve l2, ip and cosine; l1 with packed rows raises, as the
reference's assert does. The fixed-budget and filtered traversals stay
PyTorch: no pallas_call lies under them in the reference.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from . import _build
from .graph_step import (_same_device, candidate_rows, graph_merge_step,
                         graph_merge_step_plain, graph_score_packed,
                         graph_score_packed_plain, packed_form)

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


METRICS = ("l2", "ip", "cosine", "l1")


def _prepared(queries: torch.Tensor, metric: str,
              packed: bool = False) -> torch.Tensor:
    """float32 queries, unit rows for cosine (the reference's :69-70);
    raises for an unknown metric, or for l1 with packed rows."""
    if metric not in METRICS:
        raise ValueError(f"graph search metric {metric!r} (one of "
                         f"{METRICS})")
    if packed:
        packed_form(metric)
    q = queries.float()
    if metric == "cosine":
        q = q / torch.clamp_min(
            torch.linalg.vector_norm(q, dim=1, keepdim=True), 1e-30)
    return q


def _stable_smallest(d, width, *carried):
    """The `width` smallest values of each row, ascending, ties in position
    order, and the carried tensors gathered alike."""
    v, pos = torch.sort(d, dim=1, stable=True)
    pos = pos[:, :width]
    return (v[:, :width], *(c.gather(1, pos) for c in carried))


@dataclass(frozen=True)
class PackedCopy:
    """A physical HNSW partition's own packed rows (core.
    build_packed_graph_rows over its rows, by local id) read as unpacked
    rows: a row's code dequantized (code / scale + center), its norm and
    bitset words read from the row. Built only on lossless int8 arenas,
    where the dequantized rows are the values of the reference's gathered
    bfloat16 copy exactly; queries are rounded to `dtype`, the arena's
    row dtype, as against that copy."""

    rows: torch.Tensor       # (n_pad, d_pad + 4W + 4) int8
    d: int
    scale: float
    center: torch.Tensor     # (d,) float32, on the table's device
    dtype: torch.dtype       # the arena's row dtype

    def gather(self, rows: torch.Tensor):
        """(x (..., d) float32, norms (...,) float32, bits (..., W) int32)
        of the table rows `rows`."""
        r = self.rows[rows]
        d_pad = ((self.d + 127) // 128) * 128
        x = r[..., :self.d].float() / self.scale + self.center
        bits = r[..., d_pad:-4].contiguous().view(torch.int32)
        return x, r[..., -4:].contiguous().view(torch.float32)[..., 0], bits


def _unpacked_scorer(vectors, norms, role_bits, query_masks, q, row_map,
                     pids=None, metric="l2"):
    """(scores, admissible) of (Q, C) candidate ids from the separate
    vector, norm and bitset tables (the reference's dist_to and allowed),
    or from a PackedCopy in `vectors` (its own bits unless `role_bits` is
    given). For l2, ip and cosine the query is rounded to the table's
    dtype, as the reference's is, and the dots are float32 sums of
    products that are exact in float32 (bfloat16 or float32 operands); l1
    sums |x - q| over the rows in float32 against the float32 query."""
    copy = vectors if isinstance(vectors, PackedCopy) else None
    qc = q.to(vectors.dtype).float()

    def score_admit(ids):
        rows = candidate_rows(ids, row_map, pids).clamp_min(0).long()
        valid = ids >= 0
        if copy is not None:
            x, nrm, bits = copy.gather(rows)
            if role_bits is not None:
                bits = role_bits[rows]
        else:
            x = vectors[rows].float()                             # (Q, C, d)
            nrm = norms[rows] if metric == "l2" else None
            bits = role_bits[rows]                                # (Q, C, W)
        if metric == "l1":
            s = (x - q[:, None, :]).abs().sum(dim=-1)
        else:
            dots = torch.einsum("qd,qcd->qc", qc, x)
            s = nrm - 2.0 * dots if metric == "l2" else -dots
        s = torch.where(valid, s, INF)
        ok = ((bits & query_masks[:, None, :]) != 0).any(dim=-1)
        return s, ok & valid
    return score_admit


def _finish(res_d, res_ids, q, metric="l2"):
    """The reference's finalisation (:165-173, :320-328, :610-619): l2
    squared distances with the query norm added back and clamped at 0,
    cosine clip(1 + s, 0, 2), ip and l1 raw; +inf / -1 where a slot is
    empty."""
    empty = torch.isinf(res_d)
    if metric == "l2":
        fin = (res_d + (q * q).sum(dim=1, keepdim=True)).clamp_min(0.0)
    elif metric == "cosine":
        fin = (1.0 + res_d).clamp(0.0, 2.0)
    else:
        fin = res_d
    dists = torch.where(empty, INF, fin)
    return dists, torch.where(empty, -1, res_ids)


def _fixed_start(score_admit, entry: int, nq: int, k: int, ef: int, dev):
    """The fixed-budget traversals' state at the entry: the beam (ids,
    values, expanded flags) holds the entry alone, unexpanded; the results
    hold it if it is admissible; the history is empty."""
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
    return beam_ids, beam_d, beam_exp, res_ids, res_d, history


def _fixed_expand(t, graph, beam_ids, beam_d, beam_exp, history):
    """One expansion of the fixed-budget traversals: the nearest
    unexpanded beam node is flagged and logged (-1 where none is left);
    returns its neighbour row (-1 rows for -1) and that row with the nodes
    already in the beam or the history dropped."""
    rows = torch.arange(beam_d.shape[0], device=beam_d.device)
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
    return nb, torch.where(seen, -1, nb)


def _fixed_beam_merge(beam_d, beam_ids, beam_exp, nd, nb):
    """The beam's merge: the ef smallest of beam and candidates, the
    candidates unexpanded."""
    return _stable_smallest(
        torch.cat([beam_d, nd], 1), beam_d.shape[1],
        torch.cat([beam_ids, nb], 1),
        torch.cat([beam_exp, torch.zeros_like(nb, dtype=torch.bool)], 1))


def graph_beam_search(queries, vectors, norms, role_bits, graph, query_masks,
                      entry: int, k: int, ef: int, row_map=None,
                      metric: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """The fixed-budget traversal: ef - 1 expansions from one entry node,
    the beam keeps expanded nodes (flagged), the results admit permitted
    rows. Returns (dists (Q, k) ascending, local ids (Q, k))."""
    q = _prepared(queries, metric)
    score_admit = _unpacked_scorer(vectors, norms, role_bits, query_masks, q,
                                   row_map, metric=metric)
    beam_ids, beam_d, beam_exp, res_ids, res_d, history = _fixed_start(
        score_admit, entry, q.shape[0], k, ef, q.device)
    for t in range(1, ef):
        with record_function("graph.beam.expand"):
            _, nb = _fixed_expand(t, graph, beam_ids, beam_d, beam_exp,
                                  history)
        with record_function("graph.beam.score"):
            nd, ok = score_admit(nb)
        with record_function("graph.beam.merge"):
            beam_d, beam_ids, beam_exp = _fixed_beam_merge(
                beam_d, beam_ids, beam_exp, nd, nb)
            res_d, res_ids = _stable_smallest(
                torch.cat([res_d, torch.where(ok, nd, INF)], 1), k,
                torch.cat([res_ids, nb], 1))
    return _finish(res_d, res_ids, q, metric)


def graph_beam_search_filtered(queries, vectors, norms, role_bits, graph,
                               query_masks, entry: int, k: int, ef: int,
                               row_map=None, metric: str = "l2"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ACORN two-hop harvest (the reference's :187): the fixed-budget
    traversal's ef - 1 expansions, navigation by the unfiltered one-hop
    beam update, while each expansion harvests the admissible nodes of the
    expanded node's (Q, M0 + M0^2) 1- and 2-hop candidates into the
    results: those already in the results are dropped, the k nearest taken
    (ties in position order), and in-hop duplicates (a node reached through
    several parents) dropped after the first. Returns (dists (Q, k)
    ascending, local ids (Q, k))."""
    q = _prepared(queries, metric)
    nq, m0, dev = q.shape[0], graph.shape[1], q.device
    score_admit = _unpacked_scorer(vectors, norms, role_bits, query_masks, q,
                                   row_map, metric=metric)
    beam_ids, beam_d, beam_exp, res_ids, res_d, history = _fixed_start(
        score_admit, entry, nq, k, ef, dev)
    tri = (torch.arange(k, device=dev)[None, :]
           < torch.arange(k, device=dev)[:, None])[None]   # (1, k, k) j < i
    for t in range(1, ef):
        with record_function("graph.filtered.navigate"):
            nb1, nav = _fixed_expand(t, graph, beam_ids, beam_d, beam_exp,
                                     history)
            nav_d, _ = score_admit(nav)
            beam_d, beam_ids, beam_exp = _fixed_beam_merge(
                beam_d, beam_ids, beam_exp, nav_d, nav)
        with record_function("graph.filtered.harvest"):
            nb2 = graph[nb1.clamp_min(0).long()]                 # (Q, M0, M0)
            nb2 = torch.where((nb1 >= 0)[:, :, None], nb2, -1)
            cand = torch.cat([nb1, nb2.reshape(nq, m0 * m0)], 1)
            seen_res = (cand[:, :, None] == res_ids[:, None, :]).any(-1)
            cd, ok = score_admit(cand)
            ok = ok & ~seen_res
            hv_d, hv_ids = _stable_smallest(torch.where(ok, cd, INF), k,
                                            torch.where(ok, cand, -1))
            dup = ((hv_ids[:, :, None] == hv_ids[:, None, :]) & tri).any(-1)
            res_d, res_ids = _stable_smallest(
                torch.cat([res_d, torch.where(dup, INF, hv_d)], 1), k,
                torch.cat([res_ids, torch.where(dup, -1, hv_ids)], 1))
    return _finish(res_d, res_ids, q, metric)


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
    and KS6 on the card and take their plain versions on the CPU. Packed
    rows take l2, ip and cosine (KS7's and the fused kernel's two score
    forms); unpacked rows every metric."""
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
                    step_budget, metric=metric)
    return _step_loop(queries, vectors, norms, role_bits, graph, query_masks,
                      entries, k, ef, max_steps, harvest_2hop, row_map, pids,
                      step_budget, packed_rows, dq_scale, q_center_dot,
                      sync_every, graph_score_packed, graph_merge_step,
                      metric=metric)


def graph_beam_search_iterative_plain(
    queries, vectors, norms, role_bits, graph, query_masks, entries, k, ef,
    max_steps, harvest_2hop=False, row_map=None, metric="l2", pids=None,
    step_budget=None, packed_rows=None, dq_scale=1.0, q_center_dot=None,
    sync_every=SYNC_EVERY, stats=None):
    """The step loop with the plain score and merge on any device: the
    fused kernel's plain version (and the harvest's). `stats`, a (2,) int64
    tensor, gains the expansions and the scored 1-hop candidates, as the
    fused kernel counts them."""
    return _step_loop(queries, vectors, norms, role_bits, graph, query_masks,
                      entries, k, ef, max_steps, harvest_2hop, row_map, pids,
                      step_budget, packed_rows, dq_scale, q_center_dot,
                      sync_every, graph_score_packed_plain,
                      graph_merge_step_plain, stats, metric)


def graph_search_fused(queries, graph, query_masks, entries, k, ef,
                       max_steps, packed_rows, dq_scale=1.0,
                       q_center_dot=None, row_map=None, pids=None,
                       step_budget=None, stats=None, metric="l2"):
    """The packed-row iterative search without harvest, the whole loop in
    one launch of csrc/graph_step.cu graph_search_fused_kernel on CUDA
    tensors (its l2 form, or its inner-product form for ip and cosine);
    CPU tensors take its plain version, the step loop with the plain score
    and merge. Arguments as graph_beam_search_iterative's; `stats` as
    graph_beam_search_iterative_plain's.

    The kernel takes the shapes `fused_shape_problems` passes, with int32
    graph, row map, slots, entries and budgets; anything else raises
    ValueError."""
    q = _prepared(queries, metric, packed=True)
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
            max_steps, False, row_map, metric, pids, step_budget,
            packed_rows, dq_scale, q_center_dot, stats=stats)
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
        k, max_steps, int(metric != "l2"), _build.stream_ptr(dev))
    _build.check(err, "vsr_graph_search_fused")
    _build.LAUNCHES["graph_search"] += 1
    _build.LAUNCHES["graph_search_ip"] += metric != "l2"
    return _finish(res_d, res_ids, q, metric)


def _step_loop(queries, vectors, norms, role_bits, graph, query_masks,
               entries, k, ef, max_steps, harvest_2hop, row_map, pids,
               step_budget, packed_rows, dq_scale, q_center_dot, sync_every,
               score_packed, merge_step, stats=None, metric="l2"):
    """The reference's lax.while_loop as a Python loop over steps, with the
    given packed-row scorer and merge (the kernels' wrappers or their plain
    versions)."""
    q = _prepared(queries, metric, packed=packed_rows is not None)
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
                                query_masks, qcd, dq_scale, row_map, pids,
                                metric)
    else:
        score_admit = _unpacked_scorer(vectors, norms, role_bits,
                                       query_masks, q, row_map, pids, metric)

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
    return _finish(res_d, res_ids, q, metric)


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
