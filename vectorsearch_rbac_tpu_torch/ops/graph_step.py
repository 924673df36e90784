"""The graph step's two kernels: packed-row candidate scoring and the
step's three stable merges. The step loop of ops/graph_search.py runs
them where the fused search does not apply (the 2-hop harvest, shapes
past the fused kernel's); the fused search
(graph_search.graph_search_fused) does both inside its own loop.

Counterparts of the two TPU kernels of the HNSW step
(vectorsearch_rbac_tpu/ops/graph_search.py graph_beam_search_iterative):

- `graph_score_packed` computes what scripts/r5_graph_fused_probe.py
  pallas_dma_gather serves: one gather of a candidate's packed row
  (core.build_packed_graph_rows: int8 code, bitset words, float32 norm)
  and its score and admissibility: l2's norm - 2 dots, or the
  inner-product form -dots on ip and cosine arenas (the reference's
  packed score_admit, graph_search.py:476-493; cosine queries come unit);
- `graph_merge_step` is scripts/pallas_merge_probe.py merge_step: the
  beam, window and result merges of one step.

Both are the hand-written CUDA kernels of csrc/graph_step.cu (see the note
there); the `_plain` functions are their PyTorch versions, taken for CPU
tensors and used on the card as the reference the kernels are checked
against. A CUDA tensor launches the kernel or raises.

Tolerance: on integer-valued data (the SIFT family, lossless int8 arenas)
the kernels are bit-identical to their plain versions. On other data the
score kernel sums the dot in another order: two orders of a float32 sum
of d_pad terms differ by at most 2 * d_pad * 2^-24 * sum_d |q_d * code_d|
(the recursive-summation bound), so the scores agree to that times 2 *
dq_scale plus a few ulps of the score (2^-20 * |score|). The merge kernel
is exact on any NaN-free input.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

INF = float("inf")
PACKED_METRICS = ("l2", "ip", "cosine")   # l1 has no packed-row form


def packed_form(metric: str) -> bool:
    """True for the inner-product score form (ip, cosine), False for l2's;
    l1, which has no dot-product form, raises."""
    if metric not in PACKED_METRICS:
        raise ValueError(f"packed-row graph scoring has no {metric!r} form "
                         f"(one of {PACKED_METRICS})")
    return metric != "l2"


def _same_device(*tensors) -> torch.device:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"graph step operands lie on several devices: "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


def candidate_rows(ids: torch.Tensor, row_map: Optional[torch.Tensor] = None,
                   pids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Q, C) local ids -> arena rows, -1 where the id is -1: row_map[pids[q],
    id] with a (P, n_class) slab and per-query pids, row_map[id] with one
    (n_local,) map, the id itself without a map."""
    safe = ids.clamp_min(0).long()
    if row_map is None:
        rows = safe.to(torch.int32)
    elif pids is not None:
        rows = row_map[pids.long()[:, None], safe]
    else:
        rows = row_map[safe]
    return torch.where(ids >= 0, rows, -1)


def graph_score_packed_plain(ids, packed_rows, qf, qmask, qcd, dq_scale,
                             row_map=None, pids=None, metric="l2"):
    """Plain version of the score kernel: ((Q, C) float32 scores in the
    metric's form, (Q, C) bool admissible), +inf and False where a
    candidate is -1. The reference's packed score_admit
    (graph_search.py:475-493), with the bitset words in place of the TPU
    row's role one-hot."""
    ip = packed_form(metric)
    rows = candidate_rows(ids, row_map, pids)
    valid = rows >= 0
    w = qmask.shape[1]
    d_pad = packed_rows.shape[1] - 4 * w - 4
    r = packed_rows[rows.clamp_min(0).long()]              # (Q, C, unit)
    dots = (torch.einsum("qd,qcd->qc", qf, r[..., :d_pad].float())
            * dq_scale + qcd[:, None])
    nrm = r[..., d_pad + 4 * w:].contiguous().view(torch.float32)[..., 0]
    bits = r[..., d_pad:d_pad + 4 * w].contiguous().view(torch.int32)
    admit = ((bits & qmask[:, None, :]) != 0).any(dim=-1)
    return (torch.where(valid, -dots if ip else nrm - 2.0 * dots, INF),
            admit & valid)


def graph_score_packed(ids: torch.Tensor, packed_rows: torch.Tensor,
                       qf: torch.Tensor, qmask: torch.Tensor,
                       qcd: torch.Tensor, dq_scale: float,
                       row_map: Optional[torch.Tensor] = None,
                       pids: Optional[torch.Tensor] = None,
                       metric: str = "l2"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score and admit (Q, C) candidates from their packed rows, in l2 or,
    on ip and cosine arenas (cosine queries unit), the inner-product form.

    ids (Q, C) int32 local ids (-1 pads); packed_rows (Npad, d_pad + 4W +
    4) int8; qf (Q, d_pad) float32 queries zero-padded to d_pad; qmask (Q,
    W) int32 bitset words; qcd (Q,) float32 query . quant center; row_map
    None, (n_local,) or, with pids (Q,), a (P, n_class) slab, int32. CPU
    tensors take the plain version; CUDA tensors launch csrc/graph_step.cu
    graph_score_packed_kernel, which takes any number of bitset words and
    any d_pad that is a multiple of 128 (the launch is refused otherwise)."""
    ip = packed_form(metric)
    dev = _same_device(ids, packed_rows, qf, qmask, qcd, row_map, pids)
    nq, c = ids.shape
    w = qmask.shape[1]
    d_pad = packed_rows.shape[1] - 4 * w - 4
    if qf.shape != (nq, d_pad) or qmask.shape[0] != nq \
            or qcd.shape != (nq,) or (pids is not None and (
                row_map is None or row_map.dim() != 2 or pids.shape != (nq,))):
        raise ValueError(f"graph_score_packed: ids {tuple(ids.shape)}, qf "
                         f"{tuple(qf.shape)} (d_pad {d_pad}), qmask "
                         f"{tuple(qmask.shape)}, qcd {tuple(qcd.shape)}, "
                         "pids need a (P, n_class) row map")
    if dev.type == "cpu":
        return graph_score_packed_plain(ids, packed_rows, qf, qmask, qcd,
                                        dq_scale, row_map, pids, metric)
    for name, t, dt in (("ids", ids, torch.int32), ("packed_rows",
                        packed_rows, torch.int8), ("qf", qf, torch.float32),
                        ("qmask", qmask, torch.int32),
                        ("qcd", qcd, torch.float32), ("row_map", row_map,
                        torch.int32), ("pids", pids, torch.int32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError(f"graph_score_packed: {name} must be a "
                             f"contiguous {dt} tensor, not {t.dtype}")
    out_s = torch.empty((nq, c), dtype=torch.float32, device=dev)
    out_ok = torch.empty((nq, c), dtype=torch.bool, device=dev)
    n_class = row_map.shape[1] if pids is not None else 0
    ptr = lambda t: None if t is None else t.data_ptr()
    err = _build.lib().vsr_graph_score_packed(
        ids.data_ptr(), ptr(row_map), ptr(pids), n_class,
        packed_rows.data_ptr(), packed_rows.shape[1], qf.data_ptr(),
        qmask.data_ptr(), qcd.data_ptr(), ctypes.c_float(dq_scale),
        out_s.data_ptr(), out_ok.data_ptr(), nq, c, d_pad, w, int(ip),
        _build.stream_ptr(dev))
    _build.check(err, "vsr_graph_score_packed")
    _build.LAUNCHES["graph_score"] += 1
    _build.LAUNCHES["graph_score_ip"] += ip
    return out_s, out_ok


def _stable_smallest(d, ids, width):
    v, pos = torch.sort(d, dim=1, stable=True)
    return v[:, :width], None if ids is None else ids.gather(1, pos[:, :width])


def graph_merge_step_plain(beam_d, beam_ids, nd, nb, w_d, res_d, res_ids,
                           cand_d, cand_ids):
    """Plain version of the merge kernel: the smallest ef of concat(beam,
    candidates), ef of concat(window, candidate values) and kk of
    concat(results, result candidates), ascending, ties in concatenation
    order (lax.top_k's order of the negated values)."""
    ef, kk = beam_d.shape[1], res_d.shape[1]
    bd, bi = _stable_smallest(torch.cat([beam_d, nd], 1),
                              torch.cat([beam_ids, nb], 1), ef)
    wd, _ = _stable_smallest(torch.cat([w_d, nd], 1), None, ef)
    rd, ri = _stable_smallest(torch.cat([res_d, cand_d], 1),
                              torch.cat([res_ids, cand_ids], 1), kk)
    return bd, bi, wd, rd, ri


def graph_merge_step(beam_d: torch.Tensor, beam_ids: torch.Tensor,
                     nd: torch.Tensor, nb: torch.Tensor, w_d: torch.Tensor,
                     res_d: torch.Tensor, res_ids: torch.Tensor,
                     cand_d: torch.Tensor, cand_ids: torch.Tensor):
    """One graph step's three merges -> (beam_d, beam_ids (Q, ef), w_d (Q,
    ef), res_d, res_ids (Q, kk)). The beam and window take the step's (Q, C)
    candidates (nd, nb); the results take (Q, Cr) result candidates (C wide,
    or C + kk under the 2-hop harvest). Values float32, ids int32. CPU
    tensors take the plain version; CUDA tensors launch csrc/graph_step.cu
    graph_merge_step_kernel."""
    ops = (beam_d, beam_ids, nd, nb, w_d, res_d, res_ids, cand_d, cand_ids)
    dev = _same_device(*ops)
    nq, ef = beam_d.shape
    c, kk, cr = nd.shape[1], res_d.shape[1], cand_d.shape[1]
    shapes = [(nq, ef), (nq, ef), (nq, c), (nq, c), (nq, ef), (nq, kk),
              (nq, kk), (nq, cr), (nq, cr)]
    if [tuple(t.shape) for t in ops] != shapes:
        raise ValueError("graph_merge_step: shapes "
                         f"{[tuple(t.shape) for t in ops]} do not pair up")
    if dev.type == "cpu":
        return graph_merge_step_plain(*ops)
    values = (beam_d, nd, w_d, res_d, cand_d)
    id_lists = (beam_ids, nb, res_ids, cand_ids)
    if any(t.dtype != torch.float32 for t in values) \
            or any(t.dtype != torch.int32 for t in id_lists) \
            or not all(t.is_contiguous() for t in ops):
        raise ValueError("graph_merge_step takes contiguous float32 values "
                         "and int32 ids")
    o_bd = torch.empty_like(beam_d)
    o_bi = torch.empty_like(beam_ids)
    o_wd = torch.empty_like(w_d)
    o_rd = torch.empty_like(res_d)
    o_ri = torch.empty_like(res_ids)
    err = _build.lib().vsr_graph_merge_step(
        *(t.data_ptr() for t in ops), o_bd.data_ptr(), o_bi.data_ptr(),
        o_wd.data_ptr(), o_rd.data_ptr(), o_ri.data_ptr(), nq, ef, c, kk, cr,
        _build.stream_ptr(dev))
    _build.check(err, "vsr_graph_merge_step")
    _build.LAUNCHES["graph_merge"] += 1
    return o_bd, o_bi, o_wd, o_rd, o_ri
