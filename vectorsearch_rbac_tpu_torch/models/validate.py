"""Model validation: predicted against measured recall and query-time
curves.

A copy of vectorsearch_rbac_tpu/models/validate.py, its searches on the
port's HNSWIndex and IVFIndex on the arena's device: sweep an index's
search width (ef for HNSW, nprobe for IVF), measure recall against exact
ground truth and wall time, fit the models and report the errors, as
JSON-able dicts. tests/test_torch_fitting.py holds the sweeps' recalls
equal to the reference's on the same graph.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from ..bench.ground_truth import compute_recall
from .cost import CostModelParams, QueryTimeModel, RecallModel
from .fitting import (fit_qps_params, fit_recall_params,
                      fit_recall_params_joint)

SearchFn = Callable[[np.ndarray, np.ndarray, int, int], Tuple[np.ndarray, np.ndarray]]
# (queries, masks, k, ef) -> (dists, ids)


def sweep_search_width(
    search_fn: SearchFn,
    queries: np.ndarray,
    masks: np.ndarray,
    truth_ids: np.ndarray,
    k: int,
    efs: Sequence[int],
    timing_reps: int = 2,
) -> Dict[str, List[float]]:
    """Measure (recall, seconds/query) at each search width (the reference's
    ef sweep, analysis_hnsw_recall.py:509)."""
    recalls, times = [], []
    for ef in efs:
        search_fn(queries, masks, k, ef)  # warm
        t0 = time.perf_counter()
        for _ in range(timing_reps):
            d, ids = search_fn(queries, masks, k, ef)
        dt = (time.perf_counter() - t0) / timing_reps / len(queries)
        recalls.append(compute_recall(ids, truth_ids))
        times.append(dt)
    return {"efs": [float(e) for e in efs], "recalls": recalls,
            "times_s": times}


def fit_from_sweep(
    sweep: Dict[str, List[float]],
    topk: int,
    sel: float,
    n_vectors: int,
) -> CostModelParams:
    """Fit (k, beta) and (a, b) from one sweep over a single index of
    n_vectors rows (the reference fits on the global RLS index,
    get_parameter.py:135-185)."""
    k_, beta = fit_recall_params(sweep["efs"], sweep["recalls"], topk, sel)
    ns = [n_vectors] * len(sweep["efs"])
    a, b = fit_qps_params(ns, sweep["efs"], sweep["times_s"])
    return CostModelParams(k=k_, beta=beta, a=a, b=b)


def selectivity_lab_world(num_docs: int, sels: Sequence[float], seed: int = 0):
    """A crafted RBAC world for model validation: role i reads an exact
    random `sels[i]` fraction of documents; one catch-all role keeps full
    coverage; user i holds exactly role i. Querying as user i measures the
    index at selectivity sels[i] — the controlled grid the reference's
    multi_parameter_model_validation.py sweeps with SQL table subsets."""
    from ..rbac import RBACWorld

    rng = np.random.default_rng(seed)
    role_to_docs = {}
    for i, s in enumerate(sels):
        n_sel = max(1, int(round(s * num_docs)))
        role_to_docs[i] = frozenset(
            rng.choice(num_docs, n_sel, replace=False).tolist())
    role_to_docs[len(sels)] = frozenset(range(num_docs))  # coverage
    user_to_roles = {i: (i,) for i in range(len(sels) + 1)}
    return RBACWorld(
        num_users=len(sels) + 1, num_roles=len(sels) + 1, num_docs=num_docs,
        user_to_roles=user_to_roles, role_to_docs=role_to_docs,
    )


def multi_parameter_validation(
    corpus,
    world,                      # selectivity_lab_world
    sels: Sequence[float],
    sizes: Sequence[int],
    efs: Sequence[int],
    topk: int,
    queries: np.ndarray,
    arena=None,
    index_kind: str = "hnsw",
    fit_cell: int = 0,          # cell for fit_mode="cell"
    fit_offset: bool = True,
    fit_mode: str = "joint",    # "joint": fit (k, beta, ef_offset,
                                # gamma_n) across the WHOLE grid (the
                                # n-scaling family the TPU engines need);
                                # "cell": reference-style single-cell fit
    family: str = "reference",  # "tpu": fit cost.TPUCostParams (log-ef
                                # logistic + floor/power time) instead of
                                # the reference piecewise family
    builder: str = "classic",   # ONE builder for every size — "auto"
                                # switches engines at 50k rows and a single
                                # model family cannot span two graph-
                                # quality regimes
    seed: int = 0,
    timing_reps: int = 2,
    device="cuda",              # where the arena goes when none is given
) -> Dict[str, object]:
    """Grid validation (reference multi_parameter_model_validation.py):
    build one index per size (a random row subset), sweep ef at every
    selectivity, fit the recall family and (a, b) jointly across ALL
    sizes, then report recall MAE / time MAPE per cell and aggregate.
    Raises where a search returns a row its user cannot read. Returns a
    JSON-able dict."""
    from ..core import build_device_arena
    from ..index.hnsw import HNSWIndex
    from ..index.ivf import IVFIndex

    if arena is None:
        arena = build_device_arena(corpus, world, device=device,
                                   block_rows=4096)
    rng = np.random.default_rng(seed)
    bits = corpus.vector_role_bits(world)
    nq = len(queries)

    cells = []
    qps_n, qps_ef, qps_t = [], [], []
    for size in sizes:
        rows = np.sort(rng.choice(corpus.n, size, replace=False))
        if index_kind == "hnsw":
            idx = HNSWIndex(arena, rows=rows, m=16, ef_construction=64,
                            query_batch=min(1024, len(queries)), seed=seed,
                            builder=builder)
            width = "ef_search"
        else:
            idx = IVFIndex(arena, rows=rows, nlist=max(16, int(np.sqrt(size))),
                           query_batch=min(1024, len(queries)), seed=seed)
            width = "nprobe"

        def search(q, m, k, ef, idx=idx, width=width):
            d, ids = idx.search(q, m, k, **{width: ef})
            # every returned row is readable by its query's user
            ok = (bits[np.maximum(ids, 0)] & m[:, None, :]).any(2) | (ids < 0)
            if not ok.all():
                raise RuntimeError(f"{int((~ok).sum())} returned rows are "
                                   "not readable by their users")
            return d, ids

        sub_vec = corpus.vectors[rows]
        sub_norm = np.einsum("nd,nd->n", sub_vec, sub_vec)
        for si, sel in enumerate(sels):
            masks = np.tile(world.user_masks[si], (nq, 1))
            allowed = (bits[rows] & world.user_masks[si]).any(axis=1)
            d2 = sub_norm[None, :] - 2.0 * queries @ sub_vec.T
            d2[:, ~allowed] = np.inf
            order = np.argsort(d2, axis=1, kind="stable")[:, :topk]
            truth = rows[order]
            truth[np.take_along_axis(d2, order, axis=1) == np.inf] = -1
            sweep = sweep_search_width(search, queries, masks, truth,
                                       topk, efs, timing_reps=timing_reps)
            cells.append({"n": int(size), "sel": float(sel), "sweep": sweep})
            qps_n += [size] * len(efs)
            qps_ef += list(sweep["efs"])
            qps_t += sweep["times_s"]

    # fit recall family; (a, b) jointly across all sizes either way
    a, b = fit_qps_params(qps_n, qps_ef, qps_t)
    if family == "tpu":
        return _finish_tpu_family(cells, topk, index_kind)
    if fit_mode == "joint":
        pts = [(ef, c["sel"], c["n"], r)
               for c in cells
               for ef, r in zip(c["sweep"]["efs"], c["sweep"]["recalls"])]
        rj = fit_recall_params_joint(pts, topk, fit_offset=fit_offset)
        params = CostModelParams(k=rj.k, beta=rj.beta, a=a, b=b,
                                 ef_offset=rj.ef_offset, n_ref=rj.n_ref,
                                 gamma_n=rj.gamma_n)
        fit = {"n": "joint", "sel": "joint"}
    else:
        fit = cells[fit_cell]
        rp = fit_recall_params(fit["sweep"]["efs"], fit["sweep"]["recalls"],
                               topk, fit["sel"], fit_offset=fit_offset)
        params = CostModelParams(k=rp[0], beta=rp[1], a=a, b=b,
                                 ef_offset=rp[2] if len(rp) > 2 else 0.0)

    rm = RecallModel(params)
    qm = QueryTimeModel(params)
    out_cells = []
    maes, mapes = [], []
    for cell in cells:
        sweep = cell["sweep"]
        pred_r = [rm.recall(ef, topk, cell["sel"], n=cell["n"])
                  for ef in sweep["efs"]]
        pred_t = [qm.partition_time(cell["n"], ef) for ef in sweep["efs"]]
        mae = float(np.mean([abs(p - m) for p, m in
                             zip(pred_r, sweep["recalls"])]))
        mt = np.asarray(sweep["times_s"])
        mape = float(np.mean(np.abs(np.asarray(pred_t) - mt)
                             / np.maximum(mt, 1e-12)))
        maes.append(mae)
        mapes.append(mape)
        out_cells.append({
            "n": cell["n"], "sel": cell["sel"],
            "efs": sweep["efs"], "measured_recall": sweep["recalls"],
            "predicted_recall": pred_r,
            "measured_time_s": sweep["times_s"], "predicted_time_s": pred_t,
            "recall_mae": mae, "time_mape": mape,
        })
    return {
        "index": index_kind,
        "params": params.to_dict(),
        "cells": out_cells,
        "recall_mae": float(np.mean(maes)),
        "time_mape": float(np.mean(mapes)),
        "fit_cell": {"n": fit["n"], "sel": fit["sel"]},
    }


def _finish_tpu_family(cells, topk: int, index_kind: str) -> Dict[str, object]:
    """Fit cost.TPUCostParams on collected sweep cells and report errors.
    Shared by multi_parameter_validation(family="tpu") and
    refit_tpu_family_from_json (offline refits of a saved grid)."""
    from .fitting import fit_tpu_cost

    pts_r = [(ef, c["sel"], c["n"], r)
             for c in cells
             for ef, r in zip(c["sweep"]["efs"], c["sweep"]["recalls"])]
    pts_t = [(ef, c["sel"], c["n"], t)
             for c in cells
             for ef, t in zip(c["sweep"]["efs"], c["sweep"]["times_s"])]
    params = fit_tpu_cost(pts_r, pts_t)
    out_cells = []
    maes, mapes = [], []
    for cell in cells:
        sweep = cell["sweep"]
        pred_r = [params.recall(ef, topk, cell["sel"], n=cell["n"])
                  for ef in sweep["efs"]]
        pred_t = [params.partition_time(cell["n"], ef)
                  for ef in sweep["efs"]]
        mae = float(np.mean([abs(p - m)
                             for p, m in zip(pred_r, sweep["recalls"])]))
        mt = np.asarray(sweep["times_s"])
        mape = float(np.mean(np.abs(np.asarray(pred_t) - mt)
                             / np.maximum(mt, 1e-12)))
        maes.append(mae)
        mapes.append(mape)
        out_cells.append({
            "n": cell["n"], "sel": cell["sel"],
            "efs": sweep["efs"], "measured_recall": sweep["recalls"],
            "predicted_recall": pred_r,
            "measured_time_s": sweep["times_s"], "predicted_time_s": pred_t,
            "recall_mae": mae, "time_mape": mape,
        })
    return {
        "index": index_kind,
        "family": "tpu",
        "params": params.to_dict(),
        "cells": out_cells,
        "recall_mae": float(np.mean(maes)),
        "time_mape": float(np.mean(mapes)),
        "fit_cell": {"n": "joint", "sel": "joint"},
    }


def refit_tpu_family_from_json(grid: Dict[str, object],
                               topk: int) -> Dict[str, object]:
    """Refit the TPU cost family from a saved multi_parameter_validation
    output (its cells carry the full measured sweeps) — no re-measurement
    needed."""
    cells = [{"n": c["n"], "sel": c["sel"],
              "sweep": {"efs": c["efs"], "recalls": c["measured_recall"],
                        "times_s": c["measured_time_s"]}}
             for c in grid["cells"]]
    return _finish_tpu_family(cells, topk, str(grid.get("index", "hnsw")))


def validate_models(
    sweep: Dict[str, List[float]],
    params: CostModelParams,
    topk: int,
    sel: float,
    n_vectors: int,
) -> Dict[str, object]:
    """Predicted-vs-measured errors (modelrecall_vs_realrecall analog)."""
    rm = RecallModel(params)
    qm = QueryTimeModel(params)
    pred_recall = [rm.recall(ef, topk, sel) for ef in sweep["efs"]]
    pred_time = [qm.partition_time(n_vectors, ef) for ef in sweep["efs"]]
    recall_err = [abs(p - m) for p, m in zip(pred_recall, sweep["recalls"])]
    # query-time model is linear in ef up to scale: compare normalized shapes
    mt = np.asarray(sweep["times_s"])
    pt = np.asarray(pred_time)
    scale = (mt @ pt) / max(pt @ pt, 1e-12)
    time_rel_err = np.abs(pt * scale - mt) / np.maximum(mt, 1e-12)
    return {
        "efs": sweep["efs"],
        "measured_recall": sweep["recalls"],
        "predicted_recall": pred_recall,
        "recall_mae": float(np.mean(recall_err)),
        "measured_time_s": sweep["times_s"],
        "predicted_time_scaled": (pt * scale).tolist(),
        "time_mape": float(np.mean(time_rel_err)),
        "params": params.to_dict(),
    }
