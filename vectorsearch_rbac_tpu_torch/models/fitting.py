"""Fitting the planner's cost models to measured sweeps.

A copy of vectorsearch_rbac_tpu/models/fitting.py (numpy and
scipy.optimize.curve_fit, each with a coarse numpy grid where scipy is
missing or fails), held equal to it by tests/test_torch_fitting.py:
measured (ef, recall) points fit the piecewise linear/sigmoid recall model
(`fit_recall_params`, jointly over a (n, sel, ef) grid in
`fit_recall_params_joint`), measured (n, ef, time) triples fit time =
log(n) * (a * ef + b) (`fit_qps_params`), and the TPU-engine and IVF
coverage families and the per-partition join time have fits of their own.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from .cost import CostModelParams, TPUCostParams


def _piecewise(ef: np.ndarray, k: float, beta: float, topk: float,
               sel: float, ef0: float = 0.0) -> np.ndarray:
    ef = np.maximum(ef - ef0, 0.0)
    threshold = k * topk / max(sel, 1e-9)
    lin = ef * sel / topk
    expo = -4.0 * beta * sel / topk * (ef - threshold)
    expo = np.clip(expo, -60, 60)
    sig = 1.0 / (1.0 + np.exp(expo)) + (k - 0.5)
    return np.minimum(np.where(ef <= threshold, lin, sig), 1.0)


def fit_recall_params(
    efs: Sequence[float],
    recalls: Sequence[float],
    topk: int,
    sel: float,
    fit_offset: bool = False,
) -> Tuple[float, ...]:
    """Fit (k, beta) — or (k, beta, ef_offset) with fit_offset=True — of the
    piecewise recall model to measured points. The offset extension handles
    near-saturated filtered indexes whose measured curve rises much earlier
    than the 2-parameter family allows (PARITY.md's admitted loose fit)."""
    efs = np.asarray(efs, dtype=np.float64)
    recalls = np.asarray(recalls, dtype=np.float64)

    def model2(ef, k, beta):
        return _piecewise(ef, k, beta, float(topk), float(sel))

    def model3(ef, k, beta, ef0):
        return _piecewise(ef, k, beta, float(topk), float(sel), ef0)

    lo_ef0 = -float(np.max(efs))
    hi_ef0 = float(np.max(efs)) / 2
    try:
        from scipy.optimize import curve_fit

        if fit_offset:
            (k, beta, ef0), _ = curve_fit(
                model3, efs, recalls, p0=[1.0, 0.4, 0.0],
                bounds=([0.5, 1e-3, lo_ef0], [1.0, 10.0, hi_ef0]),
                maxfev=20000,
            )
            return float(k), float(beta), float(ef0)
        (k, beta), _ = curve_fit(
            model2, efs, recalls, p0=[1.0, 0.4],
            bounds=([0.5, 1e-3], [1.0, 10.0]), maxfev=20000,
        )
        return float(k), float(beta)
    except Exception:
        # numpy fallback: coarse grid + local refinement
        ef0s = np.linspace(lo_ef0, hi_ef0, 21) if fit_offset else [0.0]
        best = (1.0, 0.4, 0.0, np.inf)
        for ef0 in ef0s:
            for k in np.linspace(0.5, 1.0, 26):
                for beta in np.geomspace(1e-3, 10, 40):
                    err = float(np.mean(
                        (model3(efs, k, beta, ef0) - recalls) ** 2))
                    if err < best[3]:
                        best = (float(k), float(beta), float(ef0), err)
        return best[:3] if fit_offset else best[:2]


def fit_recall_params_joint(
    points: Sequence[Tuple[float, float, float, float]],  # (ef, sel, n, r)
    topk: int,
    fit_offset: bool = True,
    fit_nscale: bool = True,
) -> CostModelParams:
    """Joint fit of (k, beta, ef_offset, gamma_n) across a (n, sel, ef)
    grid — the n-scaling extension the engines need (measured recall at
    fixed ef degrades with index size: results/model_validation.json, the
    reference's TPU v5e record, and the same recalls on an NVIDIA H100
    80GB HBM3 at 700 W, bench/model_validation.py).
    n_ref is pinned to the geometric mean of the sizes. Returns a
    CostModelParams with only the recall-side fields set."""
    pts = np.asarray(points, dtype=np.float64)
    efs, sels, ns, recalls = pts[:, 0], pts[:, 1], pts[:, 2], pts[:, 3]
    n_ref = float(np.exp(np.mean(np.log(np.maximum(np.unique(ns), 2.0)))))

    def _piecewise_vec(ef, sel, n, k, beta, ef0, gn, n_ref_, topk_):
        scale = np.power(np.maximum(n, 2.0) / n_ref_, gn)
        ef_eff = np.maximum(ef - ef0, 0.0) / np.maximum(scale, 1e-9)
        threshold = k * topk_ / np.maximum(sel, 1e-9)
        lin = ef_eff * sel / topk_
        expo = np.clip(-4.0 * beta * sel / topk_ * (ef_eff - threshold),
                       -60, 60)
        sig = 1.0 / (1.0 + np.exp(expo)) + (k - 0.5)
        return np.minimum(np.where(ef_eff <= threshold, lin, sig), 1.0)

    lo_ef0 = -float(np.max(efs)) if fit_offset else -1e-9
    hi_ef0 = float(np.max(efs)) / 2 if fit_offset else 1e-9
    hi_gn = 3.0 if fit_nscale else 1e-9
    try:
        from scipy.optimize import curve_fit

        (k, beta, ef0, gn), _ = curve_fit(
            lambda x, k, beta, ef0, gn: _piecewise_vec(
                x[0], x[1], x[2], k, beta, ef0, gn, n_ref, float(topk)),
            np.stack([efs, sels, ns]), recalls,
            p0=[0.95, 0.4, 0.0, 0.5 if fit_nscale else 0.0],
            bounds=([0.5, 1e-3, lo_ef0, 0.0], [1.0, 10.0, hi_ef0, hi_gn]),
            maxfev=40000,
        )
    except Exception:
        best = (0.95, 0.4, 0.0, 0.0, np.inf)
        for gn in np.linspace(0.0, hi_gn if fit_nscale else 0.0, 13):
            for ef0 in np.linspace(lo_ef0, hi_ef0, 9):
                for k in np.linspace(0.5, 1.0, 11):
                    for beta in np.geomspace(1e-3, 10, 25):
                        err = float(np.mean((_piecewise_vec(
                            efs, sels, ns, k, beta, ef0, gn, n_ref,
                            float(topk)) - recalls) ** 2))
                        if err < best[4]:
                            best = (k, beta, ef0, gn, err)
        k, beta, ef0, gn = best[:4]
    return CostModelParams(k=float(k), beta=float(beta),
                           ef_offset=float(ef0), n_ref=n_ref,
                           gamma_n=float(gn))


def fit_qps_params(
    n_vectors: Sequence[float],
    efs: Sequence[float],
    times: Sequence[float],
) -> Tuple[float, float]:
    """Fit (a, b) of time = log(n) * (a*ef + b).

    Normalizing by log(n) gives t' = a*ef + b — ordinary least squares
    (the reference's fit_query_time_function_with_log)."""
    n = np.asarray(n_vectors, dtype=np.float64)
    ef = np.asarray(efs, dtype=np.float64)
    t = np.asarray(times, dtype=np.float64)
    mask = n > 1
    tn = t[mask] / np.log(n[mask])
    a, b = np.polyfit(ef[mask], tn, deg=1)
    return float(a), float(b)


def fit_tpu_cost(
    recall_points: Sequence[Tuple[float, float, float, float]],  # (ef, sel, n, r)
    time_points: Sequence[Tuple[float, float, float, float]],    # (ef, sel, n, t)
    join_time: float = 0.0,
) -> TPUCostParams:
    """Fit the TPU-engine cost family (cost.TPUCostParams) across a
    (n, sel, ef) grid: the log-ef logistic recall surface and the
    floor + power-law time curve. scipy falls back to a coarse grid."""
    rp = np.asarray(recall_points, dtype=np.float64)
    ef_r, sel_r, n_r, r = rp.T
    tp = np.asarray(time_points, dtype=np.float64)
    ef_t, _, _, t = tp.T
    n_ref = 1e5

    def recall_model(x, k, s, w, C, g, h):
        ef, sel, n = x
        ef50 = C * np.power(np.maximum(n, 2.0) / n_ref, g) \
            * np.power(np.maximum(sel, 1e-6), -h)
        z = s * np.power(np.maximum(sel, 1e-6), w) \
            * (np.log(np.maximum(ef, 1e-6)) - np.log(ef50))
        return k / (1.0 + np.exp(-np.clip(z, -60, 60)))

    def time_model(ef, c0, a_t, p):
        return c0 + a_t * np.power(np.maximum(ef, 1.0), p)

    try:
        from scipy.optimize import curve_fit

        (k, s, w, C, g, h), _ = curve_fit(
            recall_model, np.stack([ef_r, sel_r, n_r]), r,
            p0=[0.99, 2.0, 0.4, 30.0, 0.4, 0.3],
            bounds=([0.8, 0.1, -1.0, 1.0, 0.0, 0.0],
                    [1.0, 10.0, 1.0, 500.0, 2.0, 2.0]),
            maxfev=80000)
        (c0, a_t, p), _ = curve_fit(
            time_model, ef_t, t, p0=[2e-4, 1e-7, 1.8],
            bounds=([0.0, 0.0, 1.0], [1e-1, 1e-2, 3.0]), maxfev=80000)
    except Exception:
        # coarse numpy fallback
        best = None
        for s in (1.0, 2.0, 3.5, 5.0):
            for w in (0.0, 0.2, 0.4):
                for C in np.geomspace(3, 120, 9):
                    for g in (0.0, 0.2, 0.4, 0.6):
                        for h in (0.0, 0.15, 0.3, 0.6):
                            e = float(np.mean((recall_model(
                                (ef_r, sel_r, n_r), 0.99, s, w, C, g, h)
                                - r) ** 2))
                            if best is None or e < best[0]:
                                best = (e, 0.99, s, w, C, g, h)
        _, k, s, w, C, g, h = best
        c0 = float(np.min(t))
        resid = np.maximum(t - c0, 1e-9)
        p, loga = np.polyfit(np.log(np.maximum(ef_t, 1.0)), np.log(resid), 1)
        a_t = float(np.exp(loga))
    return TPUCostParams(k=float(k), s=float(s), w=float(w), C=float(C),
                         g=float(g), h=float(h), n_ref=n_ref,
                         c0=float(c0), a_t=float(a_t), p=float(p),
                         join_time=join_time)


def fit_ivf_coverage(
    nprobes: Sequence[float],
    recalls: Sequence[float],
    l_pad: float = 1024.0,
    a: float = 1.82e-7,
    b: float = 3.95e-6,
) -> "IVFCoverageParams":
    """Fit the IVF coverage recall family (cost.IVFCoverageParams):
    recall = k * (1 - exp(-lam * nprobe^sigma)). This is the per-index
    refit the round-2 artifact (results/ivf_model_validation_1m.json, a
    TPU v5e record) calls for — the piecewise pgvector family saturates
    long before IVF recall does. Held-out recall MAE at 1M: 0.0019 on the
    TPU v5e (results/ivf_coverage_validation_1m.json), 0.0018 on an NVIDIA
    H100 80GB HBM3 at 700 W (bench/ivf_coverage.py). scipy curve_fit with
    a log-space grid fallback."""
    from .cost import IVFCoverageParams

    m = np.asarray(nprobes, dtype=np.float64)
    r = np.asarray(recalls, dtype=np.float64)

    def model(m_, k, lam, sigma):
        return k * (1.0 - np.exp(-lam * np.power(np.maximum(m_, 1e-9), sigma)))

    try:
        from scipy.optimize import curve_fit

        (k, lam, sigma), _ = curve_fit(
            model, m, r, p0=[0.99, 0.1, 0.8],
            bounds=([0.5, 1e-5, 0.05], [1.0, 10.0, 2.0]), maxfev=50000)
    except Exception:
        best = None
        for k in (0.9, 0.95, 0.99, 1.0):
            for lam in np.geomspace(1e-3, 2.0, 24):
                for sigma in np.linspace(0.2, 1.5, 14):
                    e = float(np.mean((model(m, k, lam, sigma) - r) ** 2))
                    if best is None or e < best[0]:
                        best = (e, k, lam, sigma)
        _, k, lam, sigma = best
    return IVFCoverageParams(k=float(k), lam=float(lam), sigma=float(sigma),
                             l_pad=float(l_pad), a=float(a), b=float(b))


def fit_join_time(
    n_partitions: Sequence[int],
    times: Sequence[float],
) -> float:
    """Fit the per-partition probe overhead: measured total query time at a
    FIXED total row count split over m partitions is t(m) = t_scan + J*m;
    the slope J is the join_time constant (the reference regresses the
    'SubPlan 2' actual-time lines, analysis_hnsw_qps.py:371
    run_experiment_on_join_time — here the overhead is the per-dispatch
    launch + merge cost instead of a SQL join)."""
    m = np.asarray(n_partitions, dtype=np.float64)
    t = np.asarray(times, dtype=np.float64)
    j, _ = np.polyfit(m, t, deg=1)
    return float(max(j, 0.0))


def fit_cost_model(
    recall_points: Tuple[Sequence[float], Sequence[float]],
    qps_points: Tuple[Sequence[float], Sequence[float], Sequence[float]],
    topk: int,
    sel: float,
    join_time: float = 0.0,
    fit_offset: bool = False,
) -> CostModelParams:
    rp = fit_recall_params(recall_points[0], recall_points[1], topk, sel,
                           fit_offset=fit_offset)
    a, b = fit_qps_params(*qps_points)
    ef0 = rp[2] if len(rp) > 2 else 0.0
    return CostModelParams(k=rp[0], beta=rp[1], a=a, b=b,
                           join_time=join_time, ef_offset=ef0)
