"""Analytic recall and query-time models.

A copy of vectorsearch_rbac_tpu/models/cost.py (numpy only), so that the
planner runs where the JAX package is absent; tests/test_torch_host.py
holds it equal to the reference.

These are the two fitted models at the heart of the AnonySys planner
(HoneyBee paper eq. 8/9):

- Recall vs search width (`ef`), selectivity `sel`, and `topk`
  (reference controller/dynamic_partition/hnsw/helper.py:159-219
  calculate_hnsw_recall): linear ramp `ef*sel/topk` up to the threshold
  `k*topk/sel`, then a sigmoid saturating at `k + 0.5`:
      recall = 1 / (1 + exp(-4*beta*sel/topk * (ef - threshold))) + (k - 0.5)

- Query time vs partition size (reference helper.py:222-267
  calculate_hnsw_role_avg_qps):
      time = log(n_vectors) * (a*ef + b)    [+ join_time per partition]

The inverse (ef needed for a target recall) is the planner's workhorse
(reference AnonySys_dynamic_partition.py:134-152 compute_query_time).
Parameters (k, beta, a, b) are fitted per index type by models.fitting —
on-device sweeps replace the reference's EXPLAIN ANALYZE timing loops.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional

import numpy as np


@dataclass
class CostModelParams:
    """Fitted constants. Defaults are the reference's committed fit for
    pgvector HNSW (reference helper.py:160,224) — callers should refit for
    the TPU indexes via models.fitting.

    ef_offset extends the reference's 2-parameter recall family: the model
    evaluates at ef_eff = ef - ef_offset. Near-saturated filtered indexes
    reach high recall at small ef, which the pure (k, beta) family can only
    express by inflating beta (the loose-fit caveat PARITY.md admits); a
    negative offset shifts the whole curve left instead. ef_offset = 0
    recovers the reference model exactly."""

    k: float = 1.0
    beta: float = 0.44240961
    a: float = 550.97
    b: float = 183157.0
    join_time: float = 0.0
    ef_offset: float = 0.0
    # n-scaling extension (absent from the reference's n-free family):
    # measured recall at fixed (ef, sel) degrades with index size (the
    # reference's TPU v5e record, results/model_validation.json; the same
    # recalls to the last digit on an NVIDIA H100 80GB HBM3 at 700 W,
    # bench/model_validation.py), so the model evaluates at
    # ef_eff = (ef - ef_offset) * (n_ref / n)^gamma_n. gamma_n = 0
    # recovers the reference model exactly.
    n_ref: float = 0.0
    gamma_n: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return {"k": self.k, "beta": self.beta, "a": self.a, "b": self.b,
                "join_times": self.join_time, "ef_offset": self.ef_offset,
                "n_ref": self.n_ref, "gamma_n": self.gamma_n}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "CostModelParams":
        return cls(k=d.get("k", 1.0), beta=d.get("beta", 0.4424),
                   a=d.get("a", 550.97), b=d.get("b", 183157.0),
                   join_time=d.get("join_times", d.get("join_time", 0.0)),
                   ef_offset=d.get("ef_offset", 0.0),
                   n_ref=d.get("n_ref", 0.0), gamma_n=d.get("gamma_n", 0.0))

    def n_scale(self, n: float) -> float:
        """ef multiplier turning a model-domain ef into the ef an index of
        n rows needs (1.0 when the n-extension is off)."""
        if self.gamma_n and self.n_ref > 1 and n > 1:
            return (n / self.n_ref) ** self.gamma_n
        return 1.0


class RecallModel:
    def __init__(self, params: CostModelParams):
        self.p = params

    def recall(self, ef: float, topk: int, sel: float,
               n: float = 0.0) -> float:
        """Predicted recall for one (sub)query with selectivity `sel` over
        an index of n rows (n=0: reference n-free behavior)."""
        if sel <= 0:
            return 0.0
        k, beta = self.p.k, self.p.beta
        ef = max(ef - self.p.ef_offset, 0.0) / self.p.n_scale(n)
        threshold = k * topk / sel
        if ef <= threshold:
            r = ef * sel / topk
        else:
            exponent = -4.0 * beta * sel / topk * (ef - threshold)
            r = 1.0 / (1.0 + math.exp(exponent)) + (k - 0.5)
        return min(r, 1.0)

    def recall_curve(self, efs: Iterable[float], topk: int, sel: float) -> np.ndarray:
        return np.asarray([self.recall(ef, topk, sel) for ef in efs])


def ef_for_recall(
    target_recall: Optional[float], topk: int, sel: float,
    params: CostModelParams, n: float = 0.0,
) -> float:
    """Invert the sigmoid branch: ef needed to reach `target_recall` on an
    index of n rows (n=0: reference n-free behavior).

    With target_recall=None, aim as high as the curve allows (the
    reference's dynamic_value loop, AnonySys_dynamic_partition.py:136-143:
    largest 1 + x/10 with (1 + x/10) - k < 1, x in {3,2,...}).
    """
    k, beta = params.k, params.beta
    safe_sel = max(sel, 1e-6)
    scale = params.n_scale(n)
    if target_recall is not None and target_recall <= k:
        # below the knee the model is the linear ramp: invert it directly
        # (the sigmoid inversion is only valid above recall = k)
        return (target_recall * topk / safe_sel) * scale + params.ef_offset
    if target_recall is None:
        x = 3
        while (1 + x / 10) - k >= 1:
            x -= 1
        dynamic_value = 1 + x / 10
    else:
        # sigmoid output needed: recall = sig + (k - 0.5) => sig target
        dynamic_value = target_recall + 0.5
    delta = max(dynamic_value - k, 1e-6)
    inner = 1.0 / delta - 1.0
    if inner <= 0:
        inner = 1e-6
    safe_beta = beta if abs(beta) > 1e-6 else 1e-6
    base = (math.log(inner) / (-4.0 * safe_beta * safe_sel) * topk
            + k * topk / safe_sel)
    return base * scale + params.ef_offset


@dataclass
class TPUCostParams:
    """The TPU-engine-fitted cost family (models/fitting.fit_tpu_cost).

    The reference's piecewise family (above) encodes pgvector behavior:
    threshold ∝ 1/sel, steepness ∝ sel, no n term, time = log(n)(a·ef+b).
    The reference's TPU v5e engine differs on every axis
    (results/model_validation.json): recall at fixed ef degrades with n,
    saturation sharpness grows sub-linearly with sel, and batched device
    graph search is n-independent with a dispatch floor and superlinear ef
    cost. The family that fits that TPU record (recall MAE 0.044, time
    MAPE 0.058 across a 4-size x 5-selectivity x 5-ef grid,
    results/model_validation_tpu_family.json). On an NVIDIA H100 80GB
    HBM3 at 700 W (bench/model_validation.py, the same grid) the recalls
    are the TPU's to the last digit (MAE 0.044 again), but the fixed
    beam's time has almost no floor and grows linearly in ef (c0 1.6e-5
    s, p 1.04): time MAPE 0.141, against 0.167 for the reference family:

        recall(ef, sel, n) = k / (1 + exp(-s·sel^w · ln(ef / ef50)))
                  ef50      = C · (n / n_ref)^g · sel^-h
        time(ef)           = c0 + a_t · ef^p          [+ join_time/probe]
    """

    k: float = 1.0          # recall ceiling
    s: float = 3.35         # base log-ef steepness
    w: float = 0.38         # steepness-vs-sel exponent
    C: float = 14.9         # ef50 scale at (n_ref, sel=1)
    g: float = 0.39         # ef50-vs-n exponent
    h: float = 0.16         # ef50-vs-sel exponent
    n_ref: float = 100_000.0
    c0: float = 2.26e-4     # per-query dispatch floor (s)
    a_t: float = 7.9e-8     # time scale
    p: float = 1.79         # time-vs-ef exponent
    join_time: float = 0.0  # per-probe overhead (fit_join_time)

    def to_dict(self) -> Dict[str, float]:
        return {f: getattr(self, f) for f in
                ("k", "s", "w", "C", "g", "h", "n_ref", "c0", "a_t", "p",
                 "join_time")}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "TPUCostParams":
        return cls(**{f: d[f] for f in
                      ("k", "s", "w", "C", "g", "h", "n_ref", "c0", "a_t",
                       "p", "join_time") if f in d})

    # ------------------------------------------------------------- recall

    def ef50(self, sel: float, n: float) -> float:
        sel = max(sel, 1e-6)
        n = max(n, 2.0)
        return self.C * (n / self.n_ref) ** self.g * sel ** (-self.h)

    def recall(self, ef: float, topk: int, sel: float,
               n: float = 0.0) -> float:
        if sel <= 0 or ef <= 0:
            return 0.0
        n = n if n > 1 else self.n_ref
        z = self.s * max(sel, 1e-6) ** self.w * (
            math.log(ef) - math.log(self.ef50(sel, n)))
        z = min(max(z, -60.0), 60.0)
        return self.k / (1.0 + math.exp(-z))

    def ef_for_recall(self, target: Optional[float], topk: int, sel: float,
                      n: float = 0.0) -> float:
        """Invert the logistic; target=None aims at 97% of the ceiling."""
        n = n if n > 1 else self.n_ref
        sel = max(sel, 1e-6)
        r = 0.97 * self.k if target is None else min(target, 0.999 * self.k)
        inner = r / max(self.k - r, 1e-9)
        z = math.log(inner) / (self.s * sel ** self.w)
        return self.ef50(sel, n) * math.exp(z)

    # --------------------------------------------------------------- time

    def partition_time(self, n_vectors: float, ef: float) -> float:
        if n_vectors <= 1:
            return 0.0
        return self.c0 + self.a_t * max(ef, 1.0) ** self.p

    def query_time(self, partition_sizes: Iterable[float], ef: float,
                   include_join: bool = True) -> float:
        sizes = list(partition_sizes)
        t = sum(self.partition_time(n, ef) for n in sizes)
        if include_join:
            t += self.join_time * len(sizes)
        return t


@dataclass
class IVFCoverageParams:
    """Coverage-based IVF probe-recall family (the fix the round-2 artifact
    results/ivf_model_validation_1m.json names: the reference's piecewise
    linear->sigmoid family, fitted to pgvector HNSW post-filtering
    (helper.py:159-219), saturates at ef = k*topk/sel and cannot describe
    IVF, whose recall tracks LIST COVERAGE of the user's admissible
    neighbor mass — log-ish growth with diminishing returns, saturating
    only at nprobe = nlist. The family that fits (reference anticipates
    per-index refits, controller/dynamic_partition/get_parameter.py:135-185):

        recall(nprobe)  = k * (1 - exp(-lam * nprobe^sigma))
        time(nprobe, n) = log(n) * (a * nprobe * l_pad + b)

    sigma < 1 captures neighbors concentrating in the nearest lists; k is
    the in-list ceiling (spill + masking losses). On the reference's
    round-2 1M sweep (a TPU v5e record) this family reproduces
    0.497/0.706 at nprobe 16/32 from endpoints fitted at 8/64 (piecewise
    family error there: saturated at 1.0). Fitted on the even points of
    an 11-nprobe sweep and scored on the odd ones (2 sizes x 4
    selectivities at 1M): held-out recall MAE 0.0019 and time MAPE 0.024
    on the TPU v5e (results/ivf_coverage_validation_1m.json); MAE 0.0018
    and MAPE 0.064 on an NVIDIA H100 80GB HBM3 at 700 W
    (bench/ivf_coverage.py), where a query takes 10-85 us against the
    TPU's 250-8,300 and the per-batch routing read-back is a floor the
    line log(n)(a ef + b) reads as b. The a and b defaults below are the
    reference's."""

    k: float = 1.0
    lam: float = 0.08
    sigma: float = 0.79
    l_pad: float = 1024.0   # rows per probed list (ef = nprobe * l_pad)
    a: float = 1.82e-7      # per-ef time slope   (log(n)*(a*ef+b))
    b: float = 3.95e-6      # per-probe time intercept

    def to_dict(self) -> Dict[str, float]:
        return {f: getattr(self, f)
                for f in ("k", "lam", "sigma", "l_pad", "a", "b")}

    @classmethod
    def from_dict(cls, d: Mapping[str, float]) -> "IVFCoverageParams":
        return cls(**{f: d[f] for f in
                      ("k", "lam", "sigma", "l_pad", "a", "b") if f in d})

    def recall(self, nprobe: float, topk: int = 0, sel: float = 0.0,
               n: float = 0.0) -> float:
        if nprobe <= 0:
            return 0.0
        return self.k * (1.0 - math.exp(-self.lam * nprobe ** self.sigma))

    def ef_for_recall(self, target: Optional[float], topk: int = 0,
                      sel: float = 0.0, n: float = 0.0) -> float:
        """Invert coverage -> nprobe (the 'ef' of the IVF planner)."""
        r = 0.97 * self.k if target is None else min(target, 0.999 * self.k)
        inner = max(1.0 - r / self.k, 1e-9)
        return (-math.log(inner) / self.lam) ** (1.0 / self.sigma)

    def partition_time(self, n_rows: float, nprobe: float) -> float:
        if n_rows <= 1:
            return 0.0
        return math.log(max(n_rows, 2.0)) * (
            self.a * nprobe * self.l_pad + self.b)


def model_ef_for_recall(p, target: Optional[float], topk: int, sel: float,
                        n: float = 0.0) -> float:
    """Family-dispatching ef inversion: works for CostModelParams
    (reference piecewise family), TPUCostParams (engine-fitted family), and
    IVFCoverageParams (nprobe coverage family — its 'ef' is nprobe).
    The planner calls this so a fit-params run can swap families without
    touching optimizer code."""
    if isinstance(p, (TPUCostParams, IVFCoverageParams)):
        return p.ef_for_recall(target, topk, sel, n)
    return ef_for_recall(target, topk, sel, p, n)


def model_partition_time(p, n_rows: float, ef: float) -> float:
    """Family-dispatching per-partition probe time."""
    if isinstance(p, (TPUCostParams, IVFCoverageParams)):
        return p.partition_time(n_rows, ef)
    if n_rows <= 1:
        return 0.0
    return math.log(n_rows) * (p.a * ef + p.b)


class QueryTimeModel:
    def __init__(self, params: CostModelParams):
        self.p = params

    def partition_time(self, n_vectors: float, ef: float) -> float:
        """Predicted per-partition probe time: log(n) * (a*ef + b)."""
        if n_vectors <= 1:
            return 0.0
        return math.log(n_vectors) * (self.p.a * ef + self.p.b)

    def query_time(
        self, partition_sizes: Iterable[float], ef: float, include_join: bool = True
    ) -> float:
        """Total time for a query probing several partitions."""
        sizes = list(partition_sizes)
        t = sum(self.partition_time(n, ef) for n in sizes)
        if include_join:
            t += self.p.join_time * len(sizes)
        return t
