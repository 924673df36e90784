"""The port's cost-model fitting and validation against the JAX
reference's on the CPU: every fit (recall, joint recall, QPS, the TPU and
IVF coverage families, the join time, the whole cost model) equal to
rtol 1e-6 on the same arrays; the ef sweep of an HNSW index carried from
the reference (its graph_state) with the reference's recalls, and
validate_models equal on one sweep; the selectivity lab world, the TPU
family's refit from a saved grid, and the port's grid validation."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.bench import GroundTruthOracle as RefOracle
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import synthetic_corpus as ref_synthetic
from vectorsearch_rbac_tpu.index.hnsw import HNSWIndex as RefHNSWIndex
from vectorsearch_rbac_tpu.models import fitting as ref_fitting
from vectorsearch_rbac_tpu.models import validate as ref_validate
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.bench import (GroundTruthOracle,
                                               generate_query_workload)
from vectorsearch_rbac_tpu_torch.data import synthetic_corpus
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.models import fitting, validate
from vectorsearch_rbac_tpu_torch.models.cost import CostModelParams
from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator

RTOL = 1e-6


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want):
    if hasattr(got, "to_dict"):
        got, want = got.to_dict(), want.to_dict()
        assert got.keys() == want.keys()
        got, want = list(got.values()), list(want.values())
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL)


def _recall_points(seed=0):
    rng = np.random.default_rng(seed)
    efs = np.array([8, 16, 32, 48, 64, 96, 128, 192, 256], np.float64)
    sel, topk = 0.3, 10
    r = fitting._piecewise(efs, 0.97, 0.6, topk, sel, 4.0)
    return efs, np.clip(r + rng.normal(0, 0.01, len(efs)), 0, 1), topk, sel


def _grid(seed=1):
    rng = np.random.default_rng(seed)
    pts_r, pts_t = [], []
    for n in (2_000, 20_000, 200_000):
        for sel in (0.05, 0.3, 1.0):
            for ef in (8, 16, 32, 64, 128, 256):
                z = 2.0 * sel ** 0.3 * (np.log(ef) - np.log(
                    25 * (n / 1e5) ** 0.4 * sel ** -0.3))
                pts_r.append((ef, sel, n, 0.98 / (1 + np.exp(-z))
                               + rng.normal(0, 0.005)))
                pts_t.append((ef, sel, n, 2e-4 + 1e-7 * ef ** 1.8
                              * (1 + rng.normal(0, 0.02))))
    return pts_r, pts_t


def test_recall_and_qps_fits_match_reference():
    efs, rec, topk, sel = _recall_points()
    for off in (False, True):
        _close(fitting.fit_recall_params(efs, rec, topk, sel, off),
               ref_fitting.fit_recall_params(efs, rec, topk, sel, off))
    pts_r, _ = _grid()
    pts = [(ef, s, n, min(r, 1.0)) for ef, s, n, r in pts_r]
    for kw in (dict(), dict(fit_offset=False, fit_nscale=False)):
        _close(fitting.fit_recall_params_joint(pts, 10, **kw),
               ref_fitting.fit_recall_params_joint(pts, 10, **kw))
    rng = np.random.default_rng(2)
    n = np.repeat([1e4, 1e5, 1e6], 5)
    ef = np.tile([8, 16, 32, 64, 128], 3).astype(np.float64)
    t = np.log(n) * (3e-7 * ef + 2e-5) * (1 + rng.normal(0, 0.01, len(n)))
    _close(fitting.fit_qps_params(n, ef, t), ref_fitting.fit_qps_params(
        n, ef, t))
    m, jt = [1, 2, 4, 8], [1.0e-4, 1.3e-4, 1.9e-4, 3.2e-4]
    _close([fitting.fit_join_time(m, jt)],
           [ref_fitting.fit_join_time(m, jt)])
    _close([fitting.fit_join_time(m, jt[::-1])],
           [ref_fitting.fit_join_time(m, jt[::-1])])
    for off in (False, True):
        _close(fitting.fit_cost_model((efs, rec), (n, ef, t), topk, sel,
                                      join_time=1e-5, fit_offset=off),
               ref_fitting.fit_cost_model((efs, rec), (n, ef, t), topk, sel,
                                          join_time=1e-5, fit_offset=off))


def test_tpu_and_ivf_families_match_reference():
    pts_r, pts_t = _grid()
    _close(fitting.fit_tpu_cost(pts_r, pts_t, join_time=3e-6),
           ref_fitting.fit_tpu_cost(pts_r, pts_t, join_time=3e-6))
    m = np.array([1, 2, 4, 8, 16, 32, 64], np.float64)
    r = 0.99 * (1 - np.exp(-0.2 * m ** 0.9))
    _close(fitting.fit_ivf_coverage(m, r, l_pad=512.0, a=1e-7, b=2e-6),
           ref_fitting.fit_ivf_coverage(m, r, l_pad=512.0, a=1e-7, b=2e-6))


def test_lab_world_and_saved_grid_refit_match_reference():
    sels = [0.1, 0.35, 0.8]
    got = validate.selectivity_lab_world(300, sels, seed=3)
    want = ref_validate.selectivity_lab_world(300, sels, seed=3)
    assert dict(got.user_to_roles) == dict(want.user_to_roles)
    assert dict(got.role_to_docs) == dict(want.role_to_docs)
    pts_r, pts_t = _grid()
    cells = {}
    for (ef, sel, n, r), (_, _, _, t) in zip(pts_r, pts_t):
        c = cells.setdefault((n, sel), {"n": n, "sel": sel, "efs": [],
                                        "measured_recall": [],
                                        "measured_time_s": []})
        c["efs"].append(float(ef))
        c["measured_recall"].append(float(min(r, 1.0)))
        c["measured_time_s"].append(float(t))
    grid = {"index": "hnsw", "cells": list(cells.values())}
    got = validate.refit_tpu_family_from_json(grid, 10)
    want = ref_validate.refit_tpu_family_from_json(grid, 10)
    assert got.keys() == want.keys()
    _close(list(got["params"].values()), list(want["params"].values()))
    _close([got["recall_mae"], got["time_mape"]],
           [want["recall_mae"], want["time_mape"]])


def test_sweep_on_carried_hnsw_matches_reference(one_thread):
    wkw = dict(num_users=60, num_roles=12, num_docs=150, h=3, b0=2, b1=3,
               seed=7)
    ref_world = RefTreeGenerator(**wkw).generate()
    world = TreeRBACGenerator(**wkw).generate()
    ref_corpus = ref_synthetic(150, 4, 24, seed=3)
    corpus = synthetic_corpus(150, 4, 24, seed=3)
    rarena = ref_arena(ref_corpus, ref_world, block_rows=128)
    arena = arena_from_reference(rarena, "cpu")
    ref_idx = RefHNSWIndex(rarena, m=8, ef_construction=48, query_batch=16,
                           builder="classic", seed=0)
    idx = HNSWIndex(arena, m=8, query_batch=16,
                    graph_state=ref_idx.graph_state())
    wl = generate_query_workload(corpus, world, num_queries=16, topk=5,
                                 seed=7)
    truth = GroundTruthOracle(arena, block_rows=128).compute(corpus, world,
                                                             wl, 5)
    ref_truth = RefOracle(rarena, block_rows=128, query_batch=16).compute(
        ref_corpus, ref_world, wl, 5)
    np.testing.assert_array_equal(truth, ref_truth)
    masks = world.user_masks[wl.user_ids]
    efs = [8, 16, 32]
    got = validate.sweep_search_width(
        lambda q, m, k, ef: idx.search(q, m, k, ef_search=ef), wl.vectors,
        masks, truth, 5, efs, timing_reps=1)
    want = ref_validate.sweep_search_width(
        lambda q, m, k, ef: ref_idx.search(q, m, k, ef_search=ef),
        wl.vectors, masks, truth, 5, efs, timing_reps=1)
    assert got["efs"] == want["efs"]
    assert got["recalls"] == want["recalls"]
    sel = float(np.mean(wl.selectivities))
    params = CostModelParams(k=0.98, beta=0.5, a=3e-7, b=2e-5)
    from vectorsearch_rbac_tpu.models.cost import (
        CostModelParams as RefParams)
    rep = validate.validate_models(want, params, 5, sel, corpus.n)
    ref_rep = ref_validate.validate_models(want, RefParams(**vars(params)),
                                           5, sel, corpus.n)
    assert rep.keys() == ref_rep.keys()
    for key in ("predicted_recall", "predicted_time_scaled"):
        _close(rep[key], ref_rep[key])
    _close([rep["recall_mae"], rep["time_mape"]],
           [ref_rep["recall_mae"], ref_rep["time_mape"]])
    fitted = validate.fit_from_sweep(want, 5, sel, corpus.n)
    _close(fitted, ref_validate.fit_from_sweep(want, 5, sel, corpus.n))


def test_grid_validation_runs_on_the_port(one_thread):
    corpus = synthetic_corpus(120, 4, 24, seed=3)
    sels = [0.2, 0.6]
    world = validate.selectivity_lab_world(corpus.num_docs, sels, seed=1)
    rng = np.random.default_rng(2)
    q = (corpus.vectors[rng.integers(0, corpus.n, 16)]
         + 0.01 * rng.standard_normal((16, corpus.dim))).astype(np.float32)
    out = validate.multi_parameter_validation(
        corpus, world, sels, sizes=[256, 480], efs=[8, 16, 32], topk=5,
        queries=q, timing_reps=1, builder="classic", device="cpu")
    assert len(out["cells"]) == 4 and out["fit_cell"] == {"n": "joint",
                                                          "sel": "joint"}
    for c in out["cells"]:
        assert all(0.0 <= r <= 1.0 for r in c["measured_recall"])
    assert out["recall_mae"] < 0.15 and np.isfinite(out["time_mape"])
