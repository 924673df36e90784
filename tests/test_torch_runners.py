"""The result runners of the strategies, AnonySys's executors, QDTree's
knobs and the flat path's legs (bench.strategy_compare,
bench.anonysys_executors, bench.qdtree_sweeps, bench.cohere_rerank_legs,
bench.sift10m_merge_legs) and Int8FlatIndex's merge argument, against the
JAX reference on the CPU.

The reference's scripts are not imported (most of them point jax's
compile cache into the repository or run at import): the reference side
is composed here from the reference package's own functions as each
script composes them, on the same seeds, at 10,240 rows (the fewest the
scripts' 100-role world takes) and 128 queries. The flat legs run on
arenas padded to 16,384 rows (the scripts pad to 131,072, which the
reference's interpreted kernels would scan here for minutes), 20,480 of
them SIFT-like for the merges (group 8, 4,096 groups: the cascade's
subgroups and the merge kernels' gate both take the shape) and 10,240
cohere-like 768-d rows for the rerank legs. Results are held per query:
equal empty slots, distances within RTOL, ids equal as sets inside the
k-th distance (tied rows may come in another order).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.bench.ground_truth import (
    GroundTruthOracle as RefOracle)
from vectorsearch_rbac_tpu.bench.ground_truth import (
    compute_recall as ref_recall)
from vectorsearch_rbac_tpu.bench.queries import (
    QueryWorkload as RefWorkload)
from vectorsearch_rbac_tpu.bench.queries import (
    generate_query_workload as ref_workload)
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import resolve_dataset as ref_resolve
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.index.flat import FlatIndex as RefFlatIndex
from vectorsearch_rbac_tpu.index.flat_int8 import (
    Int8FlatIndex as RefInt8FlatIndex)
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.rbac.world import query_masks_for
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.bench import anonysys_executors as ae
from vectorsearch_rbac_tpu_torch.bench import cohere_rerank_legs as cr
from vectorsearch_rbac_tpu_torch.bench import qdtree_sweeps as qs
from vectorsearch_rbac_tpu_torch.bench import sift10m_merge_legs as sm
from vectorsearch_rbac_tpu_torch.bench import strategy_compare as sc
from vectorsearch_rbac_tpu_torch.bench.ground_truth import compute_recall
from vectorsearch_rbac_tpu_torch.index.flat_int8 import Int8FlatIndex
from vectorsearch_rbac_tpu_torch.ops.scan_int8 import MERGES
from vectorsearch_rbac_tpu_torch.partition.dynamic import plan_from_reference
from test_torch_packed import assert_same_topk, one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RUNNERS = (sc, ae, qs, cr, sm)
N, NQ, K = 10_240, 128, 10
MERGE_N, MERGE_NQ, MERGE_K = 20_480, 64, 100
# 64 queries: at 32 the reference's 768-d path returns other ids for the
# same queries than at 64 (its results depend on the batch; the port's
# do not, ROADMAP queue 3), so the legs are held at 64
COHERE_N, COHERE_NQ = 10_240, 64
RTOL = 1e-5


def ref_world(num_docs):
    return RefTreeGenerator(num_users=10_000, num_roles=100,
                            num_docs=num_docs, h=4, b0=3, b1=4,
                            seed=0).generate()


def ref_cfg(batch=1024, alpha=None, topk=None, ef=None, kind=None):
    cfg = RefFrameworkConfig(seed=0)
    cfg.search.batch_size = batch
    if alpha is not None:
        cfg.optimizer.storage_alpha = alpha
    if topk is not None:
        cfg.optimizer.topk = topk
    if ef is not None:
        cfg.search.ef_search = ef
    if kind is not None:
        cfg.index.kind = kind
    return cfg


@pytest.fixture(scope="module")
def scripts():
    """The strategy scripts' set-up in both packages: the runner's
    make_data, and the reference's corpus, world, workload, exact truth
    (FlatIndex exact on a float32 arena) and int8 arena of 131,072-row
    blocks, as scripts/strategy_compare_1m.py:43-61 compose them."""
    torch.set_num_threads(1)
    data = sc.make_data(N, NQ, K, CPU)
    rc, qpool = ref_corpus(num_vectors=N, blocks_per_doc=100, seed=0)
    rw = ref_world(rc.num_docs)
    rwl = ref_workload(rc, rw, num_queries=NQ, topk=K, zipf_param=0,
                       query_pool=qpool, seed=1)
    gt = ref_arena(rc, rw, block_rows=65536, dtype="float32",
                   with_aug=False)
    qmasks = query_masks_for(rw.user_masks, rwl.user_ids)
    _, truth = RefFlatIndex(gt, None, block_rows=65536, mode="exact",
                            query_batch=1024).search(rwl.vectors, qmasks, K)
    ra = ref_arena(rc, rw, block_rows=131072, dtype="int8")
    return dict(data=data, rc=rc, rw=rw, rwl=rwl, truth=np.asarray(truth),
                ra=ra)


def _search(s, q, uids, masks, k=K):
    return s.search_batch(q, uids, masks, k)


def test_scripts_data_is_the_scripts(scripts):
    """The runners' corpus, queries, users and truth are the scripts'."""
    d, c = scripts["data"], scripts
    np.testing.assert_array_equal(d["corpus"].vectors, c["rc"].vectors)
    np.testing.assert_array_equal(d["queries"], c["rwl"].vectors)
    np.testing.assert_array_equal(d["uids"], c["rwl"].user_ids)
    np.testing.assert_array_equal(d["world"].user_masks, c["rw"].user_masks)
    np.testing.assert_array_equal(d["truth"], c["truth"])
    assert d["arena"].n_padded == 131072 and d["arena"].quant.lossless


# ---- bench.strategy_compare: the five strategies


@pytest.mark.parametrize("name", sc.STRATEGIES)
def test_strategy_matches_the_script(scripts, name, one_thread):
    """Each strategy as the runner builds it against build_searcher at the
    script's config: the same partition count, ids and recall@10; the
    measured row carries the record's keys."""
    d, c = scripts["data"], scripts
    mine, _ = sc.build(name, d)
    rcfg = ref_cfg(batch=2048 if name == "rls" else 1024, alpha=2.0, topk=K)
    kw = {"workload": c["rwl"]} if name == "qdtree" else {}
    want_s = ref_searcher(name, c["rc"], c["rw"], c["ra"], rcfg, **kw)
    assert mine.storage_report().get("num_partitions", 1) == \
        want_s.storage_report().get("num_partitions", 1)
    got = _search(mine, d["queries"], d["uids"], d["world"].user_masks)
    want = _search(want_s, c["rwl"].vectors, c["rwl"].user_ids,
                   c["rw"].user_masks)
    assert_same_topk(got, want, rtol=RTOL)
    assert compute_recall(got[1], d["truth"]) == pytest.approx(
        ref_recall(np.asarray(want[1]), c["truth"]), abs=1e-12)
    if name == "qdtree":
        row = sc.measure(name, mine, d, 0.0)
        assert set(row) >= {"recall_at_10", "qps", "ms_per_query",
                            "storage_mb", "partitions", "build_s",
                            "pass_walls_s", "kernels"}
        assert len(row["pass_walls_s"]) == 5
        assert row["recall_at_10"] == round(
            ref_recall(np.asarray(want[1]), c["truth"]), 4)


# ---- bench.anonysys_executors: AnonySys's three executors


def test_executors_match_the_script(scripts, one_thread):
    """C plans with the port's planner and matches the reference's plan
    and ids; A and B, built by the runner on the reference's plan (brought
    across with plan_from_reference), return the reference's ids and
    recall, B with the same graph partitions."""
    d, c = scripts["data"], scripts
    flat, plan, _ = ae.plan_and_flat(d)
    want_c = ref_searcher("dynamic", c["rc"], c["rw"], c["ra"],
                          ref_cfg(alpha=2.0, topk=K, ef=ae.EF))
    assert len(plan.assignment) == len(want_c.plan.assignment)
    assert plan.assignment == want_c.plan.assignment
    q, uids = d["queries"], d["uids"]
    rq, ruids = c["rwl"].vectors, c["rwl"].user_ids
    assert_same_topk(_search(flat, q, uids, d["world"].user_masks),
                     _search(want_c, rq, ruids, c["rw"].user_masks),
                     rtol=RTOL)
    ref_plan = want_c.plan
    for name, kind in (("hnsw_iterative", "hnsw"), ("hybrid", "hybrid")):
        # A's iterative search runs its step loop here: a quarter of them
        nq = NQ // 4 if kind == "hnsw" else NQ
        q, uids = d["queries"][:nq], d["uids"][:nq]
        rq, ruids = c["rwl"].vectors[:nq], c["rwl"].user_ids[:nq]
        mine, _ = ae.build_executor(name, d, plan_from_reference(ref_plan))
        want_s = ref_searcher("dynamic", c["rc"], c["rw"], c["ra"],
                              ref_cfg(alpha=2.0, topk=K, ef=ae.EF,
                                      kind=kind),
                              plan=ref_plan, packed=False)
        assert ae.graph_partitions(mine) == sum(
            1 for p in want_s.partitions.values()
            if type(p.index).__name__ == "HNSWIndex")
        got = _search(mine, q, uids, d["world"].user_masks)
        want = _search(want_s, rq, ruids, c["rw"].user_masks)
        assert_same_topk(got, want, rtol=RTOL)
        assert compute_recall(got[1], d["truth"][:nq]) == pytest.approx(
            ref_recall(np.asarray(want[1]), c["truth"][:nq]), abs=1e-12)


# ---- bench.qdtree_sweeps: QDTree's radius ladder and margin


def test_radius_ladder_matches_the_script(scripts, one_thread):
    """ROLE and QDTree at each radius scale: the reference's partition
    counts and recall@10 at the scales the strategy compare does not
    build (ROLE and QDTree at 0.3, the default, are held to the
    reference's ids by test_strategy_matches_the_script); the keys name
    the TPU record's entries."""
    d, c = scripts["data"], scripts
    built = qs.build_ladder(d, None)
    assert list(built) == ["role", "qdtree@0.2_v640", "qdtree@0.25_v640",
                           "qdtree@0.3_v640"]
    rows = qs.radius_ladder(d, built, None, rounds=1)
    assert rows["role"]["partitions"] == 100
    for scale in (0.2, 0.25):
        key = f"qdtree@{scale}_v640"
        want_s = ref_searcher("qdtree", c["rc"], c["rw"], c["ra"],
                              ref_cfg(topk=K), workload=c["rwl"],
                              radius_scale=scale)
        want = _search(want_s, c["rwl"].vectors, c["rwl"].user_ids,
                       c["rw"].user_masks)
        assert rows[key]["partitions"] == \
            want_s.storage_report()["num_partitions"]
        assert rows[key]["recall_at_10"] == round(
            ref_recall(np.asarray(want[1]), c["truth"]), 4)
    assert [qs.radius_keys(1_000_000, v)[f"qdtree@0.3_v{w}"][1]
            for v, w in ((None, 8192), (512, 512))] == [
                "qdtree@0.3_v8192", "qdtree@0.3"]


def test_margin_script_leg_changes_nothing(scripts, one_thread):
    """The script's swap of vector_router on a tree with a route radius:
    every margin routes the same leaves and returns the same ids."""
    # the tree is built from all the workload's queries; a quarter of
    # them are searched
    d = dict(scripts["data"])
    d.update(queries=d["queries"][:NQ // 4], uids=d["uids"][:NQ // 4],
             truth=d["truth"][:NQ // 4])
    done = qs.margin_legs(d, ["script"], {})
    assert done["tree"]["centroid_nodes"] > 0
    assert 0 < done["tree"]["leaves_under_centroids"] <= done["tree"][
        "leaves"]
    rows = done["script"]
    assert list(rows) == [str(m) for m in qs.MARGINS]
    for row in rows.values():
        assert row["leaves_same_as_0.0"] and row["ids_same_as_0.0"]
        assert row["avg_leaves"] == rows["0.0"]["avg_leaves"]
        assert row["recall_at_10"] == rows["0.0"]["recall_at_10"]


def test_margin_rule_leg_matches_reference_routes(scripts, one_thread):
    """On the same tree without its radius both packages' routers decide
    by the margin: the leaves change with the margin, and the port's batch
    and vector routes equal the reference's at every margin."""
    d, c = scripts["data"], scripts
    mine = qs.margin_searcher(d).tree
    rcfg = ref_cfg()
    ref_tree = ref_searcher("qdtree", c["rc"], c["rw"], c["ra"], rcfg,
                            workload=c["rwl"]).tree
    assert mine.route_radius == pytest.approx(ref_tree.route_radius,
                                              rel=1e-6)
    ref_flat = dataclasses.replace(ref_tree, route_radius=None)
    q, uids = d["queries"], d["uids"]
    routes = {}
    for m in qs.MARGINS:
        s = qs.margin_rule_searcher(d, mine, m)
        want_s = ref_searcher("qdtree", c["rc"], c["rw"], c["ra"], rcfg,
                              tree=ref_flat, prune_margin=m)
        routes[m] = s.batch_router(q, uids)
        assert routes[m] == [tuple(r) for r in want_s.batch_router(q, uids)]
        assert qs.leaves(s.vector_router, d) == [
            tuple(want_s.vector_router(int(u), q[j]))
            for j, u in enumerate(uids[:qs.LEAVES_SAMPLE])]
    assert routes[0.0] != routes[0.5]
    assert np.mean([len(r) for r in routes[0.0]]) < np.mean(
        [len(r) for r in routes[0.5]])


# ---- Int8FlatIndex(merge=) and bench.sift10m_merge_legs's legs


@pytest.fixture(scope="module")
def merge_case():
    """20,480 SIFT-like rows of the scripts' world on an int8 arena of
    16,384-row blocks (32,768 padded rows: group 8, 4,096 groups), both
    packages' arenas, 64 pool queries and their users' masks."""
    rc, qpool = ref_corpus(num_vectors=MERGE_N, blocks_per_doc=100, seed=0)
    rw = ref_world(rc.num_docs)
    rwl = ref_workload(rc, rw, num_queries=MERGE_NQ, topk=MERGE_K,
                       zipf_param=0, query_pool=qpool, seed=1)
    ra = ref_arena(rc, rw, block_rows=16384, dtype="int8")
    masks = np.asarray(query_masks_for(rw.user_masks, rwl.user_ids),
                       np.uint32)
    return dict(ra=ra, arena=arena_from_reference(ra, "cpu"),
                q=rwl.vectors.astype(np.float32), masks=masks)


@pytest.mark.parametrize("merge,ref_merge", [
    ("kernel", "pallas"), ("cascade", "cascade"), ("exact", "exact")])
def test_int8_index_merge_matches_reference(merge_case, merge, ref_merge,
                                            one_thread):
    """Int8FlatIndex(merge=) on 4,096 groups against the reference's
    merge= (the port's "kernel" is its "pallas"), on the f32 wire."""
    c = merge_case
    mine = Int8FlatIndex(c["arena"], None, query_batch=2048, wire="f32",
                         merge=merge)
    assert mine.group == 8 and c["arena"].n_padded // mine.group == 4096
    want = RefInt8FlatIndex(c["ra"], None, query_batch=2048, wire="f32",
                            merge=ref_merge).search(c["q"], c["masks"],
                                                    MERGE_K)
    assert_same_topk(mine.search(c["q"], c["masks"], MERGE_K), want,
                     rtol=RTOL)


def test_int8_index_refuses_an_unknown_merge(merge_case):
    assert MERGES == ("kernel", "cascade", "approx", "auto", "exact")
    assert Int8FlatIndex(merge_case["arena"]).merge == "kernel"
    with pytest.raises(ValueError, match="merge 'pallas'"):
        Int8FlatIndex(merge_case["arena"], merge="pallas")


@pytest.mark.parametrize("leg", list(sm.LEGS))
def test_sift10m_leg_matches_the_script(merge_case, leg, one_thread):
    """Each leg's index as the runner makes it against the script's
    Int8FlatIndex(query_batch 2048, q_tile 2048, wire, merge): the same
    ids (the ids wire carries ranks, so ids only there)."""
    c = merge_case
    merge, wire = sm.LEGS[leg]
    got = sm.make_index(c["arena"], leg).search(c["q"], c["masks"], MERGE_K)
    want = RefInt8FlatIndex(
        c["ra"], None, query_batch=2048, q_tile=2048, wire=wire,
        merge={"kernel": "pallas"}.get(merge, merge)).search(
            c["q"], c["masks"], MERGE_K)
    if wire == "ids":
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    else:
        assert_same_topk(got, want, rtol=RTOL)


def _ref_truth_sample(rc, rw, rwl, ns, k, metric, query_batch):
    """scripts/sift10m_r4.py:48-58 (cohere_768d_r5.py:67-79): the truth of
    the first ns queries from the reference's oracle."""
    sub = RefWorkload(vectors=rwl.vectors[:ns].astype(np.float32),
                      user_ids=rwl.user_ids[:ns], topk=k,
                      selectivities=rwl.selectivities[:ns],
                      repetitions=rwl.repetitions[:ns])
    gt = ref_arena(rc, rw, block_rows=65536, dtype="float32",
                   with_aug=False, metric=metric)
    return RefOracle(gt, block_rows=65536, query_batch=query_batch).compute(
        rc, rw, sub, k)


def assert_same_truth(got, want):
    """Equal truth rows, as sets: the two oracles may order rows at an
    equal distance differently."""
    np.testing.assert_array_equal(np.sort(got, axis=1),
                                  np.sort(np.asarray(want), axis=1))


def test_sift10m_data_is_the_scripts():
    """make_data at 20,480 rows: the script's queries, masks, truth of the
    sample and arena padding."""
    torch.set_num_threads(1)
    data = sm.make_data(MERGE_N, 256, 128, CPU)
    rc, qpool = ref_corpus(num_vectors=MERGE_N, blocks_per_doc=100, seed=0)
    rw = ref_world(rc.num_docs)
    rwl = ref_workload(rc, rw, num_queries=256, topk=sm.K, zipf_param=0,
                       query_pool=qpool, seed=1)
    np.testing.assert_array_equal(data["queries"], rwl.vectors)
    np.testing.assert_array_equal(
        data["masks"], query_masks_for(rw.user_masks, rwl.user_ids))
    assert_same_truth(data["truth"],
                      _ref_truth_sample(rc, rw, rwl, 128, sm.K, "l2", 512))
    assert data["arena"].n_padded == 131072


# ---- bench.cohere_rerank_legs: the 768-d rerank legs


@pytest.fixture(scope="module")
def cohere_case():
    """The script's corpus, world and workload at 10,240 cohere-like rows
    in both packages (the runner's make_data; the reference composed as
    scripts/cohere_768d_r5.py:57-84 composes it), and a cosine int8 arena
    of 16,384-row blocks."""
    torch.set_num_threads(1)
    data = cr.make_data(COHERE_N, 256, 128, CPU)
    rc, qpool = ref_resolve("cohere", num_vectors=COHERE_N, seed=0)
    rw = ref_world(rc.num_docs)
    rwl = ref_workload(rc, rw, num_queries=256, topk=cr.K, zipf_param=0,
                       query_pool=qpool, seed=1)
    ra = ref_arena(rc, rw, block_rows=16384, dtype="int8", metric="cosine")
    return dict(data=data, rc=rc, rw=rw, rwl=rwl, ra=ra,
                arena=arena_from_reference(ra, "cpu"))


def test_cohere_data_is_the_scripts(cohere_case):
    c = cohere_case
    d = c["data"]
    np.testing.assert_array_equal(d["queries"], c["rwl"].vectors)
    np.testing.assert_array_equal(
        d["masks"], query_masks_for(c["rw"].user_masks, c["rwl"].user_ids))
    assert_same_truth(d["truth"], _ref_truth_sample(
        c["rc"], c["rw"], c["rwl"], 128, cr.K, "cosine", 1024))
    assert d["arena"].n_padded == 131072 and d["arena"].metric == "cosine"


@pytest.mark.parametrize("leg", list(cr.LEGS))
def test_cohere_leg_matches_the_script(cohere_case, leg, one_thread):
    """Each leg's index as the runner makes it against the script's
    Int8FlatIndex(query_batch 2048, q_tile 2048, wire, rerank_mode) on the
    768-d cosine arena: the same ids (ranks only on the ids wire)."""
    c = cohere_case
    mode, wire = cr.LEGS[leg]
    q = c["data"]["queries"][:COHERE_NQ]
    masks = c["data"]["masks"][:COHERE_NQ]
    idx = cr.make_index(c["arena"], leg)
    assert idx.wide and idx.rerank_mode == mode
    got = idx.search(q, masks, cr.K)
    want = RefInt8FlatIndex(c["ra"], None, query_batch=2048, q_tile=2048,
                            wire=wire, rerank_mode=mode).search(q, masks,
                                                                cr.K)
    if wire == "ids":
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    else:
        assert_same_topk(got, want, rtol=RTOL)


# ---- each runner's checkpoint and resume, refusal and imports


def _fake_data(n, nq, *a):
    return {}


def test_strategy_compare_checkpoints_and_resumes(tmp_path, monkeypatch,
                                                  capsys):
    ck = str(tmp_path / "state" / "sc.json")
    built = []
    monkeypatch.setattr(sc, "make_data", _fake_data)
    monkeypatch.setattr(sc, "build", lambda name, data: (built.append(name)
                                                         or None, 0.0))
    monkeypatch.setattr(sc, "measure", lambda name, s, data, b: {"qps": 1})
    out = sc.run(["rls", "role"], CPU, checkpoint=ck)
    assert built == ["rls", "role"] and json.load(open(ck))["role"]["qps"]
    out = sc.run(list(sc.STRATEGIES), CPU, out=json.load(open(ck)),
                 checkpoint=ck)
    assert built == ["rls", "role", "user", "dynamic", "qdtree"]
    monkeypatch.setattr(sc, "make_data", None)   # a resumed run builds none
    assert sc.main(["--checkpoint", ck, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(sc.STRATEGIES) <= set(line)
    assert line["protocol"]["reference_record"].startswith(
        sc.REFERENCE_RECORD) and line["hardware"] == "cpu"


def test_anonysys_executors_checkpoint_and_resume(tmp_path, monkeypatch,
                                                  capsys):
    """A run of C alone records the plan; a rerun of A and B plans again
    without C and keeps C's plan_s."""
    ck = str(tmp_path / "ae.json")
    plan = type("Plan", (), {"assignment": {0: {1}, 1: {2}}})()
    monkeypatch.setattr(ae, "make_data", _fake_data)
    monkeypatch.setattr(ae, "plan_and_flat", lambda d: (None, plan, 7.0))
    planned = []
    monkeypatch.setattr(ae, "plan_only", lambda d: planned.append(1) or plan)
    monkeypatch.setattr(ae, "build_executor", lambda n, d, p: (n, 3.0))
    monkeypatch.setattr(ae, "graph_partitions", lambda s: 1)
    monkeypatch.setattr(ae, "measure", lambda n, s, d: {"qps": 1.0})
    ae.run(["tiled_flat"], CPU, checkpoint=ck)
    saved = json.load(open(ck))
    assert saved["plan_s"] == 7.0 and saved["plan_partitions"] == 2
    assert "hybrid" not in saved and not planned
    ae.run(list(ae.EXECUTORS), CPU, out=saved, checkpoint=ck)
    saved = json.load(open(ck))
    assert planned == [1] and saved["plan_s"] == 7.0
    assert saved["hnsw_build_s"] == saved["hybrid_build_s"] == 3.0
    assert saved["hybrid_graph_partitions"] == 1
    monkeypatch.setattr(ae, "make_data", None)
    assert ae.main(["--checkpoint", ck, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(ae.EXECUTORS) <= set(line) and line["config"] == ae.CONFIG


def test_qdtree_sweeps_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    ck = str(tmp_path / "qs.json")
    monkeypatch.setattr(qs, "make_data", _fake_data)
    monkeypatch.setattr(qs, "build_ladder", lambda d, v: {})
    monkeypatch.setattr(qs, "radius_ladder", lambda d, s, v: {
        key: {"qps": 1} for key in qs.radius_keys(qs.N, v)})
    legs = []

    def fake_margin(d, which, done, save):
        for leg in which:
            legs.append(leg)
            done[leg] = {str(m): {"qps": 1} for m in qs.MARGINS}
            save()
        return done

    monkeypatch.setattr(qs, "margin_legs", fake_margin)
    out = qs.run("radius", CPU, checkpoint=ck)
    assert "qdtree@0.3_v8192" in json.load(open(ck))["radius"]
    out = qs.run("margin", CPU, legs=["script"], out=out, checkpoint=ck)
    out = qs.run("margin", CPU, out=json.load(open(ck)), checkpoint=ck)
    assert legs == ["script", "script", "margin_rule"]
    monkeypatch.setattr(qs, "make_data", None)
    assert qs.main(["radius", "--checkpoint", ck, "--device", "cpu"]) == 0
    assert qs.main(["margin", "--checkpoint", ck, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["margin"]) == set(qs.MARGIN_LEGS)


def test_cohere_legs_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    ck = str(tmp_path / "cr.json")
    monkeypatch.setattr(cr, "make_data", _fake_data)
    monkeypatch.setattr(cr, "run_legs", lambda d: {
        leg: {"qps_median": 1} for leg in cr.LEGS})
    cr.run(CPU, checkpoint=ck)
    assert set(json.load(open(ck))["legs"]) == set(cr.LEGS)
    monkeypatch.setattr(cr, "make_data", None)
    assert cr.main(["--checkpoint", ck, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == cr.CONFIG and set(line["legs"]) == set(cr.LEGS)


def test_sift10m_legs_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    ck = str(tmp_path / "sm.json")
    measured = []
    monkeypatch.setattr(sm, "make_data", _fake_data)
    monkeypatch.setattr(sm, "measure", lambda leg, d: measured.append(leg)
                        or {"qps": 1})
    sm.run(["cascade_u8"], CPU, checkpoint=ck)
    sm.run(list(sm.LEGS), CPU, out=json.load(open(ck)), checkpoint=ck)
    assert measured == ["cascade_u8", "pallas_ids", "pallas_u8"]
    monkeypatch.setattr(sm, "make_data", None)
    assert sm.main(["--checkpoint", ck, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line["legs"]) == set(sm.LEGS)


@pytest.mark.parametrize("runner", RUNNERS, ids=lambda m: m.__name__)
def test_runner_refuses_without_cuda(runner, monkeypatch, capsys):
    """--device defaults to cuda: without a card each runner exits 2
    before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["radius"] if runner is qs else []
    assert runner.main(args) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_runners_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            + "".join(f"import {m.__name__}\n" for m in RUNNERS)
            + "print(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'vectorsearch_rbac_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
