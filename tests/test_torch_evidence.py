"""The evidence runners (bench.graph_crossover, bench.model_validation,
bench.ivf_coverage, bench.binary_1m) against the JAX reference on the CPU.

The reference's scripts are not imported (scripts/graph_crossover.py
points jax's compile cache into the repository at import, and
scripts/ivf_coverage_validation.py runs its whole grid at import): the
reference side is composed here from the reference package's own
functions as each script composes them, on the same seeds, at small
sizes. Held equal: the crossover's world, corpora and grid; its flat
leg's ids on 8,192 rows; its graph ladder's ids and recalls on a
4,096-row graph (both packages build the same classic graph); a whole
crossover cell's recalls; the model validation's per-cell recalls over a
2 x 2 x 3 grid on 8,192 rows and its fitted recall parameters (rtol
1e-6: the fits see the same points); the IVF coverage cell's recall by
nprobe on 16,384 rows over the reference's lists, and its coverage fit
refitted by the reference's fit_ivf_coverage to 1e-9; the binary 768-d
cosine leg's ids on 10,240 rows (the fewest its 100-role world takes).
Each runner exits 2 without CUDA and imports neither jax nor the
reference package.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.bench.ground_truth import (
    compute_recall as ref_recall)
from vectorsearch_rbac_tpu.bench.queries import (
    generate_query_workload as ref_workload)
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import resolve_dataset as ref_resolve
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_sift
from vectorsearch_rbac_tpu.index.binary import (
    BinaryQuantIndex as RefBinaryIndex)
from vectorsearch_rbac_tpu.index.flat import FlatIndex as RefFlatIndex
from vectorsearch_rbac_tpu.index.flat_int8 import (
    Int8FlatIndex as RefInt8FlatIndex)
from vectorsearch_rbac_tpu.index.hnsw import HNSWIndex as RefHNSWIndex
from vectorsearch_rbac_tpu.index.ivf import IVFIndex as RefIVFIndex
from vectorsearch_rbac_tpu.models import fitting as ref_fitting
from vectorsearch_rbac_tpu.models import validate as ref_validate
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.rbac.world import RBACWorld as RefWorld
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.bench import binary_1m, graph_crossover
from vectorsearch_rbac_tpu_torch.bench import ivf_coverage, model_validation
from vectorsearch_rbac_tpu_torch.bench.queries import (
    generate_query_workload)
from vectorsearch_rbac_tpu_torch.data import resolve_dataset
from vectorsearch_rbac_tpu_torch.index.ivf import ivf_from_reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
K = graph_crossover.TOPK
RUNNERS = (graph_crossover, model_validation, ivf_coverage, binary_1m)
FIT_RTOL = 1e-6


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def script_world(num_docs, seed):
    """scripts/graph_crossover.py:49-58 on the reference's RBACWorld."""
    rng = np.random.default_rng(seed)
    role_to_docs = {3: frozenset(range(num_docs))}
    for role, p in ((2, 0.2), (1, 0.036), (0, 0.005)):
        role_to_docs[role] = frozenset(
            np.flatnonzero(rng.random(num_docs) < p).tolist())
    return RefWorld(num_users=4, num_roles=4, num_docs=num_docs,
                    user_to_roles={u: (u,) for u in range(4)},
                    role_to_docs=role_to_docs)


def script_corpus_768(n, d, seed):
    """scripts/graph_crossover.py:68-79: (vectors, pool, doc, block)."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((256, d)).astype(np.float32) * 0.5
    assign = rng.integers(0, 256, n)
    v = centers[assign] + rng.standard_normal((n, d)).astype(np.float32)
    v = np.clip(np.rint(v * 24 + 128), 0, 255).astype(np.float32)
    qpool = v[rng.choice(n, 8192, replace=False)] + rng.standard_normal(
        (8192, d)).astype(np.float32) * 2
    qpool = np.clip(np.rint(qpool), 0, 255).astype(np.float32)
    return (v, qpool, (np.arange(n) // 100).astype(np.int32),
            (np.arange(n) % 100).astype(np.int32))


def sha(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def test_crossover_grid_world_and_corpora_are_the_scripts():
    with open(os.path.join(REPO, "results", "graph_crossover.json")) as f:
        record = json.load(f)
    cells = {(n, d, s) for n, d, _, _, sels in graph_crossover.GRID
             for s in sels.values()}
    assert len(cells) == 11
    assert cells == {(c["n"], c["d"], c["selectivity"])
                     for c in record["cases"]}
    assert graph_crossover.CONFIG == record["config"]
    for num_docs, seed in ((1311, 1), (2621, 3)):
        got, want = graph_crossover.make_world(num_docs, seed), script_world(
            num_docs, seed)
        assert dict(got.role_to_docs) == dict(want.role_to_docs)
        assert dict(got.user_to_roles) == dict(want.user_to_roles)
        np.testing.assert_array_equal(got.user_masks, want.user_masks)
    corpus, pool = graph_crossover.corpus_for(8192, 768, seed=2)
    assert sha(corpus.vectors, pool, corpus.doc_ids, corpus.block_ids) == sha(
        *script_corpus_768(8192, 768, 2))
    corpus, pool = graph_crossover.corpus_for(4096, 128, seed=0)
    want, want_pool = ref_sift(num_vectors=4096, blocks_per_doc=100, seed=0)
    assert sha(corpus.vectors, pool, corpus.doc_ids) == sha(
        want.vectors, want_pool, want.doc_ids)
    assert [graph_crossover.group_for(n) for n in
            (8192, 131072, 262144, 524288, 1_000_000, 2_000_000)] == [
                8, 16, 32, 64, 64, 128]


def _crossover_state(n, nq):
    """The reference's corpus, world and int8 arena (the script's), the
    port's engines built by the runner from its own corpus and world, and
    the runner's queries."""
    rc, _ = ref_sift(num_vectors=n, blocks_per_doc=100, seed=0)
    rw = script_world(rc.num_docs, 1)
    ra = ref_arena(rc, rw, block_rows=65536, dtype="int8")
    corpus, pool = graph_crossover.corpus_for(n, 128, seed=0)
    world = graph_crossover.make_world(corpus.num_docs, seed=1)
    arena, flat, graph, _ = graph_crossover.build_engines(corpus, world, CPU)
    return dict(rc=rc, rw=rw, ra=ra, corpus=corpus, pool=pool, world=world,
                arena=arena, flat=flat, graph=graph,
                q=graph_crossover.crossover_queries(pool, nq))


def _ref_truth(s, masks):
    gt = ref_arena(s["rc"], s["rw"], block_rows=65536, dtype="float32",
                   with_aug=False)
    return RefFlatIndex(gt, None, block_rows=65536, mode="exact",
                        query_batch=1024).search(s["q"], masks, K)[1]


@pytest.fixture(scope="module")
def crossover_4k():
    return _crossover_state(4096, 16)


def test_crossover_flat_leg_matches_reference(one_thread):
    """The runner's Int8FlatIndex on 8,192 rows (group 8) returns the
    reference's ids (the script's constructor) at selectivity 0.036 and
    1.0."""
    s = _crossover_state(8192, 32)
    ref = RefInt8FlatIndex(s["ra"], None, query_batch=2048, q_tile=2048,
                           block_rows=8192,
                           group=graph_crossover.group_for(8192))
    ref.set_user_table(s["rw"].user_masks)
    assert s["flat"].group == ref.group == 8
    for uid in (1, 3):
        masks = s["world"].user_masks[np.full(len(s["q"]), uid)]
        want = ref.search(s["q"], masks, K)[1]
        got = s["flat"].search(s["q"], masks, K)[1]
        np.testing.assert_array_equal(got, want)
        assert (got >= 0).all()


@pytest.mark.parametrize("uid", [1, 3])
def test_crossover_graph_ladder_matches_reference(crossover_4k, uid,
                                                  one_thread):
    """On a 4,096-row graph (both packages' classic build, equal), every
    ladder leg at ef 40 and 80 (and the harvest legs at selectivity
    0.036) returns the reference HNSWIndex.search's ids with the same
    kwargs, and the same recall against the reference's oracle."""
    s = crossover_4k
    ref = RefHNSWIndex(s["ra"], None, m=16, ef_construction=64,
                       ef_search=40, query_batch=1024)
    assert s["graph"].builder == ref.builder == "classic"
    for key in ("neighbors", "entry"):
        np.testing.assert_array_equal(s["graph"].graph_state()[key],
                                      ref.graph_state()[key])
    sel = graph_crossover.SELS[uid]
    masks = s["world"].user_masks[np.full(len(s["q"]), uid)]
    truth = _ref_truth(s, masks)
    legs = graph_crossover.ladder_legs(sel, (40, 80))
    assert len(legs) == (4 if uid == 1 else 2)
    for ef, harvest in legs:
        kw = graph_crossover.graph_kwargs(ef, harvest)
        want = ref.search(s["q"], masks, K, **kw)[1]
        got = s["graph"].search(s["q"], masks, K, **kw)[1]
        np.testing.assert_array_equal(got, want)
        assert graph_crossover.compute_recall(got, truth) == ref_recall(
            want, truth)


def test_crossover_cell_matches_reference_and_resumes(crossover_4k, tmp_path,
                                                      one_thread):
    """measure_case end to end at 4,096 rows, selectivity 1.0, ef 40: the
    record's keys, the flat and graph recalls equal to the reference's
    on the same queries, the checkpoint written, and a rerun skipping
    the measured cell."""
    s = crossover_4k
    out = {"config": graph_crossover.CONFIG, "cases": []}
    ck = str(tmp_path / "state" / "graph_crossover.json")
    graph_crossover.measure_case(s["corpus"], s["pool"], s["world"],
                                 {3: 1.0}, out, CPU, efs=(40,),
                                 nq=len(s["q"]), checkpoint=ck)
    (row,) = out["cases"]
    assert set(row) >= {"n", "d", "selectivity", "flat_qps", "flat_recall",
                        "graph_qps", "graph_recall", "graph_ef",
                        "graph_harvest", "graph_ladder", "graph_build_s",
                        "winner", "graph_builder"}
    assert (row["n"], row["d"], row["selectivity"]) == (4096, 128, 1.0)
    masks = s["world"].user_masks[np.full(len(s["q"]), 3)]
    truth = _ref_truth(s, masks)
    ref_flat = RefInt8FlatIndex(s["ra"], None, query_batch=2048,
                                q_tile=2048, block_rows=8192, group=8)
    assert row["flat_recall"] == round(ref_recall(
        ref_flat.search(s["q"], masks, K)[1], truth), 4)
    ref_graph = RefHNSWIndex(s["ra"], None, m=16, ef_construction=64,
                             ef_search=40, query_batch=1024)
    (leg,) = row["graph_ladder"]
    assert (leg["ef"], leg["harvest"]) == (40, False)
    assert leg["recall"] == round(ref_recall(ref_graph.search(
        s["q"], masks, K, **graph_crossover.graph_kwargs(40, False))[1],
        truth), 4)
    with open(ck) as f:
        assert json.load(f) == out
    graph_crossover.measure_case(s["corpus"], s["pool"], s["world"],
                                 {3: 1.0}, out, CPU, efs=(40,),
                                 nq=len(s["q"]), checkpoint=ck)
    assert len(out["cases"]) == 1


def test_model_validation_grid_matches_reference(one_thread):
    """The runner over a 2 x 2 x 3 grid on 8,192 rows against the
    reference's multi_parameter_validation composed as the script
    composes it: equal per-cell recalls, and the joint fit's recall
    parameters (k, beta, ef_offset, gamma_n) and the TPU family's (k, s,
    w, C, g, h) within rtol 1e-6. Times are the machine's: not compared."""
    n, sels, sizes, efs, nq = 8192, [0.1, 1.0], [2048, 4096], [16, 32, 64], 32
    got, got_tpu = model_validation.run(CPU, n=n, sels=sels, sizes=sizes,
                                        efs=efs, nq=nq, timing_reps=1)
    corpus, qpool = ref_sift(num_vectors=n, blocks_per_doc=100, seed=0)
    world = ref_validate.selectivity_lab_world(corpus.num_docs, sels, seed=1)
    arena = ref_arena(corpus, world, block_rows=16384)
    rng = np.random.default_rng(2)
    queries = qpool[rng.choice(len(qpool), nq, replace=False)].astype(
        np.float32)
    want = ref_validate.multi_parameter_validation(
        corpus, world, sels, sizes, efs, 10, queries, arena=arena,
        index_kind="hnsw", fit_offset=True, fit_mode="joint",
        builder="classic", timing_reps=1)
    want_tpu = ref_validate.refit_tpu_family_from_json(want, 10)
    assert len(got["cells"]) == len(want["cells"]) == 4
    for g, w in zip(got["cells"], want["cells"]):
        assert (g["n"], g["sel"], g["efs"]) == (w["n"], w["sel"], w["efs"])
        assert g["measured_recall"] == w["measured_recall"]
    for key in ("k", "beta", "ef_offset", "gamma_n"):
        np.testing.assert_allclose(got["params"][key], want["params"][key],
                                   rtol=FIT_RTOL, atol=1e-12)
    for key in ("k", "s", "w", "C", "g", "h"):
        np.testing.assert_allclose(got_tpu["params"][key],
                                   want_tpu["params"][key], rtol=FIT_RTOL,
                                   atol=1e-12)
    rows = model_validation.beside_records(got, got_tpu, records=[
        os.path.join(REPO, p) for p in model_validation.TPU_RECORDS])
    assert [(r["n"], r["sel"]) for r in rows] == [
        (c["n"], c["sel"]) for c in got["cells"]]


def test_ivf_coverage_cell_matches_reference(one_thread):
    """On 16,384 rows (nlist 128) at selectivity 0.1, the runner's cell
    over the reference's lists (ivf_from_reference) measures the
    script's recall at every nprobe (1-8: at this size 4 probes already
    find every neighbour), and the reference's fit_ivf_coverage
    on the cell's even points returns the cell's fit to 1e-9."""
    n, sels, nq, nprobes = 16384, [0.1, 0.5], 32, [1, 2, 3, 4, 6, 8]
    corpus, qpool = ref_sift(num_vectors=n, blocks_per_doc=100, seed=0)
    world = ref_validate.selectivity_lab_world(corpus.num_docs, sels, seed=1)
    ra = ref_arena(corpus, world, block_rows=65536)
    bits = corpus.vector_role_bits(world)
    rng = np.random.default_rng(2)
    queries = qpool[rng.choice(len(qpool), nq, replace=False)].astype(
        np.float32)
    rows = np.sort(rng.choice(corpus.n, n, replace=False))
    ref = RefIVFIndex(ra, rows=rows, nlist=max(64, int(np.sqrt(n))),
                      query_batch=nq, seed=0)
    # the script's measurement (:102-122) on the reference's index
    si, sel = 0, sels[0]
    masks = np.tile(world.user_masks[si], (nq, 1))
    allowed = (bits[rows] & world.user_masks[si]).any(axis=1)
    sub_vec = corpus.vectors[rows]
    d2 = (np.einsum("nd,nd->n", sub_vec, sub_vec)[None, :]
          - 2.0 * queries @ sub_vec.T)
    d2[:, ~allowed] = np.inf
    order = np.argsort(d2, axis=1, kind="stable")[:, :K]
    truth = rows[order]
    truth[np.take_along_axis(d2, order, axis=1) == np.inf] = -1
    want = []
    for npb in nprobes:
        i = ref.search(queries, masks, K, nprobe=npb)[1]
        hit = (i[:, :, None] == truth[:, None, :]) & (truth >= 0)[:, None, :]
        denom = np.maximum((truth >= 0).sum(axis=1), 1)
        want.append(float((hit.any(axis=1).sum(axis=1) / denom).mean()))
    np.testing.assert_array_equal(
        ivf_coverage.subset_truth(corpus, rows, allowed, queries, K, CPU),
        truth)
    arena = arena_from_reference(ra, CPU)
    cell = ivf_coverage.coverage_cell(
        ivf_from_reference(ref, CPU), corpus, arena, rows, bits,
        world.user_masks[si], sel, queries, nprobes)
    assert cell["measured_recall"] == [round(r, 4) for r in want]
    assert len(set(want)) > 1      # the sweep moves recall
    fit = cell["fit"]
    again = ref_fitting.fit_ivf_coverage(
        np.array(nprobes)[::2], np.array(want)[::2], l_pad=fit["l_pad"],
        a=fit["a"], b=fit["b"])
    np.testing.assert_allclose([fit[k] for k in ("k", "lam", "sigma")],
                               [again.k, again.lam, again.sigma],
                               rtol=1e-9, atol=1e-12)


def test_ivf_coverage_run_checkpoints_and_resumes(tmp_path, one_thread):
    """run at 4,096 rows: the record's keys, a cell a (size, sel), the
    checkpoint after each, and a rerun from it building nothing."""
    ck = str(tmp_path / "state" / "ivf_coverage.json")
    kw = dict(n=4096, sels=[0.25], sizes=[2048, 4096], nprobes=[4, 8],
              nq=16)
    out = ivf_coverage.run(CPU, checkpoint=ck, **kw)
    assert set(out) >= {"config", "cells", "heldout_recall_mae",
                        "time_mape", "hnsw_family_reference_mae"}
    assert [(c["n"], c["sel"]) for c in out["cells"]] == [(2048, 0.25),
                                                          (4096, 0.25)]
    with open(ck) as f:
        assert json.load(f)["cells"] == out["cells"]
    again = ivf_coverage.run(CPU, cells=out["cells"], **kw)
    assert again["cells"] == out["cells"]


def test_binary_768d_leg_matches_reference(one_thread):
    """The 768-d cosine leg on 10,240 rows: the leg's world and workload
    are the script's, and the runner's index (bfloat16 arena, 32,768-row
    blocks, rerank on) returns the reference BinaryQuantIndex's ids at
    multipliers 2 and 8. The reference runs its exact candidate
    selection: the script's mode="approx" (approx_min_k over the bit
    distances) is not ported, the port's bit scan being exact; on these
    rows the approximate one returns other rows for 23% of the slots."""
    n, nq = 10240, 24
    rc, rpool = ref_resolve("cohere", num_vectors=n, seed=0)
    rw = RefTreeGenerator(num_users=10_000, num_roles=100,
                          num_docs=rc.num_docs, h=4, b0=3, b1=4,
                          seed=0).generate()
    rwl = ref_workload(rc, rw, num_queries=nq, topk=100, zipf_param=0,
                       query_pool=rpool, seed=1)
    corpus, pool = resolve_dataset("cohere", num_vectors=n, seed=0)
    world = binary_1m.leg_world(corpus)
    np.testing.assert_array_equal(world.user_masks, rw.user_masks)
    wl = generate_query_workload(corpus, world, num_queries=nq, topk=100,
                                 zipf_param=0, query_pool=pool, seed=1)
    np.testing.assert_array_equal(wl.vectors, rwl.vectors)
    np.testing.assert_array_equal(wl.user_ids, rwl.user_ids)
    ra = ref_arena(rc, rw, block_rows=32768, dtype="bfloat16",
                   with_aug=False, metric="cosine")
    arena = arena_from_reference(ra, CPU)
    masks = rw.user_masks[rwl.user_ids].astype(np.uint32)
    for mult in (2, 8):
        ref = RefBinaryIndex(ra, None, block_rows=32768, query_batch=512,
                             rerank=True, rerank_mult=mult, mode="exact")
        want = ref.search(rwl.vectors, masks, 100)[1]
        got = binary_1m.make_index(arena, mult).search(wl.vectors, masks,
                                                       100)[1]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("runner", RUNNERS, ids=lambda m: m.__name__)
def test_runner_refuses_without_cuda(runner, monkeypatch, capsys):
    """--device defaults to cuda: without a card each runner exits 2
    before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert runner.main([]) == 2
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
