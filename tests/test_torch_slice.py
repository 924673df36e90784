"""The port's RLS int8 slices end to end against the JAX reference.

Both packages build the same small worlds from the same seeds, each with
its own code: a SIFT-like one (L2, lossless, the narrow kernel) and a
cohere-like one (384-d unit vectors, lossy, the wide kernel and the
float32 rerank, for cosine and L2). The port's arenas come from the
reference's through arena_from_reference, so both compute on the same
state. The reference runs as its own tests run it on the CPU (Pallas in
interpret mode); the port runs its kernels' plain versions. Ids are
compared per query with equal-distance ids as sets (torch.topk and
lax.top_k order ties differently)."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import vectorsearch_rbac_tpu_torch as port
from vectorsearch_rbac_tpu.bench.ground_truth import (
    GroundTruthOracle as RefOracle)
from vectorsearch_rbac_tpu.bench.queries import (
    generate_query_workload as ref_workload)
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import cohere_like_corpus as ref_cohere
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import (GroundTruthOracle,
                                         arena_from_reference, build_searcher,
                                         generate_query_workload,
                                         run_benchmark)
from vectorsearch_rbac_tpu_torch.ops.merge import merge_supported

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS, N_QUERIES, K, BLOCK = 16384, 128, 10, 8192
COHERE_DIM = 384


def _build(corpus_fn, generator, config, **corpus_kw):
    corpus, pool = corpus_fn(num_vectors=N_ROWS, seed=0, **corpus_kw)
    w = generator(num_users=400, num_roles=40, num_docs=corpus.num_docs,
                  h=3, b0=3, b1=3, seed=0).generate()
    cfg = config(seed=0)
    cfg.index.kind = "flat_approx"
    cfg.search.batch_size = N_QUERIES
    cfg.search.block_rows = BLOCK
    cfg.search.wire_dist = "ids"
    return corpus, pool, w, cfg


@pytest.fixture(scope="module")
def world():
    """The reference's (corpus, world, workload, cfg)."""
    corpus, _, w, cfg = _build(ref_corpus, RefTreeGenerator,
                               RefFrameworkConfig)
    workload = ref_workload(corpus, w, num_queries=N_QUERIES, topk=K,
                            zipf_param=0, seed=1)
    return corpus, w, workload, cfg


@pytest.fixture(scope="module")
def port_world():
    """The port's (corpus, world, workload, cfg), built by its own code."""
    corpus, _, w, cfg = _build(port.sift_like_corpus, port.TreeRBACGenerator,
                               port.FrameworkConfig)
    workload = generate_query_workload(corpus, w, num_queries=N_QUERIES,
                                       topk=K, zipf_param=0, seed=1)
    return corpus, w, workload, cfg


@pytest.fixture(scope="module")
def cohere_world():
    """The reference's cohere-like (corpus, world, workload, cfg), 384-d,
    queries from the held-out pool as bench.py draws them; the f32 wire,
    so that both sides' rerank distances come back."""
    corpus, pool, w, cfg = _build(ref_cohere, RefTreeGenerator,
                                  RefFrameworkConfig, dim=COHERE_DIM)
    cfg.search.wire_dist = "f32"
    workload = ref_workload(corpus, w, num_queries=N_QUERIES, topk=K,
                            zipf_param=0, query_pool=pool, seed=1)
    return corpus, w, workload, cfg


@pytest.fixture(scope="module")
def port_cohere_world():
    corpus, pool, w, cfg = _build(port.cohere_like_corpus,
                                  port.TreeRBACGenerator,
                                  port.FrameworkConfig, dim=COHERE_DIM)
    cfg.search.wire_dist = "f32"
    workload = generate_query_workload(corpus, w, num_queries=N_QUERIES,
                                       topk=K, zipf_param=0, query_pool=pool,
                                       seed=1)
    return corpus, w, workload, cfg


def _sq_dists(corpus, q, ids):
    """Exact squared L2 of each returned row (float64; -1 -> inf)."""
    x = corpus.vectors[np.maximum(ids, 0)].astype(np.float64)
    d = ((x - q[:, None, :].astype(np.float64)) ** 2).sum(axis=2)
    return np.where(ids < 0, np.inf, d)


def assert_same_up_to_ties(corpus, q, got, want):
    """Same distance list per query, and the same ids at every distance
    below the k-th (ids at the k-th distance may be any of the tied ones)."""
    dg, dw = _sq_dists(corpus, q, got), _sq_dists(corpus, q, want)
    np.testing.assert_array_equal(np.sort(dg, axis=1), np.sort(dw, axis=1))
    for qi in range(len(q)):
        kth = dw[qi].max()
        inner = dw[qi] < kth
        assert set(want[qi][inner]) == set(got[qi][dg[qi] < kth]), qi


def _metric_dists(corpus, q, ids, metric):
    """Exact float64 distance of each returned row (-1 -> inf): squared L2,
    or 1 - cos."""
    x = corpus.vectors[np.maximum(ids, 0)].astype(np.float64)
    q = q.astype(np.float64)[:, None, :]
    if metric == "l2":
        d = ((x - q) ** 2).sum(axis=2)
    else:
        x /= np.linalg.norm(x, axis=2, keepdims=True)
        d = 1.0 - (x * q).sum(axis=2) / np.linalg.norm(q, axis=2)
    return np.where(ids < 0, np.inf, d)


def assert_same_up_to_near_ties(got_d, got_i, want_d, want_i, atol):
    """Both sides' float32 distances, sorted, agree to atol; the id sets
    agree except ids whose distance lies within atol of the k-th (there
    float32 sums taken in another order may pick another row)."""
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=atol)
    for q in range(len(got_i)):
        both = set(got_i[q]) & set(want_i[q])
        kth = want_d[q, -1]
        for d, i in [*zip(got_d[q], got_i[q]), *zip(want_d[q], want_i[q])]:
            assert i in both or abs(d - kth) <= atol, (q, i, d, kth)


def test_workload_copy_is_identical(world, port_world):
    mine, want = port_world[2], world[2]
    for field in ("vectors", "user_ids", "selectivities", "repetitions"):
        a, b = getattr(mine, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field


def test_rls_ids_match_reference(world, port_world):
    corpus, w, workload, cfg = world
    ra = ref_arena(corpus, w, block_rows=BLOCK, dtype="int8")
    ref = ref_searcher("rls", corpus, w, ra, cfg)
    _, want = ref.search_batch(workload.vectors, workload.user_ids,
                               w.user_masks, K)

    p_corpus, p_w, p_workload, p_cfg = port_world
    searcher = build_searcher("rls", p_corpus, p_w,
                              arena_from_reference(ra, "cpu"), p_cfg)
    index = searcher.partitions[0].index
    assert index.group == ref.partitions[0].index.group == 8
    assert merge_supported(N_ROWS // index.group, K)   # the kernel merge path
    _, got = searcher.search_batch(p_workload.vectors, p_workload.user_ids,
                                   p_w.user_masks, K)
    assert got.shape == want.shape == (N_QUERIES, K)
    assert (got >= 0).sum() > 0.9 * got.size
    assert_same_up_to_ties(corpus, workload.vectors, got, want)


def test_rls_ids_match_reference_past_256_roles():
    """A 300-role tree world (10 bitset words, past the 8 that the first
    kernel forms took) through RLS: the port's ids equal the reference's
    on the same arena (its one-hot width 384)."""
    kw = dict(num_users=1200, num_roles=300, h=4, b0=3, b1=4, seed=0)
    corpus, _ = ref_corpus(num_vectors=N_ROWS, blocks_per_doc=10, seed=0)
    w = RefTreeGenerator(num_docs=corpus.num_docs, **kw).generate()
    cfg = RefFrameworkConfig(seed=0)
    p_cfg = port.FrameworkConfig(seed=0)
    for c in (cfg, p_cfg):
        c.index.kind = "flat_approx"
        c.search.batch_size = N_QUERIES
        c.search.block_rows = BLOCK
        c.search.wire_dist = "ids"
    workload = ref_workload(corpus, w, num_queries=N_QUERIES, topk=K,
                            zipf_param=0, seed=1)
    ra = ref_arena(corpus, w, block_rows=BLOCK, dtype="int8")
    _, want = ref_searcher("rls", corpus, w, ra, cfg).search_batch(
        workload.vectors, workload.user_ids, w.user_masks, K)
    p_corpus, _ = port.sift_like_corpus(num_vectors=N_ROWS,
                                        blocks_per_doc=10, seed=0)
    p_w = port.TreeRBACGenerator(num_docs=p_corpus.num_docs, **kw).generate()
    assert p_w.words == 10
    np.testing.assert_array_equal(p_w.user_masks, w.user_masks)
    searcher = build_searcher("rls", p_corpus, p_w,
                              arena_from_reference(ra, "cpu"), p_cfg)
    _, got = searcher.search_batch(workload.vectors, workload.user_ids,
                                   p_w.user_masks, K)
    assert got.shape == want.shape == (N_QUERIES, K)
    assert (got >= 0).sum() > 0.5 * got.size
    assert_same_up_to_ties(corpus, workload.vectors, got, want)


@pytest.mark.parametrize("strategy", ["rls", "role"])
def test_rls_ids_match_reference_past_1024_roles(strategy):
    """A 1,100-role tree world (35 bitset words, past the 32 of the wide
    kernel forms) on a small corpus through RLS (the global scan) and ROLE
    (the chunk engine): the port's ids equal the reference's on the same
    arena."""
    kw = dict(num_users=2200, num_roles=1100, h=7, b0=2, b1=3, seed=0)
    corpus, _ = ref_corpus(num_vectors=4096, blocks_per_doc=2, seed=0)
    w = RefTreeGenerator(num_docs=corpus.num_docs, **kw).generate()
    cfg = RefFrameworkConfig(seed=0)
    p_cfg = port.FrameworkConfig(seed=0)
    for c in (cfg, p_cfg):
        c.index.kind = "flat_approx"
        c.search.batch_size = N_QUERIES
        c.search.block_rows = 4096
        c.search.wire_dist = "ids" if strategy == "rls" else "f32"
    workload = ref_workload(corpus, w, num_queries=N_QUERIES, topk=K,
                            zipf_param=0, seed=1)
    ra = ref_arena(corpus, w, block_rows=4096, dtype="int8")
    _, want = ref_searcher(strategy, corpus, w, ra, cfg).search_batch(
        workload.vectors, workload.user_ids, w.user_masks, K)
    p_corpus, _ = port.sift_like_corpus(num_vectors=4096, blocks_per_doc=2,
                                        seed=0)
    p_w = port.TreeRBACGenerator(num_docs=p_corpus.num_docs, **kw).generate()
    assert p_w.words == 35
    np.testing.assert_array_equal(p_w.user_masks, w.user_masks)
    searcher = build_searcher(strategy, p_corpus, p_w,
                              arena_from_reference(ra, "cpu"), p_cfg)
    _, got = searcher.search_batch(workload.vectors, workload.user_ids,
                                   p_w.user_masks, K)
    assert got.shape == want.shape == (N_QUERIES, K)
    assert (got >= 0).sum() > 0.5 * got.size
    assert_same_up_to_ties(corpus, workload.vectors, got, want)


@pytest.mark.parametrize("wire", ["u8", "bf16", "f32"])
def test_rls_wires_match_reference(world, port_world, wire):
    """The global path's result wires against the reference's on the same
    arena: the distances come back bit for bit (the scan, the merge and
    the decode are the reference's, and the wire is its byte format), the
    ids as in test_rls_ids_match_reference. The port's pass takes the
    2-byte uid wire with a resident user table, the reference's search_batch
    mask rows."""
    corpus, w, workload, cfg = world
    ra = ref_arena(corpus, w, block_rows=BLOCK, dtype="int8")
    cfg.search.wire_dist = wire
    try:
        ref = ref_searcher("rls", corpus, w, ra, cfg)
        want_d, want_i = ref.search_batch(workload.vectors, workload.user_ids,
                                          w.user_masks, K)
    finally:
        cfg.search.wire_dist = "ids"
    p_corpus, p_w, p_workload, p_cfg = port_world
    p_cfg.search.wire_dist = wire
    try:
        searcher = build_searcher("rls", p_corpus, p_w,
                                  arena_from_reference(ra, "cpu"), p_cfg)
    finally:
        p_cfg.search.wire_dist = "ids"
    index = searcher.partitions[0].index
    got_d, got_i = searcher.search_batch(p_workload.vectors,
                                         p_workload.user_ids, p_w.user_masks,
                                         K)
    assert index.wire == wire and index._last_uid_wire
    np.testing.assert_array_equal(got_d, want_d)
    assert_same_up_to_ties(corpus, workload.vectors, got_i, want_i)


@pytest.mark.parametrize("metric,mode", [("cosine", "residual4"),
                                         ("l2", "dequant")])
def test_cohere_rls_ids_match_reference(cohere_world, port_cohere_world,
                                        metric, mode):
    """The 384-d slice: the wide scan, the merge at kk = k + 32 and the
    mode the reference picks by default on wide rows. The f32 wire carries
    both sides' rerank distances: they agree to 1e-5 (float32 dots of 384
    terms in another summation order), the ids as sets up to near-ties."""
    corpus, w, workload, cfg = cohere_world
    ra = ref_arena(corpus, w, block_rows=BLOCK, dtype="int8", metric=metric)
    ref = ref_searcher("rls", corpus, w, ra, cfg)
    want_d, want_i = ref.search_batch(workload.vectors, workload.user_ids,
                                      w.user_masks, K)

    p_corpus, p_w, p_workload, p_cfg = port_cohere_world
    searcher = build_searcher("rls", p_corpus, p_w,
                              arena_from_reference(ra, "cpu"), p_cfg)
    index = searcher.partitions[0].index
    assert index.wide and index.rerank and index.rerank_mode == mode
    assert ref.partitions[0].index.rerank_mode == mode
    assert index.group == ref.partitions[0].index.group == 8
    got_d, got_i = searcher.search_batch(p_workload.vectors,
                                         p_workload.user_ids, p_w.user_masks,
                                         K)
    assert got_i.shape == want_i.shape == (N_QUERIES, K)
    assert (got_i >= 0).sum() > 0.9 * got_i.size
    assert_same_up_to_near_ties(got_d, got_i, want_d, want_i, atol=1e-5)


def test_cosine_oracle_matches_reference(cohere_world, port_cohere_world,
                                         tmp_path):
    corpus, w, workload, _ = cohere_world
    ra = ref_arena(corpus, w, block_rows=BLOCK, dtype="float32",
                   with_aug=False, metric="cosine")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = RefOracle(ra, cache_dir=str(ref_dir), block_rows=BLOCK,
                     query_batch=64).compute(corpus, w, workload, K)
    p_corpus, p_w, p_workload, _ = port_cohere_world
    oracle = GroundTruthOracle(arena_from_reference(ra, "cpu"),
                               cache_dir=str(port_dir), block_rows=BLOCK,
                               query_batch=64)
    got = oracle.compute(p_corpus, p_w, p_workload, K)
    # exact float64 cosine distances; the two float32 oracles may swap
    # only rows within 1e-6 of the k-th
    dg = _metric_dists(corpus, workload.vectors, got, "cosine")
    dw = _metric_dists(corpus, workload.vectors, want, "cosine")
    assert_same_up_to_near_ties(np.sort(dg, axis=1), got,
                                np.sort(dw, axis=1), want, atol=1e-6)
    # the cache key is the reference's, metric included
    (cached,) = port_dir.glob("gt_*.npy")
    assert [cached.name] == [p.name for p in ref_dir.glob("gt_*.npy")]


def test_oracle_matches_reference(world, port_world, tmp_path):
    corpus, w, workload, _ = world
    ra = ref_arena(corpus, w, block_rows=BLOCK, dtype="float32",
                   with_aug=False)
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = RefOracle(ra, cache_dir=str(ref_dir), block_rows=BLOCK,
                     query_batch=64).compute(corpus, w, workload, K)
    p_corpus, p_w, p_workload, _ = port_world
    oracle = GroundTruthOracle(arena_from_reference(ra, "cpu"),
                               cache_dir=str(port_dir), block_rows=BLOCK,
                               query_batch=64)
    got = oracle.compute(p_corpus, p_w, p_workload, K)
    assert_same_up_to_ties(corpus, workload.vectors, got, want)
    # the cache key is the reference's content hash; a second call reads it
    (cached,) = port_dir.glob("gt_*.npy")
    assert [cached.name] == [p.name for p in ref_dir.glob("gt_*.npy")]
    np.testing.assert_array_equal(
        oracle.compute(p_corpus, p_w, p_workload, K), got)


def test_harness_reports_recall(port_world):
    corpus, w, workload, cfg = port_world
    from vectorsearch_rbac_tpu_torch import build_device_arena

    arena = build_device_arena(corpus, w, device="cpu", block_rows=BLOCK,
                               dtype="int8")
    gt = build_device_arena(corpus, w, device="cpu", block_rows=BLOCK)
    res = run_benchmark(build_searcher("rls", corpus, w, arena, cfg), corpus,
                        w, workload, GroundTruthOracle(gt, block_rows=BLOCK),
                        k=K, warmup_runs=1, timed_batches=3, timed_passes=2)
    assert res.avg_recall >= 0.95 and res.extra["recall_sample"] == N_QUERIES
    assert res.extra["device"] == "cpu" and len(res.extra["pass_walls_ms"]) == 2
    assert res.storage["num_partitions"] == 1


_JAX_FREE = """
import sys
from vectorsearch_rbac_tpu_torch import build_device_arena, build_searcher
from vectorsearch_rbac_tpu_torch.bench import make_scenario, serving_config
corpus, w, wl = make_scenario(n=16384, num_queries=8, topk=5)
cfg = serving_config(block_rows=16384, batch=8, topk=5)
arena = build_device_arena(corpus, w, device="cpu", block_rows=16384,
                           dtype="int8")
s = build_searcher("rls", corpus, w, arena, cfg)
_, ids = s.search_batch(wl.vectors, wl.user_ids, w.user_masks, 5)
assert ids.shape == (8, 5), ids.shape
# the 768-d cosine path: wide scan, merge, residual4 rerank
corpus, w, wl = make_scenario(n=16384, num_queries=8, topk=5,
                              dataset="cohere")
arena = build_device_arena(corpus, w, device="cpu", block_rows=16384,
                           dtype="int8", metric="cosine")
s = build_searcher("rls", corpus, w, arena, cfg)
index = s.partitions[0].index
assert index.wide and index.rerank_mode == "residual4", index.rerank_mode
_, ids = s.search_batch(wl.vectors, wl.user_ids, w.user_masks, 5)
assert ids.shape == (8, 5) and (ids >= 0).all(), ids
# AnonySys: the port's planner and the chunk engine; then a big tier
import numpy as np
from vectorsearch_rbac_tpu_torch.partition import TiledSearcher
corpus, w, wl = make_scenario(n=16384, num_queries=8, topk=5)
arena = build_device_arena(corpus, w, device="cpu", block_rows=16384,
                           dtype="int8")
cfg = serving_config(block_rows=16384, topk=5, strategy="dynamic")
cfg.optimizer.storage_alpha = 2.0
s = build_searcher("dynamic", corpus, w, arena, cfg)
s_plan = s.plan
assert len(s.plan.assignment) > 1, s.plan.assignment
_, ids = s.search_batch(wl.vectors, wl.user_ids, w.user_masks, 5)
assert ids.shape == (8, 5) and (ids >= 0).all(), ids
s = TiledSearcher(arena, {0: np.arange(6000)}, lambda uid: (0,), "big",
                  big_chunks=2)
assert list(s._big) == [0]
_, ids = s.search_batch(wl.vectors, wl.user_ids, w.user_masks, 5)
assert ids.shape == (8, 5) and ids.max() < 6000, ids
# the hybrid executor: HNSW graphs (native build, graph batcher, the graph
# step) beside the int8 scan on the remainder
cfg.index.kind = "hybrid"
s = build_searcher("dynamic", corpus, w, arena, cfg, plan=s_plan,
                   packed=False)
assert len(s.graph_batcher.pids) > 1, s.graph_batcher.pids
_, ids = s.search_batch(wl.vectors, wl.user_ids, w.user_masks, 5)
assert ids.shape == (8, 5) and (ids >= 0).all(), ids
# the kernel lab's entry point and modules, and its merges on the CPU
import torch
import vectorsearch_rbac_tpu_torch.bench.lab
import vectorsearch_rbac_tpu_torch.bench.merge_ab
from vectorsearch_rbac_tpu_torch.ops import lab_merge, lab_scan
mins = torch.randint(0, 1 << 29, (1024, 16), dtype=torch.int32)
assert lab_merge.extract_merge_v2(mins, 10, 128, 8, 16)[0].shape == (16, 10)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "vectorsearch_rbac_tpu"]
assert not ref, ref
print("JAX_FREE_OK")
"""


def test_port_never_imports_jax():
    """Import + build + search (the SIFT-like L2 path, the 768-d cosine
    path, the AnonySys planner with the chunk engine and a big tier, and
    its hybrid executor with HNSW graphs; the kernel lab's modules),
    through the entry points chip_smoke.py uses, in a fresh
    interpreter (this one has jax loaded by tests/conftest.py): neither jax
    nor the reference package loads."""
    out = subprocess.run([sys.executable, "-c", _JAX_FREE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "JAX_FREE_OK" in out.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_cuda(tmp_path, alone):
    """No CUDA device (or no package beside the script): a non-zero exit
    and no ok line."""
    if alone:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    cwd = str(tmp_path) if alone else REPO
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_bench_entry_refuses_unported_and_cpu(capsys):
    from vectorsearch_rbac_tpu_torch.bench.__main__ import parse_args

    assert parse_args([]).strategy == "rls"
    args = parse_args(["--dataset", "cohere", "--metric", "cosine"])
    assert (args.dataset, args.metric) == ("cohere", "cosine")
    for name in ("role", "user", "dynamic", "qdtree"):
        assert parse_args(["--strategy", name]).strategy == name
    # served since the PackedSearcher and IVF: float32 arenas and
    # partitioned strategies on ip/cosine (tests/test_torch_packed.py has
    # the rest of the flags)
    assert parse_args(["--dtype", "float32", "--index", "flat"]).dtype == \
        "float32"
    assert parse_args(["--strategy", "role", "--metric",
                       "cosine"]).metric == "cosine"
    # served since the flat family's breadth: the synthetic corpus and the
    # bfloat16 arena; l1 on the int8 default stays refused, as bench.py's
    assert parse_args(["--dataset", "synthetic"]).dataset == "synthetic"
    assert parse_args(["--dtype", "bfloat16"]).dtype == "bfloat16"
    # served since HNSW's remaining paths: HNSW under every strategy
    assert parse_args(["--strategy", "role", "--index", "hnsw"]).index == \
        "hnsw"
    for off in (["--metric", "l1"], ["--dataset", "sift10m"]):
        with pytest.raises(SystemExit):
            parse_args(off)
    assert "ROADMAP" in capsys.readouterr().err
    out = subprocess.run([sys.executable, "-m",
                          "vectorsearch_rbac_tpu_torch.bench", "--smoke"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
