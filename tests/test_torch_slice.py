"""The port's RLS int8 slice end to end against the JAX reference.

Both packages build the same small SIFT-like world from the same seeds,
each with its own code; the port's arenas come from the reference's
through arena_from_reference, so both compute on the same state. The
reference runs as its own tests run it on the CPU (Pallas in interpret
mode); the port runs its kernels' plain versions. Ids are compared per
query with equal-distance ids as sets (torch.topk and lax.top_k order
ties differently)."""

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


def _build(corpus_fn, generator, config):
    corpus, _ = corpus_fn(num_vectors=N_ROWS, seed=0)
    w = generator(num_users=400, num_roles=40, num_docs=corpus.num_docs,
                  h=3, b0=3, b1=3, seed=0).generate()
    cfg = config(seed=0)
    cfg.index.kind = "flat_approx"
    cfg.search.batch_size = N_QUERIES
    cfg.search.block_rows = BLOCK
    cfg.search.wire_dist = "ids"
    return corpus, w, cfg


@pytest.fixture(scope="module")
def world():
    """The reference's (corpus, world, workload, cfg)."""
    corpus, w, cfg = _build(ref_corpus, RefTreeGenerator, RefFrameworkConfig)
    workload = ref_workload(corpus, w, num_queries=N_QUERIES, topk=K,
                            zipf_param=0, seed=1)
    return corpus, w, workload, cfg


@pytest.fixture(scope="module")
def port_world():
    """The port's (corpus, world, workload, cfg), built by its own code."""
    corpus, w, cfg = _build(port.sift_like_corpus, port.TreeRBACGenerator,
                            port.FrameworkConfig)
    workload = generate_query_workload(corpus, w, num_queries=N_QUERIES,
                                       topk=K, zipf_param=0, seed=1)
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
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
ref = [m for m in sys.modules if m.split(".")[0] == "vectorsearch_rbac_tpu"]
assert not ref, ref
print("JAX_FREE_OK")
"""


def test_port_never_imports_jax():
    """Import + build + search, through the entry points chip_smoke.py
    uses, in a fresh interpreter (this one has jax loaded by
    tests/conftest.py): neither jax nor the reference package loads."""
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


def test_bench_entry_refuses_unported_and_cpu():
    from vectorsearch_rbac_tpu_torch.bench.__main__ import parse_args

    assert parse_args([]).strategy == "rls"
    with pytest.raises(SystemExit):
        parse_args(["--strategy", "role"])
    out = subprocess.run([sys.executable, "-m",
                          "vectorsearch_rbac_tpu_torch.bench", "--smoke"],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
