"""The port's persistence and tracing on the CPU, against the JAX
reference where it has a counterpart: arena snapshots (lossless and lossy,
tombstones included) restore every tensor bit for bit and hold the arrays
the reference's snapshot holds; TiledSearcher snapshots, light and packed,
serve the live engine's ids (the big tier included); fitted parameters,
pickles, npz state and HNSW graphs round-trip; the searchers' stage
timers report the reference's stages; device_trace writes a trace."""

import json
import os

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_sift_like
from vectorsearch_rbac_tpu.data import synthetic_corpus as ref_synthetic
from vectorsearch_rbac_tpu.models import cost as ref_cost
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils import persist as ref_persist
from vectorsearch_rbac_tpu.utils.tracing import StageTimer as RefStageTimer
from vectorsearch_rbac_tpu_torch import build_device_arena, build_searcher
from vectorsearch_rbac_tpu_torch.config import FrameworkConfig
from vectorsearch_rbac_tpu_torch.core import tombstone_rows
from vectorsearch_rbac_tpu_torch.data import (sift_like_corpus,
                                              synthetic_corpus)
from vectorsearch_rbac_tpu_torch.index.flat_int8 import Int8FlatIndex
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.models import cost
from vectorsearch_rbac_tpu_torch.partition.tiled import TiledSearcher
from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator
from vectorsearch_rbac_tpu_torch.utils import persist
from vectorsearch_rbac_tpu_torch.utils.tracing import (StageTimer, annotate,
                                                       device_trace)

WORLD = dict(num_users=60, num_roles=12, num_docs=100, h=3, b0=2, b1=2,
             seed=9)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def world():
    return TreeRBACGenerator(**WORLD).generate()


def _corpus(kind):
    """(port corpus, reference corpus, metric): SIFT-like integer rows
    (lossless int8) or normal rows (lossy) in l2, or normal rows in
    cosine."""
    if kind == "lossless":
        kw = dict(num_vectors=1000, dim=32, blocks_per_doc=10, seed=9)
        return sift_like_corpus(**kw)[0], ref_sift_like(**kw)[0], "l2"
    kw = dict(num_docs=100, blocks_per_doc=10, dim=40, seed=4)
    return (synthetic_corpus(**kw), ref_synthetic(**kw),
            "cosine" if kind == "cosine" else "l2")


def assert_arenas_equal(a, b):
    for x, y in ((a.quant.vectors_q, b.quant.vectors_q),
                 (a.quant.norms_q, b.quant.norms_q),
                 (a.role_bits, b.role_bits), (a.vectors, b.vectors),
                 (a.norms, b.norms)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for f in ("host_bits", "host_norms", "doc_ids", "block_ids"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert (a.n, a.metric) == (b.n, b.metric)
    qa, qb = a.quant, b.quant
    assert (qa.scale, qa.lossless, qa.qclip) == (qb.scale, qb.lossless,
                                                 qb.qclip)
    np.testing.assert_array_equal(qa.center, qb.center)


@pytest.mark.parametrize("kind", ["lossless", "lossy", "cosine"])
def test_arena_snapshot_roundtrip_matches_reference_arrays(kind, world,
                                                           tmp_path):
    corpus, rcorpus, metric = _corpus(kind)
    arena = build_device_arena(corpus, world, device="cpu", block_rows=256,
                               dtype="int8", metric=metric)
    path = str(tmp_path / "arena.npz")
    persist.save_arena_snapshot(arena, path)
    back = persist.load_arena_snapshot(path, "cpu")
    assert_arenas_equal(arena, back)
    if kind == "lossless":
        np.testing.assert_array_equal(back.host_vectors, arena.host_vectors)
    else:   # the host mirror comes back at bfloat16 precision
        np.testing.assert_array_equal(
            back.host_vectors, torch.from_numpy(arena.host_vectors).to(
                torch.bfloat16).float().numpy())
    ref = ref_arena(rcorpus, RefTreeGenerator(**WORLD).generate(),
                    block_rows=256, dtype="int8", metric=metric)
    ref_path = str(tmp_path / "ref.npz")
    ref_persist.save_arena_snapshot(ref, ref_path)
    got, meta = persist.load_npz(path)
    want, ref_meta = ref_persist.load_npz(ref_path)
    assert meta == ref_meta
    assert set(got) == set(want) - {"roles8"}   # no int8 one-hots here
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_snapshot_keeps_tombstones_and_serves_identically(world, tmp_path):
    corpus, _, _ = _corpus("lossless")
    arena = tombstone_rows(build_device_arena(
        corpus, world, device="cpu", block_rows=256, dtype="int8"),
        np.arange(0, 1000, 7))
    path = str(tmp_path / "arena.npz")
    persist.save_arena_snapshot(arena, path)
    back = persist.load_arena_snapshot(path, "cpu")
    assert_arenas_equal(arena, back)
    assert not back.host_bits[::7][:143].any()
    rng = np.random.default_rng(3)
    q = rng.integers(0, 256, (32, corpus.dim)).astype(np.float32)
    masks = world.user_masks[rng.integers(0, world.num_users, 32)]
    kw = dict(query_batch=32, q_tile=32, block_rows=256, group=8)
    d1, i1 = Int8FlatIndex(arena, None, **kw).search(q, masks, 5)
    d2, i2 = Int8FlatIndex(back, None, **kw).search(q, masks, 5)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)
    with pytest.raises(ValueError, match="int8"):
        persist.save_arena_snapshot(build_device_arena(
            corpus, world, device="cpu", block_rows=256), path)


@pytest.mark.parametrize("big_logical", [False, True])
def test_tiled_snapshots_serve_the_live_ids(big_logical, world, tmp_path):
    corpus, _, _ = _corpus("lossless")
    arena = build_device_arena(corpus, world, device="cpu", block_rows=256,
                               dtype="int8")
    parts = {r: corpus.rows_for_docs(np.fromiter(d, np.int64))
             for r, d in sorted(world.role_to_docs.items())}
    sizes = {r: len(rows) for r, rows in parts.items()}
    u2r = world.user_to_roles

    def router(uid):
        return tuple(r for r in u2r.get(uid, ()) if r in parts)

    # chunks of 32 rows; partitions of more than 4 chunks take the big tier
    live = TiledSearcher(arena, parts, router, "role", chunk_rows=32,
                         q_tile=8, big_chunks=4, big_group=8,
                         big_logical=big_logical)
    assert live._big and live.part_chunks, sizes
    rng = np.random.default_rng(5)
    q = rng.integers(0, 256, (40, corpus.dim)).astype(np.float32)
    users = rng.integers(0, world.num_users, 40)
    want = live.search_batch(q, users, world.user_masks, 6)
    for pack in (False, True):
        path = str(tmp_path / f"tiled_{pack}.npz")
        live.save_snapshot(path, pack_arrays=pack)
        with np.load(path) as z:
            assert ("vecC" in z.files) == pack
        got = TiledSearcher.from_snapshot(arena, router, path)
        for f in ("_rowC", "_vecC", "_normC", "_roleC"):
            assert torch.equal(getattr(got, f), getattr(live, f)), f
        assert got.part_chunks == live.part_chunks
        assert {p: (ix.group, ix.logical, ix.n_rows)
                for p, ix in got._big.items()} == {
            p: (ix.group, ix.logical, ix.n_rows)
            for p, ix in live._big.items()}
        d, i = got.search_batch(q, users, world.user_masks, 6)
        np.testing.assert_array_equal(i, want[1])
        np.testing.assert_array_equal(d, want[0])
        assert set(got.timer.report()) >= {"route", "device_scan", "merge"}


def test_params_pickle_and_npz_roundtrip(world, tmp_path):
    cases = [
        (cost.CostModelParams(k=0.9, beta=0.5, a=2.0, b=3.0, join_time=1.0,
                              ef_offset=-4.0, n_ref=1e5, gamma_n=0.3),
         ref_cost.CostModelParams(k=0.9, beta=0.5, a=2.0, b=3.0,
                                  join_time=1.0, ef_offset=-4.0, n_ref=1e5,
                                  gamma_n=0.3)),
        (cost.IVFCoverageParams(k=0.99, lam=0.1, sigma=0.8, l_pad=640.0),
         ref_cost.IVFCoverageParams(k=0.99, lam=0.1, sigma=0.8,
                                    l_pad=640.0)),
        (cost.TPUCostParams(), ref_cost.TPUCostParams()),
    ]
    for i, (mine, ref) in enumerate(cases):
        p, rp = str(tmp_path / f"p{i}.json"), str(tmp_path / f"r{i}.json")
        persist.save_params(mine, p)
        ref_persist.save_params(ref, rp)
        with open(p) as f, open(rp) as g:
            assert json.load(f) == json.load(g)
        back = persist.load_params(rp)
        assert type(back) is type(mine) and back.to_dict() == mine.to_dict()
    pk = str(tmp_path / "sub" / "w.pkl")
    persist.save_pickle(world, pk)
    assert persist.load_pickle(pk).user_to_roles == world.user_to_roles
    nz = str(tmp_path / "s.npz")
    persist.save_npz({"a": np.arange(5), "b": np.eye(2)}, nz, kind="t", m=8)
    state, meta = persist.load_npz(nz)
    np.testing.assert_array_equal(state["a"], np.arange(5))
    assert meta == {"kind": "t", "m": 8}
    assert ref_persist.load_npz(nz)[1] == meta


def test_hnsw_graph_persists_through_npz(world, tmp_path):
    corpus, _, _ = _corpus("lossy")
    arena = build_device_arena(corpus, world, device="cpu", block_rows=256)
    idx = HNSWIndex(arena, m=8, ef_search=48, query_batch=16,
                    builder="classic", seed=0)
    p = str(tmp_path / "graph.npz")
    persist.save_npz(idx.graph_state(), p, m=8)
    state, meta = persist.load_npz(p)
    idx2 = HNSWIndex(arena, m=meta["m"], ef_search=48, query_batch=16,
                     graph_state=state)
    assert idx2.entry == idx.entry
    q = np.random.default_rng(0).standard_normal((8, corpus.dim)).astype(
        np.float32)
    masks = np.full((8, world.words), 0xFFFFFFFF, dtype=np.uint32)
    np.testing.assert_array_equal(idx.search(q, masks, 5)[1],
                                  idx2.search(q, masks, 5)[1])


def test_stage_timer_matches_reference():
    mine, ref = StageTimer(), RefStageTimer()
    for t in (mine, ref):
        for name in ("a", "a", "b"):
            with t.stage(name):
                pass
    assert {k: v["count"] for k, v in mine.report().items()} == \
        {k: v["count"] for k, v in ref.report().items()} == {"a": 2, "b": 1}
    assert mine.report()["a"].keys() == ref.report()["a"].keys()
    mine.reset()
    assert mine.report() == {}


@pytest.mark.parametrize("name,kind,dtype", [
    ("role", "flat", "int8"),        # the TiledSearcher
    ("user", "flat", "float32"),     # the PackedSearcher
    ("role", "ivf", "float32"),      # a PartitionedSearcher of IVF indexes
])
def test_searchers_report_the_reference_stages(name, kind, dtype, world):
    corpus, _, _ = _corpus("lossless")
    cfg = FrameworkConfig()
    cfg.search.block_rows = 256
    cfg.index.kind = kind
    cfg.index.ivf_nlist = 8
    arena = build_device_arena(corpus, world, device="cpu", block_rows=256,
                               dtype=dtype)
    s = build_searcher(name, corpus, world, arena, cfg)
    rng = np.random.default_rng(0)
    q = rng.standard_normal((8, corpus.dim)).astype(np.float32)
    s.search_batch(q, rng.integers(0, world.num_users, 8), world.user_masks,
                   5)
    rep = s.timer.report()
    assert {"route", "device_scan", "merge"} <= set(rep)
    assert all(v["count"] >= 1 for v in rep.values())
    if kind == "ivf":   # PartitionedSearcher.search_user: one query
        _, i = s.search_user(3, q[0], world.user_masks, 5)
        want = s.search_batch(q[:1], np.array([3]), world.user_masks, 5)
        np.testing.assert_array_equal(i, want[1][0])


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with device_trace(log_dir):
        with annotate("smoke.span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = os.listdir(log_dir)
    with open(os.path.join(log_dir, trace)) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "smoke.span" for e in events)
