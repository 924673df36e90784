"""The port's float32 rerank tier (ops/rerank.py through Int8FlatIndex)
against the reference's, which lives inside the fused dispatch of
vectorsearch_rbac_tpu/index/flat_int8.py (`_scan_pack`) and runs here with
the Pallas kernels in interpret mode.

A small lossy corpus (Gaussian, 100-d) is quantized once by the reference;
the port computes on the same arena through arena_from_reference. For
every metric and each rerank mode the reference allows with it:

- the rebuilt query equals the reference's rebuild, transcribed below from
  `_scan_pack` (flat_int8.py:188-224) onto the reference's own host
  quantizers, to rtol 1e-6 (the same float32 operations; only cosine's
  norm sums in another order);
- the reranked (dists, ids) through Int8FlatIndex.search equal the
  reference's: dists to rtol 1e-5 / atol 1e-4 (float32 dots of 100 terms
  summed in another order), ids as sets except where a near-tie at the
  k-th distance lets the two orders pick different rows."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import Corpus as RefCorpus
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.index.flat_int8 import (
    Int8FlatIndex as RefInt8FlatIndex)
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.index.flat_int8 import Int8FlatIndex
from vectorsearch_rbac_tpu_torch.ops.rerank import rebuild_query

N, D, NQ, K = 4096, 100, 64, 10
CASES = [("l2", m) for m in ("dequant", "f16", "f32")] + [
    (metric, m) for metric in ("ip", "cosine")
    for m in ("dequant", "residual", "residual4", "f16", "f32")]


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((N, D), dtype=np.float32)
    docs = (np.arange(N) // 4).astype(np.int32)
    corpus = RefCorpus(vectors=vecs, doc_ids=docs,
                       block_ids=(np.arange(N) % 4).astype(np.int32))
    w = RefTreeGenerator(num_users=200, num_roles=24, num_docs=N // 4, h=3,
                         b0=2, b1=3, seed=0).generate()
    queries = rng.standard_normal((NQ, D), dtype=np.float32)
    masks = w.user_masks[rng.integers(0, 200, size=NQ)]
    arenas = {m: ref_arena(corpus, w, block_rows=4096, dtype="int8", metric=m)
              for m in ("l2", "ip", "cosine")}
    return arenas, queries, masks


def _reference_rebuild(quant, mode, metric, q):
    """The reference's rerank query (flat_int8.py:188-224), in numpy on the
    reference's host quantizers."""
    f32 = np.float32
    cosine = metric == "cosine"
    d = q.shape[1]
    if metric == "l2":
        q8, _ = quant.quantize_queries(q, with_norms=False)
    else:
        q8, inv, _ = quant.quantize_queries_ip(q, cosine=cosine)
    if mode == "f16":
        qf = q.astype(np.float16).astype(f32)
    elif mode == "f32":
        qf = q
    elif mode == "dequant" and metric == "l2":
        center = np.zeros(q8.shape[1], f32)
        center[:d] = quant.center
        qf = (q8.astype(f32) * f32(1.0 / quant.scale) + center)[:, :d]
    else:
        qx = q8.astype(f32)
        if mode == "residual":
            r8 = quant.query_residual8(q, q8, inv, cosine=cosine)
            qx = qx + r8.astype(f32) * f32(1 / 254.0)
        elif mode == "residual4":
            r4 = quant.query_residual4(q, q8, inv, cosine=cosine)
            lo = (r4 & 0xF).astype(f32) - 8.0
            hi = (r4 >> 4).astype(f32) - 8.0
            r = np.stack([lo, hi], axis=2).reshape(len(q), -1)
            qx = qx + r * f32(1 / 15.0)
        qf = (qx * (inv * f32(quant.scale))[:, None])[:, :d]
    if cosine:
        qf = qf / np.maximum(np.linalg.norm(qf, axis=1, keepdims=True), 1e-30)
    return qf


@pytest.mark.parametrize("metric,mode", CASES)
def test_rebuilt_query_matches_reference(world, metric, mode):
    arenas, queries, _ = world
    index = Int8FlatIndex(arena_from_reference(arenas[metric], "cpu"),
                          query_batch=NQ, rerank_mode=mode)
    assert index.rerank          # lossy corpus: every metric reranks
    ops = {name: torch.from_numpy(a)
           for name, a in index._quantize_host(queries).items()}
    got = rebuild_query(mode, metric, D, ops["q8"], inv=ops.get("inv"),
                        q_dequant=index._q_dequant, center=index._center,
                        residual=ops.get("res"), shipped=ops.get("qf"))
    want = _reference_rebuild(arenas[metric].quant, mode, metric, queries)
    assert got.dtype == torch.float32 and got.shape == (NQ, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


def assert_same_up_to_near_ties(got_d, got_i, want_d, want_i, atol):
    """Equal sorted distances; equal id sets, except ids whose distance
    lies within atol of the k-th."""
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=atol)
    flips = 0
    for q in range(len(got_i)):
        both = set(got_i[q]) & set(want_i[q])
        if len(both) == K:
            continue
        flips += 1
        kth = want_d[q, -1]
        for d, i in [*zip(got_d[q], got_i[q]), *zip(want_d[q], want_i[q])]:
            assert i in both or abs(d - kth) <= atol, (q, i, d, kth)
    assert flips <= 2, flips


@pytest.mark.parametrize("metric,mode", CASES)
def test_reranked_search_matches_reference(world, metric, mode):
    arenas, queries, masks = world
    ref = RefInt8FlatIndex(arenas[metric], query_batch=NQ, wire="f32",
                           rerank_mode=mode)
    want_d, want_i = ref.search(queries, masks, K)
    index = Int8FlatIndex(arena_from_reference(arenas[metric], "cpu"),
                          query_batch=NQ, wire="f32", rerank_mode=mode)
    assert index.group == ref.group == 8
    got_d, got_i = index.search(queries, masks, K)
    assert got_i.shape == want_i.shape == (NQ, K)
    assert (got_i >= 0).mean() > 0.9
    assert_same_up_to_near_ties(got_d, got_i, want_d, want_i, atol=1e-4)


def test_residual_modes_refuse_l2(world):
    arenas, _, _ = world
    arena = arena_from_reference(arenas["l2"], "cpu")
    for mode in ("residual", "residual4", "bf16"):
        with pytest.raises(ValueError):
            Int8FlatIndex(arena, rerank_mode=mode)
    assert Int8FlatIndex(arena).rerank_mode == "f16"   # narrow default
