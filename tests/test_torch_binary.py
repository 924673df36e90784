"""The port's binary index against the JAX reference on the CPU: pack_bits,
the popcount, the masked hamming and jaccard scan, and BinaryQuantIndex
(the rerank from the arena in each metric, without it the bit distances,
over the whole arena and a row subset).

Both packages build the world (48 roles) and the corpora from the same
seeds; the port's arena comes from the reference's through
arena_from_reference. Tolerances: the packed words, the popcounts, the
hamming and jaccard distances and the scan's ids (ties by row id, the
order lax.top_k gives) are bit-identical; reranked distances within rtol
1e-5 of the case's largest (float32 summation order), ids equal except
among distances within that tolerance, compared as sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsearch_rbac_tpu_torch as port
from test_torch_packed import assert_readable, assert_same_topk
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_sift
from vectorsearch_rbac_tpu.data import synthetic_corpus as ref_synthetic
from vectorsearch_rbac_tpu.index.binary import BinaryQuantIndex as RefBinary
from vectorsearch_rbac_tpu.ops.binary_scan import binary_topk_fn as ref_scan
from vectorsearch_rbac_tpu.ops.binary_scan import pack_bits as ref_pack
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.index.binary import BinaryQuantIndex
from vectorsearch_rbac_tpu_torch.ops.binary_scan import (masked_binary_topk,
                                                         pack_bits,
                                                         popcount32)

WORLD = dict(num_users=70, num_roles=48, num_docs=160, h=3, b0=2, b1=3,
             seed=21)
NQ, K, BLOCK = 20, 8, 512
ARENAS = [("sift", "float32", "l2"), ("synthetic", "bfloat16", "cosine"),
          ("synthetic", "float32", "ip"), ("synthetic", "float32", "l1")]


@pytest.fixture(scope="module")
def worlds():
    rw = RefTreeGenerator(**WORLD).generate()
    corpora = {
        "sift": ref_sift(num_vectors=1_600, dim=40, blocks_per_doc=10,
                         seed=7)[0],
        "synthetic": ref_synthetic(num_docs=160, blocks_per_doc=10, dim=70,
                                   seed=8),
    }
    rng = np.random.default_rng(9)
    queries = {name: (c.vectors[rng.integers(0, c.n, NQ)]
                      + rng.normal(0, 0.5 if name == "synthetic" else 10,
                                   (NQ, c.dim))).astype(np.float32)
               for name, c in corpora.items()}
    users = rng.integers(0, rw.num_users, NQ)
    arenas = {a: ref_arena(corpora[a[0]], rw, block_rows=BLOCK, dtype=a[1],
                           metric=a[2]) for a in ARENAS}
    return dict(rw=rw, pw=port.TreeRBACGenerator(**WORLD).generate(),
                corpora=corpora, q=queries, users=users, arenas=arenas,
                masks=rw.user_masks[users])


def test_pack_bits_identical():
    """The packed words equal the reference's: zero and per-dimension
    thresholds, a width past one word, extra words."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((37, 70)).astype(np.float32)
    thr = rng.standard_normal(70).astype(np.float32) * 0.1
    for args in ((v,), (v, thr), (v, thr, 4)):
        got, want = pack_bits(*args), ref_pack(*args)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        pack_bits(v, thr, words=2)


def test_popcount32_exact():
    """The SWAR count against numpy's bits on edge words (0, -1, INT_MIN,
    INT_MAX, single bits) and random int32 of both signs."""
    edge = np.array([0, -1, -2**31, 2**31 - 1, 1, 2**30, -2**30, 0x55555555,
                     -0x55555556], dtype=np.int32)
    rand = np.random.default_rng(1).integers(-2**31, 2**31, 4096,
                                             dtype=np.int64).astype(np.int32)
    x = np.concatenate([edge, rand])
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 32).sum(axis=1)
    got = popcount32(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_binary_scan_identical(worlds, metric):
    """masked_binary_topk on the same packed bits, role bits and masks as
    the reference's scan: identical distances and ids, ties included
    (k far past the distinct distances, so ties cross the k-th); rows a
    user cannot read never return."""
    w = worlds
    c = w["corpora"]["synthetic"]
    npad = 2 * BLOCK * ((c.n + 2 * BLOCK - 1) // (2 * BLOCK))
    bits = np.zeros((npad, 3), np.uint32)
    bits[:c.n] = ref_pack(c.vectors, np.median(c.vectors, axis=0))
    qbits = ref_pack(w["q"]["synthetic"], np.median(c.vectors, axis=0))
    rbits = np.zeros((npad, w["rw"].words), np.uint32)
    rbits[:c.n] = c.vector_role_bits(w["rw"])
    want = ref_scan(jnp.asarray(qbits), jnp.asarray(bits), jnp.asarray(rbits),
                    jnp.asarray(w["masks"]), 60, BLOCK, "exact",
                    metric=metric)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
    got = masked_binary_topk(t(qbits), t(bits), t(rbits), t(w["masks"]), 60,
                             BLOCK, metric=metric)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    ids = got[1].numpy()
    assert_readable(port.Corpus(vectors=c.vectors, doc_ids=c.doc_ids,
                                block_ids=c.block_ids), w["pw"], ids,
                    w["users"])


@pytest.mark.parametrize("bit_metric", ["hamming", "jaccard"])
def test_binary_scan_against_numpy(worlds, bit_metric):
    """The index without rerank against a numpy recomputation of the bit
    distances over the unpacked bits: integer (or exact-ratio) distances,
    so the k smallest agree exactly."""
    w = worlds
    pa = arena_from_reference(w["arenas"][("sift", "float32", "l2")], "cpu")
    ix = BinaryQuantIndex(pa, block_rows=BLOCK, rerank=False,
                          bit_metric=bit_metric)
    d, i = ix.search(w["q"]["sift"], w["masks"], K)
    thr = np.median(pa.host_vectors[:pa.n], axis=0)
    xb = pa.host_vectors[:pa.n] > thr
    qb = w["q"]["sift"] > thr
    ok = (pa.host_bits[:pa.n, None, :] & w["masks"][None]).any(axis=2)
    for qi in range(NQ):
        if bit_metric == "hamming":
            dist = (xb != qb[qi]).sum(axis=1).astype(np.float64)
        else:
            inter = (xb & qb[qi]).sum(axis=1)
            union = (xb | qb[qi]).sum(axis=1)
            dist = np.where(inter > 0, 1.0 - inter.astype(np.float32)
                            / np.maximum(union, 1).astype(np.float32), 1.0)
        dist[~ok[:, qi]] = np.inf
        order = np.argsort(dist, kind="stable")[:K]
        np.testing.assert_array_equal(d[qi], dist[order].astype(np.float32))
        np.testing.assert_array_equal(i[qi], order)


@pytest.mark.parametrize("rerank", [True, False], ids=["rerank", "bits"])
@pytest.mark.parametrize("arena", ARENAS, ids="-".join)
def test_binary_index_matches_reference(worlds, arena, rerank):
    """BinaryQuantIndex (median thresholds, rerank multiplier 4) against
    the reference's, over the whole arena and a row subset: the
    reference's distances and ids, storage counted alike."""
    w = worlds
    ra = w["arenas"][arena]
    pa = arena_from_reference(ra, "cpu")
    q = w["q"][arena[0]]
    for rows in (None, np.arange(2, ra.n, 3)):
        want_ix = RefBinary(ra, rows, block_rows=BLOCK, query_batch=16,
                            rerank=rerank)
        got_ix = BinaryQuantIndex(pa, rows, block_rows=BLOCK,
                                  query_batch=16, rerank=rerank)
        want = want_ix.search(q, w["masks"], K)
        got = got_ix.search(q, w["masks"], K)
        if rerank:
            assert_same_topk(got, want)
        else:
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        if rows is not None:
            assert set(got[1][got[1] >= 0]) <= set(rows)
        assert got_ix.storage_bytes() == want_ix.storage_bytes()


def test_binary_jaccard_index_and_zero_thresholds(worlds):
    """The jaccard bit metric without rerank, as the reference's, on the
    median pivot: the reference's zero pivot (thresholds="zero") is not
    carried, and the port's index takes no such option."""
    w = worlds
    ra = w["arenas"][("synthetic", "float32", "ip")]
    kw = dict(block_rows=BLOCK, rerank=False, bit_metric="jaccard")
    with pytest.raises(TypeError):
        BinaryQuantIndex(arena_from_reference(ra, "cpu"), thresholds="zero")
    want = RefBinary(ra, **kw).search(w["q"]["synthetic"], w["masks"], K)
    got = BinaryQuantIndex(arena_from_reference(ra, "cpu"), **kw).search(
        w["q"]["synthetic"], w["masks"], K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
