"""The port's IVF path against the JAX reference on the CPU: the device
k-means, the probed scan (`probed_topk`, the IVF index's and the
PackedSearcher's engine, and `ivf_search_fn`), `IVFIndex` and the
IVF-assisted kNN of the HNSW "tpu" builder.

Inputs come from numpy seeds and go through both packages (the reference
in plain JAX, as its own tests run it). Distances are compared to rtol
1e-5 of the largest finite distance of the case (summation order differs:
the port sums float32 products in another order); ids are equal except
among distances within that tolerance, which are compared as sets (the
ROADMAP tie rule)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.index import hnsw as ref_hnsw
from vectorsearch_rbac_tpu.index.ivf import IVFIndex as RefIVFIndex
from vectorsearch_rbac_tpu.ops import ivf_scan as ref_scan
from vectorsearch_rbac_tpu.ops import kmeans as ref_kmeans
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu_torch import arena_from_reference
from vectorsearch_rbac_tpu_torch.index import hnsw as hnsw_mod
from vectorsearch_rbac_tpu_torch.index import ivf as ivf_mod
from vectorsearch_rbac_tpu_torch.index.flat import FlatIndex
from vectorsearch_rbac_tpu_torch.index.ivf import IVFIndex, ivf_from_reference
from vectorsearch_rbac_tpu_torch.ops import ivf_scan, kmeans

RTOL = 1e-5


def assert_same_topk(got, want, rtol=RTOL):
    """Equal empty slots; finite distances within rtol of the case's
    largest; per query, the ids strictly inside the k-th distance (less
    the tolerance) equal as sets, so that rows tied within the tolerance
    may come in another order or swap at the boundary."""
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    assert gd.shape == wd.shape and gi.shape == wi.shape
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_array_equal(gi < 0, wi < 0)
    fin = np.isfinite(wd)
    if not fin.any():
        return
    tol = rtol * max(1.0, float(np.abs(wd[fin]).max()))
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=0, atol=tol)
    for q in range(len(wd)):
        ok = np.isfinite(wd[q])
        if not ok.any():
            continue
        last = wd[q][ok].max()
        inner_g = set(gi[q][np.isfinite(gd[q]) & (gd[q] < last - tol)])
        inner_w = set(wi[q][ok & (wd[q] < last - tol)])
        assert inner_g == inner_w, q


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _bits(a):
    return _t(np.ascontiguousarray(a, np.uint32).view(np.int32))


# ---- k-means


def test_kmeans_matches_reference():
    """Well-separated clusters from one kmeans_init draw: the same initial
    centroids, equal assignments (fit, single and blocked), centroids to
    rtol 1e-4."""
    rng = np.random.default_rng(0)
    centers = rng.normal(0, 40, (4, 32)).astype(np.float32)
    label = rng.integers(0, 4, 3000)
    x = (centers[label] + rng.normal(0, 1, (3000, 32))).astype(np.float32)
    # the first seed whose draw starts one centroid in each cluster (two in
    # one cluster would split it, and the split's boundary is where float
    # rounding differences grow over the iterations)
    seed = next(s for s in range(1000) if len(set(label[
        np.random.default_rng(s).choice(3000, 4, replace=False)])) == 4)
    init = kmeans.kmeans_init(x, 4, seed=seed)
    np.testing.assert_array_equal(init,
                                  ref_kmeans.kmeans_init(x, 4, seed=seed))
    # fewer rows than clusters: the jittered copies come from the same draws
    np.testing.assert_array_equal(kmeans.kmeans_init(x[:5], 8, seed=1),
                                  ref_kmeans.kmeans_init(x[:5], 8, seed=1))
    want_c, want_a = ref_kmeans.kmeans_fit(jnp.asarray(x), jnp.asarray(init),
                                           iters=10)
    got_c, got_a = kmeans.kmeans_fit(_t(x), _t(init), iters=10)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4,
                               atol=1e-4)
    probe = (centers[rng.integers(0, 4, 500)]
             + rng.normal(0, 1, (500, 32))).astype(np.float32)
    want = np.asarray(ref_kmeans.assign_clusters(jnp.asarray(probe), want_c))
    np.testing.assert_array_equal(
        kmeans.assign_clusters(_t(probe), got_c).numpy(), want)
    np.testing.assert_array_equal(
        kmeans.assign_clusters_blocked(probe, got_c, block=128), want)
    np.testing.assert_array_equal(
        ref_kmeans.assign_clusters_blocked(probe, want_c, block=128), want)


def test_kmeans_keeps_empty_clusters_and_weights():
    """An init centroid no row is nearest keeps its place, with one such
    centroid or two. (The row weights went with the sharded step, ROADMAP
    queue 1 item 18; no path of the port weights rows.)"""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (400, 8)).astype(np.float32)
    far = np.full((2, 8), 1e3, np.float32)
    far[1] *= -1
    for init in (np.concatenate([x[:3], far[:1]]),
                 np.concatenate([x[:3], far])):
        want_c, want_a = ref_kmeans.kmeans_fit(
            jnp.asarray(x), jnp.asarray(init), iters=4)
        got_c, got_a = kmeans.kmeans_fit(_t(x), _t(init), iters=4)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got_c[3:].numpy(), init[3:])


# ---- the probed scan


def _lists(seed, nlist=12, l_pad=40, d=32, w=2):
    """Random padded lists: rows with -1 ids and zero bits pad each list's
    tail, one list is empty."""
    rng = np.random.default_rng(seed)
    vec = rng.normal(0, 1, (nlist, l_pad, d)).astype(np.float32)
    fill = rng.integers(0, l_pad + 1, nlist)
    fill[0] = 0
    live = np.arange(l_pad)[None, :] < fill[:, None]
    bits = np.where(live[..., None],
                    rng.integers(0, 1 << 4, (nlist, l_pad, w)), 0
                    ).astype(np.uint32)
    rows = np.where(live, rng.permutation(nlist * l_pad).reshape(
        nlist, l_pad), -1).astype(np.int32)
    vec[~live] = 0
    return vec, bits, rows


def _norms(vec, dtype):
    v = vec if dtype == "float32" else np.asarray(
        jnp.asarray(vec).astype(jnp.bfloat16).astype(jnp.float32))
    return np.einsum("pld,pld->pl", v, v).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_probed_scan_matches_reference(metric, dtype):
    """probed_topk with two probes a query (probe ids as a tensor) and with
    one (the PackedSearcher's slot, as a host array), and ivf_search_fn
    (routing by the centroids), over float32 and bfloat16 lists, for
    every metric, with queries that admit nothing and lists shorter than
    k (empty slots)."""
    vec, bits, rows = _lists(7)
    norms = _norms(vec, dtype)
    rng = np.random.default_rng(8)
    nq, k = 24, 30
    q = rng.normal(0, 1, (nq, vec.shape[2])).astype(np.float32)
    masks = rng.integers(0, 1 << 4, (nq, bits.shape[2])).astype(np.uint32)
    masks[:3] = 0
    probes = np.stack([rng.choice(vec.shape[0], 2, replace=False)
                       for _ in range(nq)]).astype(np.int32)
    cents = rng.normal(0, 1, (vec.shape[0], vec.shape[2])).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    ref_ops = (jnp.asarray(vec).astype(jdt), jnp.asarray(norms),
               jnp.asarray(bits), jnp.asarray(rows))
    ops = (_t(vec, tdt), _t(norms), _bits(bits), _t(rows))
    want = ref_scan.probed_topk(jnp.asarray(q), jnp.asarray(probes),
                                *ref_ops, jnp.asarray(masks), k,
                                metric=metric)
    got = ivf_scan.probed_topk(_t(q), _t(probes), *ops, _bits(masks), k,
                               metric=metric)
    assert_same_topk(got, want)
    assert (np.asarray(got[1]) < 0).any() and (np.asarray(got[1]) >= 0).any()
    want = ref_scan.ivf_search_fn(jnp.asarray(q), jnp.asarray(cents),
                                  *ref_ops, jnp.asarray(masks), k, 3,
                                  metric=metric)
    got = ivf_scan.ivf_search_fn(_t(q), _t(cents), *ops, _bits(masks), k, 3,
                                 metric=metric)
    assert_same_topk(got, want)
    slots = probes[:, 0]
    want = ref_scan.probed_topk(jnp.asarray(q), jnp.asarray(slots[:, None]),
                                *ref_ops, jnp.asarray(masks), k,
                                metric=metric)
    got = ivf_scan.probed_topk(_t(q), slots[:, None], *ops, _bits(masks), k,
                               metric=metric)
    assert_same_topk(got, want)


def test_scan_chunks_do_not_change_results(monkeypatch):
    """probed_topk's row chunks, units and batches (a byte cap of a few
    rows: each 2,048-row list is scored in two chunks of 1,024 and each
    pair is a unit) give the uncapped results, with one probe a query and
    with two (the products' shapes change, so the summation order may: to
    the tie rule)."""
    vec, bits, rows = _lists(3, nlist=6, l_pad=2048)
    norms = _norms(vec, "float32")
    rng = np.random.default_rng(4)
    nq, k = 50, 10
    q = rng.normal(0, 1, (nq, vec.shape[2])).astype(np.float32)
    masks = rng.integers(1, 1 << 4, (nq, 2)).astype(np.uint32)
    slots = rng.integers(0, 6, nq)
    slots[:20] = 2     # one slot with many queries: cut into units
    ops = (_t(vec), _t(norms), _bits(bits), _t(rows))
    full = ivf_scan.probed_topk(_t(q), slots[:, None], *ops, _bits(masks),
                                k)
    fullp = ivf_scan.probed_topk(_t(q), _t(np.stack([slots, slots[::-1]], 1)),
                                 *ops, _bits(masks), k)
    monkeypatch.setattr(ivf_scan, "_GATHER_BYTES", 1024 * 32 * 8 * 4)
    cut = ivf_scan.probed_topk(_t(q), slots[:, None], *ops, _bits(masks), k)
    cutp = ivf_scan.probed_topk(_t(q), _t(np.stack([slots, slots[::-1]], 1)),
                                *ops, _bits(masks), k)
    assert_same_topk(cut, full)
    assert_same_topk(cutp, fullp)


# ---- IVFIndex


WORLD = dict(num_users=60, num_roles=12, num_docs=150, h=3, b0=2, b1=2,
             seed=2)
CORPUS = dict(num_vectors=3000, dim=32, blocks_per_doc=20, seed=6)


@pytest.fixture(scope="module")
def ivf_setup():
    world = RefTreeGenerator(**WORLD).generate()
    corpus, _ = ref_corpus(**CORPUS)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, corpus.n, 40)
    q = np.clip(corpus.vectors[rows] + np.round(rng.normal(0, 10, (
        40, corpus.dim))), 0, 255).astype(np.float32)
    users = rng.integers(0, world.num_users, 40)
    return dict(world=world, corpus=corpus, q=q,
                masks=world.user_masks[users])


@pytest.mark.parametrize("dtype,metric", [("int8", "l2"),
                                          ("float32", "cosine"),
                                          ("int8", "ip")])
def test_ivf_index_from_reference(ivf_setup, dtype, metric):
    """The reference's IVFIndex (nlist 24, nprobe 4) carried over through
    ivf_from_reference: searches at nprobe 4, with the iterative scan, and
    at nprobe 8 equal the reference's; the lists gathered from the port's
    arena along the reference's row ids equal the reference's lists; the
    iterative scan leaves no query short that a full probe fills."""
    s = ivf_setup
    ra = ref_arena(s["corpus"], s["world"], block_rows=512, dtype=dtype,
                   metric=metric)
    ref = RefIVFIndex(ra, nlist=24, nprobe=4, kmeans_iters=5,
                      query_batch=16)
    mine = ivf_from_reference(ref, "cpu")
    pa = arena_from_reference(ra, "cpu")
    # the port's build gathers the lists on the device along the row map:
    # along the reference's row ids that gives the reference's lists
    gathered = ivf_from_reference(ref, "cpu")
    gathered._set_lists(_t(np.array(ref._inv_rows)), pa)
    np.testing.assert_array_equal(
        gathered._inv_vectors.float().numpy(),
        np.asarray(ref._inv_vectors).astype(np.float32))
    np.testing.assert_array_equal(gathered._inv_norms.numpy(),
                                  np.asarray(ref._inv_norms))
    np.testing.assert_array_equal(
        gathered._inv_bits.numpy().view(np.uint32), np.asarray(ref._inv_bits))
    assert mine.storage_bytes() == ref.storage_bytes()
    k = 150
    for kw in ({}, dict(iterative=True), dict(nprobe=8),
               dict(iterative=True, max_probes=8)):
        want = ref.search(s["q"], s["masks"], k, **kw)
        for ix in (mine, gathered):
            assert_same_topk(ix.search(s["q"], s["masks"], k, **kw), want)
    short = (ref.search(s["q"], s["masks"], k)[1] < 0).any(1)
    full = mine.search(s["q"], s["masks"], k, nprobe=24)[1]
    it = mine.search(s["q"], s["masks"], k, iterative=True)[1]
    assert short.any()
    np.testing.assert_array_equal((it < 0).any(1), (full < 0).any(1))


def test_ivf_index_full_probe_is_exact(ivf_setup, monkeypatch):
    """The port's own build (k-means, assignment, spill and the device
    gather) at full probe returns FlatIndex's exact results; the lists
    hold every row once. l_pad at the median list size makes half the
    lists spill. Insert and delete serve: 3 rows inserted (a second copy
    of each) and then deleted (every copy) leave the reference's lists,
    L_pad and row count when the reference's insert and delete run on the
    same lists."""
    s = ivf_setup
    ra = ref_arena(s["corpus"], s["world"], block_rows=512, dtype="float32")
    pa = arena_from_reference(ra, "cpu")
    monkeypatch.setattr(ivf_mod, "PAD_QUANTILE", 0.5)
    ix = IVFIndex(pa, nlist=16, nprobe=4, kmeans_iters=4, query_batch=16)
    r = ix._inv_rows.numpy()
    assert np.array_equal(np.sort(r[r >= 0]), np.arange(pa.n))
    assert ix.l_pad * ix.nlist >= pa.n and 0 < ix.fill <= 1
    want = FlatIndex(pa, block_rows=512).search(s["q"], s["masks"], 20)
    got = ix.search(s["q"], s["masks"], 20, nprobe=16)
    assert_same_topk(got, want)
    ref = RefIVFIndex.__new__(RefIVFIndex)
    ref.nlist, ref.l_pad, ref.n_rows = ix.nlist, ix.l_pad, ix.n_rows
    # copies: jnp.asarray may alias a suitably aligned host buffer, and
    # the port's insert writes its lists in place
    ref._centroids = jnp.array(ix._centroids.numpy())
    ref._inv_vectors = jnp.array(ix._inv_vectors.numpy())
    ref._inv_norms = jnp.array(ix._inv_norms.numpy())
    ref._inv_bits = jnp.array(ix._inv_bits.numpy().view(np.uint32))
    ref._inv_rows = jnp.array(ix._inv_rows.numpy())
    for step in (lambda x, a: x.insert_rows(a, np.arange(3)),
                 lambda x, a: x.delete_rows(a, np.arange(3))):
        assert step(ix, pa) == step(ref, ra)
        np.testing.assert_array_equal(ix._inv_rows.numpy(),
                                      np.asarray(ref._inv_rows))
        assert (ix.l_pad, ix.n_rows) == (ref.l_pad, ref.n_rows)
    r = ix._inv_rows.numpy()
    assert np.array_equal(np.sort(r[r >= 0]), np.arange(3, pa.n))
    assert ix.n_rows == pa.n - 3


def test_bucket_rows_spill_matches_reference_rule():
    """Lists at a small l_pad: the first l_pad rows of a list in row order
    stay, the rest spill in row order to their nearest centroid with
    space, and a row finding every list full grows l_pad; the reference's
    loop, written out, gives the same lists."""
    from vectorsearch_rbac_tpu_torch.index.ivf import bucket_rows

    rng = np.random.default_rng(9)
    vec = rng.normal(0, 1, (300, 8)).astype(np.float32)
    cent = rng.normal(0, 1, (5, 8)).astype(np.float32)
    assign = np.argmin(((vec[:, None] - cent[None]) ** 2).sum(2), 1)
    for l_pad in (8, 56, 64):
        lists = [[] for _ in range(5)]
        spill, lp = [], l_pad
        for i, c in enumerate(assign.tolist()):
            (lists[c] if len(lists[c]) < lp else spill).append(i)
        if spill:
            sv = vec[spill]
            cd = (np.einsum("nd,nd->n", sv, sv)[:, None] - 2.0 * sv @ cent.T
                  + np.einsum("cd,cd->c", cent, cent)[None, :])
            order = np.argsort(cd, axis=1)
            for j, i in enumerate(spill):
                for c in order[j]:
                    if len(lists[int(c)]) < lp:
                        lists[int(c)].append(i)
                        break
                else:
                    lp = int(lp * 1.25 + 8) // 8 * 8
                    lists[int(order[j, 0])].append(i)
        got, got_lp = bucket_rows(assign, vec, cent, l_pad)
        assert got_lp == lp
        assert [g.tolist() for g in got] == lists


# ---- the IVF-assisted kNN


def _knn_dists(vec, ids):
    """The probed scan's distances of each row to its listed rows
    (bfloat16 rows and query, float32 norms), in float64."""
    vb = np.asarray(jnp.asarray(vec).astype(jnp.bfloat16).astype(
        jnp.float32)).astype(np.float64)
    nrm = np.einsum("nd,nd->n", vec, vec).astype(np.float64)
    return nrm[ids] - 2.0 * np.einsum("nd,nkd->nk", vb, vb[ids]) + \
        nrm[:, None]


def test_ivf_knn_graph_matches_reference():
    """_device_knn_graph_ivf on the reference's centroids (the same sample,
    init and 8 Lloyd iterations, in the reference's k-means) returns the
    reference's kNN lists; its own k-means returns full lists too: every
    row's k + 1 ids valid and distinct, no row lost."""
    rng = np.random.default_rng(11)
    vec = rng.normal(0, 1, (3000, 32)).astype(np.float32)
    k = 8
    want = ref_hnsw._device_knn_graph_ivf(vec, k=k, seed=0)
    nlist = max(16, int(np.sqrt(len(vec))))
    cents, _ = ref_kmeans.kmeans_fit(
        jnp.asarray(vec), jnp.asarray(ref_kmeans.kmeans_init(vec, nlist, 0)),
        iters=8)
    got = hnsw_mod._device_knn_graph_ivf(vec, k, "cpu", seed=0,
                                         centroids=np.asarray(cents))
    assert_same_topk((_knn_dists(vec, got), got),
                     (_knn_dists(vec, want), want))
    own = hnsw_mod._device_knn_graph_ivf(vec, k, "cpu", seed=0)
    assert own.shape == (len(vec), k + 1) and (own >= 0).all()
    assert all(len(set(r)) == k + 1 for r in own)
    assert (own[:, 0] == np.arange(len(vec))).mean() > 0.99


def test_ivf_knn_graph_coverage_gaps_are_the_references():
    """Rows that no kNN list holds are the reference's own: on a corpus with
    a hot spot of 400 near-duplicate rows (their bfloat16 distances tie),
    the reference's lists leave rows out of every list, and the port's
    lists on the reference's centroids leave out the same rows, and miss
    the same rows in their own lists."""
    rng = np.random.default_rng(11)
    vec = rng.normal(0, 1, (3000, 32)).astype(np.float32)
    hot = rng.choice(len(vec), 400, replace=False)
    vec[hot] = vec[hot[0]] + rng.normal(0, 0.01, (400, 32)).astype(
        np.float32)
    k = 8
    want = ref_hnsw._device_knn_graph_ivf(vec, k=k, seed=0)
    nlist = max(16, int(np.sqrt(len(vec))))
    cents, _ = ref_kmeans.kmeans_fit(
        jnp.asarray(vec), jnp.asarray(ref_kmeans.kmeans_init(vec, nlist, 0)),
        iters=8)
    got = hnsw_mod._device_knn_graph_ivf(vec, k, "cpu", seed=0,
                                         centroids=np.asarray(cents))
    rows = np.arange(len(vec))
    gaps = np.setdiff1d(rows, want)
    assert len(gaps) > 0
    np.testing.assert_array_equal(np.setdiff1d(rows, got), gaps)
    np.testing.assert_array_equal((got == rows[:, None]).any(1),
                                  (want == rows[:, None]).any(1))
