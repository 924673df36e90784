"""The port's chunk engine (vectorsearch_rbac_tpu_torch.ops.tiled_scan)
against the reference's XLA version on the same chunks.

Both sides get the same int8 rows, norms and query codes, made from one
numpy seed; the reference reads int8 role one-hots, the port the (N, W)
bitsets they expand. Values must be equal; the ids too, except among equal
values, where they are compared as sets (a stable sort orders ties as
lax.top_k does, so they are not expected to differ either)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import bits_to_onehot8
from vectorsearch_rbac_tpu.ops.tiled_scan import (
    tiled_bucket_topk as ref_tiled_bucket_topk)
from vectorsearch_rbac_tpu_torch.ops.tiled_scan import tiled_bucket_topk

LC, CHUNK, D, R = 6, 256, 128, 128
S, QT, K = 3, 8, 12


@pytest.fixture(scope="module")
def chunks():
    rng = np.random.default_rng(3)
    vec = rng.integers(-60, 60, size=(LC, CHUNK, D)).astype(np.int8)
    vec[:, :, 100:] = 0                          # padded columns
    vec[0] = 0                                   # the dummy chunk
    norm = np.einsum("lcd,lcd->lc", vec.astype(np.int64),
                     vec.astype(np.int64)).astype(np.int32)
    roles = rng.random((LC, CHUNK, R)) < 0.08
    roles[0] = False
    roles[3, 200:] = False                       # pad rows of a short chunk
    vec[1, :40] = vec[1, 40:80]                  # duplicate rows: ties
    norm[1, :40] = norm[1, 40:80]
    rows = np.arange(LC * CHUNK, dtype=np.int32).reshape(LC, CHUNK) + 1000
    rows[0] = -1
    rows[3, 200:] = -1
    queries = rng.integers(-60, 60, size=(S * QT, D)).astype(np.int8)
    queries[:, 100:] = 0
    qnorms = np.einsum("qd,qd->q", queries.astype(np.int64),
                       queries.astype(np.int64)).astype(np.int32)
    masks = rng.random((S * QT, R)) < 0.1
    masks[5] = False                              # a query that sees nothing
    cids = np.array([[1, 2, 3], [4, 5, 0], [3, 0, 0]], dtype=np.int32)
    pack = lambda b: np.packbits(b, axis=-1, bitorder="little").view(
        np.uint32)
    return dict(vec=vec, norm=norm, rbits=pack(roles), rows=rows,
                queries=queries, qnorms=qnorms, qbits=pack(masks),
                cids=cids)


def _ref(c, group):
    onehot = lambda b: bits_to_onehot8(b.reshape(-1, b.shape[-1]), R, R)
    d, i = ref_tiled_bucket_topk(
        jnp.asarray(c["queries"]), jnp.asarray(c["qnorms"]),
        jnp.asarray(onehot(c["qbits"])), jnp.asarray(c["cids"]),
        jnp.asarray(c["vec"]), jnp.asarray(c["norm"]),
        jnp.asarray(onehot(c["rbits"]).reshape(LC, CHUNK, R)),
        jnp.asarray(c["rows"]), jnp.float32(1.0), K, c["cids"].shape[1], QT,
        scan_group=group, score_shift=0)
    return np.asarray(d), np.asarray(i)


def _port(c, group):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    d, i = tiled_bucket_topk(
        t(c["queries"]), t(c["qnorms"]), t(c["qbits"].view(np.int32)),
        t(c["cids"].astype(np.int64)), t(c["vec"]), t(c["norm"]),
        t(c["rbits"].view(np.int32)), t(c["rows"]), 1.0, K,
        c["cids"].shape[1], QT, scan_group=group)
    return d.numpy(), i.numpy()


@pytest.mark.parametrize("group", [0, 8, 32])
def test_tiled_bucket_topk_matches_reference(chunks, group):
    want_d, want_i = _ref(chunks, group)
    got_d, got_i = _port(chunks, group)
    assert got_d.shape == got_i.shape == (S * QT, K)
    np.testing.assert_array_equal(got_d, want_d)
    for q in range(S * QT):
        for v in np.unique(want_d[q]):
            assert (set(got_i[q][got_d[q] == v])
                    == set(want_i[q][want_d[q] == v])), (q, v)
    # empty slots: the query without roles, and the padding of slot 2
    assert (got_i[5] == -1).all() and np.isinf(got_d[5]).all()
    assert (got_i >= 0).sum() > 0.8 * got_i.size


def test_grouped_epilogue_keeps_one_row_a_group(chunks):
    """At group g every returned row is the minimum of its g-row group:
    no two results of a query share a group."""
    _, ids = _port(chunks, 32)
    for q in range(S * QT):
        got = ids[q][ids[q] >= 0] - 1000
        assert len(set(got // 32)) == len(got)


@pytest.mark.parametrize("group", [0, 8])
def test_chunk_engine_exact_past_768_columns(group):
    """d_pad 1024 with every product at 127 * 127 on 1000 columns: a dot of
    16,129,000, past float32's exact integers, so one float32 sum of the
    1024 products would round; the column slices keep it exact, equal to
    the reference's int32 dots."""
    d, lc, chunk, s, qt, k = 1024, 3, 128, 2, 4, 6
    rng = np.random.default_rng(8)
    vec = rng.integers(-128, 128, size=(lc, chunk, d)).astype(np.int8)
    vec[1, :, :1000] = 127                        # the extreme rows
    vec[0] = 0                                    # the dummy chunk
    norm = np.einsum("lcd,lcd->lc", vec.astype(np.int64),
                     vec.astype(np.int64)).astype(np.int32)
    roles = rng.random((lc, chunk, R)) < 0.3
    roles[0] = False
    rows = np.arange(lc * chunk, dtype=np.int32).reshape(lc, chunk)
    rows[0] = -1
    queries = rng.integers(-128, 128, size=(s * qt, d)).astype(np.int8)
    queries[:, :1000] = 127
    qnorms = np.einsum("qd,qd->q", queries.astype(np.int64),
                       queries.astype(np.int64)).astype(np.int32)
    masks = rng.random((s * qt, R)) < 0.3
    cids = np.array([[1, 2], [2, 0]], dtype=np.int32)
    pack = lambda b: np.packbits(b, axis=-1, bitorder="little").view(
        np.uint32)
    c = dict(vec=vec, norm=norm, rbits=pack(roles), rows=rows,
             queries=queries, qnorms=qnorms, qbits=pack(masks), cids=cids)
    onehot = lambda b: bits_to_onehot8(b.reshape(-1, b.shape[-1]), R, R)
    want_d, want_i = ref_tiled_bucket_topk(
        jnp.asarray(queries), jnp.asarray(qnorms),
        jnp.asarray(onehot(c["qbits"])), jnp.asarray(cids), jnp.asarray(vec),
        jnp.asarray(norm), jnp.asarray(onehot(c["rbits"]).reshape(
            lc, chunk, R)), jnp.asarray(rows), jnp.float32(1.0), k,
        cids.shape[1], qt, scan_group=group, score_shift=0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    got_d, got_i = tiled_bucket_topk(
        t(queries), t(qnorms), t(c["qbits"].view(np.int32)),
        t(cids.astype(np.int64)), t(vec), t(norm),
        t(c["rbits"].view(np.int32)), t(rows), 1.0, k, cids.shape[1], qt,
        scan_group=group)
    want_d, want_i = np.asarray(want_d), np.asarray(want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    assert np.isin(got_i.numpy(), rows[1]).any()  # the extreme rows rank


@pytest.mark.parametrize("scan_group", [0, 8])
def test_role_at_d1024_matches_reference(scan_group):
    """ROLE over an int8 l2 arena of d_pad 1024 through the chunk engine
    (its exact and grouped epilogues): the distances and the ids equal the
    reference's on the same arena (ids as sets among equal distances)."""
    from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
    from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
    from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
    from vectorsearch_rbac_tpu.rbac.generators import (
        TreeRBACGenerator as RefTreeGenerator)
    from vectorsearch_rbac_tpu.utils.config import (
        FrameworkConfig as RefFrameworkConfig)

    import vectorsearch_rbac_tpu_torch as port
    from vectorsearch_rbac_tpu_torch import (arena_from_reference,
                                             build_searcher)
    from vectorsearch_rbac_tpu_torch.partition import TiledSearcher

    world_kw = dict(num_users=60, num_roles=12, num_docs=60, h=3, b0=2, b1=2,
                    seed=5)
    corpus_kw = dict(num_vectors=600, dim=1024, blocks_per_doc=10, seed=4)
    rw = RefTreeGenerator(**world_kw).generate()
    rc, _ = ref_corpus(**corpus_kw)
    ra = ref_arena(rc, rw, block_rows=256, dtype="int8")
    mw = port.TreeRBACGenerator(**world_kw).generate()
    mc, _ = port.sift_like_corpus(**corpus_kw)
    ma = arena_from_reference(ra, "cpu")
    assert ma.quant.d_pad == 1024
    cfgs = []
    for cfg in (RefFrameworkConfig(), port.FrameworkConfig()):
        cfg.index.kind = "flat_approx"
        cfg.search.scan_group = scan_group
        cfg.search.batch_size = 256
        cfgs.append(cfg)
    rng = np.random.default_rng(9)
    qf = rng.integers(0, 256, (24, 1024)).astype(np.float32)
    users = rng.integers(0, rw.num_users, 24)
    wd, wi = ref_searcher("role", rc, rw, ra, cfgs[0]).search_batch(
        qf, users, rw.user_masks, 8)
    searcher = build_searcher("role", mc, mw, ma, cfgs[1])
    assert isinstance(searcher, TiledSearcher)
    gd, gi = searcher.search_batch(qf, users, mw.user_masks, 8)
    wd, wi = np.asarray(wd), np.asarray(wi)
    np.testing.assert_array_equal(np.asarray(gd, np.float64),
                                  np.asarray(wd, np.float64))
    for q in range(len(gi)):
        for v in np.unique(wd[q]):
            assert set(gi[q][gd[q] == v]) == set(wi[q][wd[q] == v]), (q, v)
    assert (gi >= 0).sum() > 0.5 * gi.size
