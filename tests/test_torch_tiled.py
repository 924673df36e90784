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
