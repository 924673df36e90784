"""The port's uid wire (Int8FlatIndex.set_user_table, search_deferred with
user_ids) and the result wires on the global path, on a small world built
by the port's own code, run on the CPU (the kernels' plain versions).

The uid wire ships a 2-byte user id a query against a mask table kept on
the device; it must return exactly what the mask-row wire returns (the
reference's tests/test_int8.py:480), with and without admit-dedup, and
fall back to mask rows where the table cannot serve: more than 65,536
users, or a user id outside it. A revoked role must replace the resident
table, or the index would keep serving the old masks."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu_torch import (FrameworkConfig, build_device_arena,
                                         build_searcher)
from vectorsearch_rbac_tpu_torch.bench import make_scenario, serving_config
from vectorsearch_rbac_tpu_torch.index.flat_int8 import Int8FlatIndex

N, NQ, K = 16384, 512, 10


@pytest.fixture(scope="module")
def small():
    corpus, world, workload = make_scenario(n=N, num_queries=NQ, topk=K)
    arena = build_device_arena(corpus, world, device="cpu", block_rows=N,
                               dtype="int8")
    return corpus, world, workload, arena


def _index(arena, **kw):
    return Int8FlatIndex(arena, query_batch=NQ, q_tile=256, block_rows=N,
                         **kw)


def _readable(arena, world, users, ids):
    rows = arena.host_bits[np.maximum(ids, 0)]
    return ((rows & world.user_masks[users][:, None, :]).any(axis=2)
            | (ids < 0)).all()


@pytest.mark.parametrize("few_users", [False, True],
                         ids=["per-query", "admit-dedup"])
def test_uid_wire_ids_equal_mask_wire(small, few_users):
    """The uid wire returns the mask wire's results exactly; with four
    users a pass groups by the table's rows into admit-dedup slots."""
    _, world, workload, arena = small
    rng = np.random.default_rng(7)
    users = (rng.choice(world.num_users, 4, replace=False)[
        rng.permutation(np.arange(NQ) % 4)] if few_users
        else workload.user_ids)
    index = _index(arena, wire="f32")
    want = index.search(workload.vectors, world.user_masks[users], K)
    assert not index._last_uid_wire
    index.set_user_table(world.user_masks)
    got = index.search_deferred(workload.vectors, None, K, user_ids=users)()
    assert index._last_uid_wire and index._last_dedup == few_users
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert _readable(arena, world, users, got[1])


def test_revoked_role_invalidates_table(small):
    """An in-place revocation changes the table's content, so the next
    set_user_table (every searcher pass calls it) replaces the resident
    table: the revoked user no longer reads the rows only that role
    admitted."""
    _, world, workload, arena = small
    masks = world.user_masks.copy()
    searcher = build_searcher("rls", None, world, arena,
                              serving_config(block_rows=N, batch=NQ, topk=K,
                                             wire="f32"))
    index = searcher.partitions[0].index
    uid = int(workload.user_ids[0])
    users = np.full(64, uid)
    q = workload.vectors[:64]
    _, before = searcher.search_batch(q, users, masks, K)
    table = index._user_table
    word = int(np.flatnonzero(masks[uid])[0])
    masks[uid, word] = 0                         # revoke, in place
    _, after = searcher.search_batch(q, users, masks, K)
    assert index._last_uid_wire and index._user_table is not table
    np.testing.assert_array_equal(index._user_table.numpy().view(np.uint32),
                                  masks)
    rows = arena.host_bits[np.maximum(after, 0)]
    assert ((rows & masks[uid]).any(axis=2) | (after < 0)).all()
    assert not np.array_equal(before, after)
    _, again = searcher.search_batch(q, users, masks, K)
    assert index._user_table is not table
    np.testing.assert_array_equal(again, after)


def test_table_beyond_u16_falls_back_to_mask_rows(small):
    """A table of more than 65,536 users is not kept, and a user id outside
    the resident table ships mask rows; both give the mask wire's
    results."""
    _, world, workload, arena = small
    users = workload.user_ids[:64]
    q = workload.vectors[:64]
    index = _index(arena, wire="f32")
    want = index.search(q, world.user_masks[users], K)
    big = np.zeros((65537, world.user_masks.shape[1]), np.uint32)
    big[:world.num_users] = world.user_masks
    index.set_user_table(world.user_masks)
    index.set_user_table(big)
    assert index._user_table is None
    got = index.search_deferred(q, world.user_masks[users], K,
                                user_ids=users)()
    assert not index._last_uid_wire
    index.set_user_table(world.user_masks[:int(users.max())])  # misses one
    got2 = index.search_deferred(q, world.user_masks[users], K,
                                 user_ids=users)()
    assert index._user_table is not None and not index._last_uid_wire
    for a, b, w in zip(got, got2, want):
        np.testing.assert_array_equal(a, w)
        np.testing.assert_array_equal(b, w)
    with pytest.raises(ValueError, match="no mask rows"):
        index.search_deferred(q, None, K, user_ids=users)


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test: the u8 and bf16 wires
    run many small ops, which stall on a contended intra-op pool when
    other test workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("kind", ["flat", "flat_approx"])
def test_default_config_serves_rls(small, kind, one_thread):
    """FrameworkConfig()'s defaults (the u8 wire on the global index) build
    and serve rls, exact or on the int8 scan; the u8 and bf16 wires return
    the ids wire's ids, with distances within each wire's precision of
    the f32 wire's."""
    corpus, world, workload, arena = small
    cfg = FrameworkConfig()
    cfg.index.kind = kind
    assert cfg.search.wire_dist == "u8"
    searcher = build_searcher("rls", corpus, world, arena, cfg)
    args = (workload.vectors, workload.user_ids, world.user_masks, K)
    d, ids = searcher.search_batch(*args)
    assert ids.shape == (NQ, K) and (ids >= 0).mean() > 0.9
    assert _readable(arena, world, workload.user_ids, ids)
    if kind == "flat":
        return
    index = searcher.partitions[0].index
    assert index.wire == "u8" and index._last_uid_wire
    out = {}
    for wire in ("ids", "f32", "bf16", "u8"):
        index.wire = wire
        out[wire] = searcher.search_batch(*args)
    d32, i32 = out["f32"]
    fin = np.isfinite(d32)
    for wire in ("ids", "bf16", "u8"):
        np.testing.assert_array_equal(out[wire][1], i32)
    np.testing.assert_array_equal(out["u8"][0], d)
    assert (np.abs(out["bf16"][0] - d32)[fin] <= np.abs(d32[fin]) * 2**-8).all()
    span = np.where(fin, d32, -np.inf).max(1) - np.where(fin, d32, np.inf).min(1)
    step = np.where(np.isfinite(span), span, 0.0) / 254.0
    err = np.where(fin, np.abs(out["u8"][0] - d32), 0.0)
    assert (err <= 0.5 * step[:, None] * 1.0001 + 1e-3).all()
    # an odd k travels on bf16
    d_odd, i_odd = searcher.search_batch(*args[:3], K - 1)
    np.testing.assert_array_equal(i_odd, i32[:, :K - 1])
    np.testing.assert_array_equal(d_odd, out["bf16"][0][:, :K - 1])


def test_bench_parser_takes_every_wire():
    from vectorsearch_rbac_tpu_torch.bench.__main__ import parse_args

    for wire in ("u8", "bf16", "f32", "ids"):
        assert parse_args(["--wire", wire]).wire == wire
    cfg = serving_config(wire="u8")
    assert cfg.search.wire_dist == "u8"
