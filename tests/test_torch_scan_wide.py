"""The port's wide int8 scan (K2, d_pad > 256) and the ip decode against
the JAX kernel they replace, int8_masked_topk_wide, run in Pallas
interpret mode on the CPU.

On the CPU the port runs the kernel's plain PyTorch version, so these
tests hold that version bit-identical to the TPU kernel's packed group
minima at d_pad 384 (score shift 2) and 768 (shift 3), for both kernel
metrics and the smallest and largest group, and its admit-dedup slot form
in both layouts. The JAX kernel sweeps d in
chunks of 128 or 256 here, so its accumulation across d-chunks is what
the port's single sum is held to. Both sides get the same role bitsets:
the port ANDs the (N, W) words, the JAX kernel multiplies their
bits_to_onehot8 expansion.

int8_masked_topk_wide always decodes its minima, where the narrow entry
returns them raw for merge="none"; the raw_minima fixture makes its merge
pass them through for merge="none" (and only for it), so the packed
output comes from the reference's own launch code."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import bits_to_onehot8, score_shift_for
from vectorsearch_rbac_tpu.ops import pallas_scan_int8
from vectorsearch_rbac_tpu.ops.pallas_scan_int8 import (
    int8_masked_topk_wide as jax_wide)
from vectorsearch_rbac_tpu_torch.ops.scan_int8 import (
    MASKED_I32, int8_group_minima, int8_group_minima_wide_plain,
    int8_masked_topk, slot_of_query)

N, R, Q, K = 1024, 128, 16, 10


@pytest.fixture
def raw_minima(monkeypatch):
    merge = pallas_scan_int8._merge_group_minima

    def passthrough(packed, *args, **kwargs):
        if args[4] == "none":          # (qn, inv, k, group, merge, ...)
            return packed, packed
        return merge(packed, *args, **kwargs)

    monkeypatch.setattr(pallas_scan_int8, "_merge_group_minima", passthrough)


def _prob(d_pad, seed=0):
    rng = np.random.default_rng(seed)
    vecs = rng.integers(-127, 128, size=(N, d_pad)).astype(np.int8)
    norms = np.einsum("nd,nd->n", vecs.astype(np.int64),
                      vecs.astype(np.int64)).astype(np.int32)
    roles = rng.random((N, R)) < 0.05
    roles[:, 0] |= rng.random(N) < 0.3            # a popular role
    queries = rng.integers(-127, 128, size=(Q, d_pad)).astype(np.int8)
    qnorms = np.einsum("qd,qd->q", queries.astype(np.int64),
                       queries.astype(np.int64)).astype(np.int32)
    masks = rng.random((Q, R)) < 0.1
    masks[:, 0] = True
    masks[3] = False                              # one query sees nothing
    pack = lambda b: np.packbits(b, axis=1, bitorder="little").view(np.uint32)
    # per-query decode operands of the ip path (quantize_queries_ip's shape)
    inv = rng.uniform(1e-4, 1e-3, size=Q).astype(np.float32)
    bias = rng.uniform(0.5, 1.5, size=Q).astype(np.float32)
    return vecs, norms, pack(roles), queries, qnorms, pack(masks), inv, bias


def _jax(prob, group, merge, metric, shift):
    vecs, norms, rbits, queries, qnorms, qbits, inv, bias = prob
    ip = metric == "ip"
    return jax_wide(
        jnp.asarray(queries), jnp.asarray(qnorms), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(bits_to_onehot8(rbits, R, R)),
        jnp.asarray(bits_to_onehot8(qbits, R, R)),
        jnp.asarray(inv) if ip else jnp.float32(1e-3), K, q_tile=Q,
        block_rows=512, group=group, d_chunk=256, merge=merge,
        interpret=True, metric=metric,
        query_bias=jnp.asarray(bias) if ip else None, score_shift=shift)


def _torch(prob):
    vecs, norms, rbits, queries, qnorms, qbits, inv, bias = prob
    t = torch.from_numpy
    return (t(queries), t(qnorms), t(vecs), t(norms), t(rbits.view(np.int32)),
            t(qbits.view(np.int32)), t(inv), t(bias))


@pytest.mark.parametrize("d_pad", [384, 768])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("group", [8, 128])
def test_wide_minima_bit_identical(raw_minima, d_pad, metric, group):
    shift = score_shift_for(d_pad, 127)
    assert shift == {384: 2, 768: 3}[d_pad]
    prob = _prob(d_pad)
    want, _ = _jax(prob, group, "none", metric, shift)
    q8, _, x8, norms, rbits, qbits, _, _ = _torch(prob)
    got = int8_group_minima(q8, x8, norms, rbits, qbits, group=group,
                            metric=metric, score_shift=shift)
    assert got.shape == (N // group, Q) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[:, 3] == MASKED_I32).all()


@pytest.mark.parametrize("d_pad,metric", [(384, "ip"), (768, "ip"),
                                          (768, "l2")])
def test_wide_decode_matches_exact_merge(d_pad, metric):
    """(dists, idx) after the decode equal the JAX kernel's merge="exact"
    output with per-query inv and query_bias (ip) or one inv (l2): ids
    exactly; dists to rtol 1e-6, since XLA may fuse the decode's multiply
    and add where torch rounds between them (one float32 rounding)."""
    shift = score_shift_for(d_pad, 127)
    prob = _prob(d_pad, seed=1)
    want_d, want_i = _jax(prob, 8, "exact", metric, shift)
    q8, qn, x8, norms, rbits, qbits, inv, bias = _torch(prob)
    ip = metric == "ip"
    got_d, got_i = int8_masked_topk(
        q8, None if ip else qn, x8, norms, rbits, qbits,
        inv if ip else float(np.float32(1e-3)), K, group=8, merge="exact",
        metric=metric, score_shift=shift, query_bias=bias if ip else None)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)
    assert np.isinf(got_d.numpy()[3]).all() and (got_i.numpy()[3] == -1).all()


def _minima_int64(q8, x8, norms, rbits, qbits, group, shift):
    """Packed l2 group minima from an int64 numpy product."""
    dots = x8.astype(np.int64) @ q8.astype(np.int64).T          # (N, Q)
    score = (norms.astype(np.int64)[:, None] - 2 * dots) >> shift
    admit = (rbits[:, None, :] & qbits[None, :, :]).any(axis=2)
    lane = (np.arange(len(x8)) % group)[:, None]
    packed = np.where(admit, score * 128 + lane, MASKED_I32)
    return packed.reshape(-1, group, len(q8)).min(axis=1)


def test_plain_version_exact_beyond_768_columns():
    """At d_pad 1536 one float32 matmul no longer holds the dots exactly
    (they pass 2^24); the plain version sums int32 partials of at most 768
    columns and stays bit-identical to an int64 product."""
    rng = np.random.default_rng(5)
    d_pad, n, nq, group = 1536, 256, 8, 8
    x8 = rng.integers(100, 128, size=(n, d_pad)).astype(np.int8)
    q8 = rng.integers(100, 128, size=(nq, d_pad)).astype(np.int8)
    x8[::2] *= -1
    norms = (x8.astype(np.int64) ** 2).sum(axis=1).astype(np.int32)
    rbits = rng.integers(0, 2**31, size=(n, 2)).astype(np.int32)
    qbits = rng.integers(0, 2**31, size=(nq, 2)).astype(np.int32)
    shift = score_shift_for(d_pad, 127)
    dots = x8.astype(np.int64) @ q8.astype(np.int64).T
    assert np.abs(dots).max() >= 2**24
    one_matmul = (torch.from_numpy(x8).float() @ torch.from_numpy(q8).float().T)
    assert not np.array_equal(one_matmul.numpy().astype(np.int64), dots)
    t = torch.from_numpy
    got = int8_group_minima_wide_plain(t(q8), t(x8), t(norms), t(rbits),
                                       t(qbits), group=group, metric="l2",
                                       score_shift=shift)
    np.testing.assert_array_equal(
        got.numpy(), _minima_int64(q8, x8, norms, rbits, qbits, group, shift))


# ---- the wide scan's admit-dedup slot form (mask_sb), both slot layouts,
# at tests/test_int8.py:679's geometry: 512 rows x 384, 64 queries, q_tile
# 32, slots of 4, 5 distinct masks

SN, SD, SQ, SQ_TILE, SSB = 512, 384, 64, 32, 4


@pytest.fixture(scope="module")
def wide_slot_prob():
    rng = np.random.default_rng(29)
    vecs = rng.integers(-127, 128, size=(SN, SD)).astype(np.int8)
    norms = np.einsum("nd,nd->n", vecs.astype(np.int64),
                      vecs.astype(np.int64)).astype(np.int32)
    roles = rng.random((SN, R)) < 0.05
    roles[:, 0] |= rng.random(SN) < 0.3
    queries = rng.integers(-127, 128, size=(SQ, SD)).astype(np.int8)
    pool = rng.random((5, R)) < 0.1
    pool[:4, 0] = True
    pool[4] = False                               # one mask sees nothing
    pack = lambda b: np.packbits(b, axis=1, bitorder="little").view(np.uint32)
    slots = pack(pool)[np.arange(SQ // SSB) % 5]
    return vecs, norms, pack(roles), queries, slots


def _jax_wide_minima(vecs, norms, rbits, queries, masks, metric, shift,
                     **slot):
    want, _ = jax_wide(
        jnp.asarray(queries), jnp.zeros(SQ, jnp.int32), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(bits_to_onehot8(rbits, R, R)),
        jnp.asarray(bits_to_onehot8(masks, R, R)), jnp.float32(1.0), 6,
        q_tile=SQ_TILE, block_rows=256, group=8, merge="none",
        interpret=True, metric=metric, score_shift=shift, **slot)
    return np.asarray(want)


@pytest.mark.parametrize("metric,shift", [("l2", 2), ("ip", 0)])
def test_wide_slot_form_interleaved_matches_tpu_kernel(
        raw_minima, wide_slot_prob, metric, shift):
    """The interleaved layout is the TPU kernel's own (pltpu.repeat within
    each q_tile): the plain slot form is bit-identical to
    int8_masked_topk_wide(mask_sub_block=4) in interpret mode, fed the same
    slot one-hots."""
    vecs, norms, rbits, queries, slots = wide_slot_prob
    want = _jax_wide_minima(vecs, norms, rbits, queries, slots, metric,
                            shift, mask_sub_block=SSB)
    t = torch.from_numpy
    got = int8_group_minima(
        t(queries), t(vecs), t(norms), t(rbits.view(np.int32)),
        t(slots.view(np.int32)), group=8, metric=metric, score_shift=shift,
        mask_sub_block=SSB, slot_tile=SQ_TILE)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("slot_tile", [0, SQ_TILE],
                         ids=["contiguous", "interleaved"])
def test_wide_slot_form_equals_expanded_masks(raw_minima, wide_slot_prob,
                                              slot_tile):
    """Either layout gives, bit for bit, the TPU kernel's per-query output
    on the masks expanded from the slots (test_int8.py:679's parity)."""
    vecs, norms, rbits, queries, slots = wide_slot_prob
    per_query = slots[slot_of_query(SQ, SSB, slot_tile).numpy()]
    want = _jax_wide_minima(vecs, norms, rbits, queries, per_query, "l2", 2)
    t = torch.from_numpy
    got = int8_group_minima(
        t(queries), t(vecs), t(norms), t(rbits.view(np.int32)),
        t(slots.view(np.int32)), group=8, metric="l2", score_shift=2,
        mask_sub_block=SSB, slot_tile=slot_tile)
    np.testing.assert_array_equal(got.numpy(), want)
    empty = np.flatnonzero(~per_query.any(axis=1))
    assert len(empty) and (got.numpy()[:, empty] == MASKED_I32).all()
