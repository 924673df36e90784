"""The port's fused int8 scan (vectorsearch_rbac_tpu_torch.ops.scan_int8)
against the JAX kernel it replaces, run in Pallas interpret mode on the CPU.

The port's CPU path is the kernel's plain PyTorch version, so these tests
hold that version bit-identical to the TPU kernel's packed group minima at
the geometry of tests/test_pallas.py. Both sides get the same role
bitsets: the port ANDs the (N, W) words, the JAX kernel multiplies their
bits_to_onehot8 expansion."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import bits_to_onehot8
from vectorsearch_rbac_tpu.ops.pallas_scan_int8 import (
    int8_masked_topk as jax_int8_masked_topk)
from vectorsearch_rbac_tpu_torch.ops.scan_int8 import (
    int8_group_minima, int8_group_minima_plain, int8_masked_topk,
    slot_of_query)

N, D, R, Q = 8192, 128, 128, 64


def _pack_bits(onehot: np.ndarray) -> np.ndarray:
    """(n, R) 0/1 -> (n, R/32) uint32 bitsets (bit b of word w = role 32w+b)."""
    n, r = onehot.shape
    bits = np.zeros((n, r // 32), np.uint32)
    for role in range(r):
        bits[:, role // 32] |= (onehot[:, role].astype(np.uint32)
                                << np.uint32(role % 32))
    return bits


@pytest.fixture(scope="module")
def prob():
    rng = np.random.default_rng(0)
    vecs = rng.integers(-100, 100, size=(N, D)).astype(np.int8)
    norms = np.einsum("nd,nd->n", vecs.astype(np.int64),
                      vecs.astype(np.int64)).astype(np.int32)
    roles = (rng.random((N, R)) < 0.05).astype(np.int8)
    roles[:, 0] |= (rng.random(N) < 0.3)          # a popular role
    queries = rng.integers(-100, 100, size=(Q, D)).astype(np.int8)
    qnorms = np.einsum("qd,qd->q", queries.astype(np.int64),
                       queries.astype(np.int64)).astype(np.int32)
    masks = (rng.random((Q, R)) < 0.1).astype(np.int8)
    masks[:, 0] = 1
    masks[3] = 0                                  # one query sees nothing
    return vecs, norms, _pack_bits(roles), queries, qnorms, _pack_bits(masks)


def _jax(prob, k, group, merge, metric="l2", score_shift=0):
    vecs, norms, rbits, queries, qnorms, qbits = prob
    return jax_int8_masked_topk(
        jnp.asarray(queries), jnp.asarray(qnorms), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(bits_to_onehot8(rbits, R, R)),
        jnp.asarray(bits_to_onehot8(qbits, R, R)), jnp.float32(1.0), k,
        q_tile=Q, block_rows=2048, group=group, merge=merge, metric=metric,
        score_shift=score_shift, interpret=True)


def _torch_args(prob):
    vecs, norms, rbits, queries, qnorms, qbits = prob
    t = torch.from_numpy
    return (t(queries), t(qnorms), t(vecs), t(norms), t(rbits.view(np.int32)),
            t(qbits.view(np.int32)))


@pytest.mark.parametrize("group,metric,score_shift", [
    (64, "l2", 0), (128, "l2", 0), (128, "ip", 0), (128, "l2", 3)])
def test_packed_minima_bit_identical(prob, group, metric, score_shift):
    want, _ = _jax(prob, 10, group, "none", metric, score_shift)
    q8, _, x8, norms, rbits, qbits = _torch_args(prob)
    got = int8_group_minima(q8, x8, norms, rbits, qbits, group=group,
                            metric=metric, score_shift=score_shift)
    assert got.shape == (N // group, Q) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("group", [64, 128])
def test_decoded_topk_matches_exact_merge(prob, group):
    """(dists, idx) after the decode equal the JAX kernel's merge="exact"
    output: ids exactly, dists with rtol 0 (lossless integer data)."""
    want_d, want_i = _jax(prob, 10, group, "exact")
    q8, qn, x8, norms, rbits, qbits = _torch_args(prob)
    got_d, got_i = int8_masked_topk(q8, qn, x8, norms, rbits, qbits, 1.0, 10,
                                    group=group, merge="exact")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


def test_all_masked_query_is_empty(prob):
    q8, qn, x8, norms, rbits, qbits = _torch_args(prob)
    zero = torch.zeros_like(qbits[:8])
    d, i = int8_masked_topk(q8[:8], qn[:8], x8, norms, rbits, zero, 1.0, 10,
                            group=128)
    assert (i == -1).all() and torch.isinf(d).all()
    # the fixture's query 3 has an all-zero mask inside a normal batch
    d, i = int8_masked_topk(q8, qn, x8, norms, rbits, qbits, 1.0, 10,
                            group=128)
    assert (i[3] == -1).all() and torch.isinf(d[3]).all()
    assert (i[0] >= 0).all() and torch.isfinite(d[0]).all()


def test_cuda_tensor_never_takes_the_plain_version(prob, monkeypatch):
    """The wrapper picks the plain version only for CPU tensors: a tensor
    on another device goes to the kernel library (here: refused)."""
    from vectorsearch_rbac_tpu_torch.ops import _build, scan_int8

    def no_library():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(_build, "lib", no_library)
    q8, _, x8, norms, rbits, qbits = (t.to("meta") for t in _torch_args(prob))
    with pytest.raises(RuntimeError, match="kernel library requested"):
        scan_int8.int8_group_minima(q8, x8, norms, rbits, qbits)


def test_ip_decode_refused(prob):
    """The ip decode takes one scale or one per query, and a bias per query:
    operands that do not match the batch, or a metric the int8 scan does
    not score, are refused rather than broadcast into wrong distances."""
    q8, qn, x8, norms, rbits, qbits = _torch_args(prob)
    inv = torch.ones(Q - 1)
    with pytest.raises(ValueError, match="per-query inv"):
        int8_masked_topk(q8, None, x8, norms, rbits, qbits, inv, 10,
                         group=128, metric="ip")
    with pytest.raises(ValueError, match="query_bias"):
        int8_masked_topk(q8, None, x8, norms, rbits, qbits, torch.ones(Q),
                         10, group=128, metric="ip",
                         query_bias=torch.ones(Q + 1))
    with pytest.raises(ValueError, match="cosine rides ip"):
        int8_masked_topk(q8, qn, x8, norms, rbits, qbits, 1.0, 10,
                         group=128, metric="cosine")
    d, _ = int8_masked_topk(q8, None, x8, norms, rbits, qbits,
                            torch.full((Q,), 0.5), 10, group=128,
                            metric="ip", query_bias=torch.ones(Q))
    d0, _ = int8_masked_topk(q8, None, x8, norms, rbits, qbits, 1.0, 10,
                             group=128, metric="ip")
    fin = torch.isfinite(d0)
    assert torch.equal(d[fin], d0[fin] * 0.5 + 1.0)


# ---- the admit-dedup slot form (mask_sub_block), both slot layouts

SB, Q_TILE = 8, 32


@pytest.fixture(scope="module")
def slot_prob(prob):
    """The fixture's rows and queries with 5 distinct masks spread over
    Q / SB slots (slot s carries mask s % 5): (vecs, norms, rbits,
    queries, slot bits (Q / SB, W) uint32)."""
    vecs, norms, rbits, queries, _, qbits = prob
    pool = qbits[[0, 1, 2, 3, 4]]                 # mask 3 sees nothing
    slots = pool[np.arange(Q // SB) % len(pool)]
    return vecs, norms, rbits, queries, slots


def _expand(slots, slot_tile):
    """Per-query masks: query j reads slot_of_query(j)."""
    return slots[slot_of_query(Q, SB, slot_tile).numpy()]


def test_slot_layouts():
    assert slot_of_query(16, 4).tolist() == [i // 4 for i in range(16)]
    # interleaved within tiles of 8: nsb = 2 slots a tile, query j of
    # tile t reads slot 2t + j % 2
    assert slot_of_query(16, 4, 8).tolist() == [
        2 * (j // 8) + j % 2 for j in range(16)]
    with pytest.raises(ValueError):
        slot_of_query(12, 8)
    with pytest.raises(ValueError):
        slot_of_query(16, 4, 6)


def test_slot_form_plain_matches_tpu_kernel(slot_prob):
    """The interleaved layout is the TPU kernel's own: the plain slot form
    is bit-identical to int8_masked_topk(mask_sub_block=SB) in interpret
    mode, fed the same slot one-hots."""
    vecs, norms, rbits, queries, slots = slot_prob
    want, _ = jax_int8_masked_topk(
        jnp.asarray(queries), jnp.zeros(Q, jnp.int32), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(bits_to_onehot8(rbits, R, R)),
        jnp.asarray(bits_to_onehot8(slots, R, R)), jnp.float32(1.0), 10,
        q_tile=Q_TILE, block_rows=2048, group=32, merge="none",
        mask_sub_block=SB, interpret=True)
    t = torch.from_numpy
    got = int8_group_minima_plain(
        t(queries), t(vecs), t(norms), t(rbits.view(np.int32)),
        t(slots.view(np.int32)), group=32, mask_sub_block=SB,
        slot_tile=Q_TILE)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("slot_tile", [0, Q_TILE],
                         ids=["contiguous", "interleaved"])
@pytest.mark.parametrize("group,metric,score_shift", [
    (8, "l2", 0), (128, "ip", 0), (32, "l2", 3)])
def test_slot_form_equals_expanded_masks(slot_prob, slot_tile, group, metric,
                                         score_shift):
    """Either layout gives, bit for bit, the TPU kernel's per-query output
    on the masks expanded from the slots (the lab's parity check,
    scripts/r4_admit_lab.py parity())."""
    vecs, norms, rbits, queries, slots = slot_prob
    per_query = _expand(slots, slot_tile)
    want, _ = jax_int8_masked_topk(
        jnp.asarray(queries), jnp.zeros(Q, jnp.int32), jnp.asarray(vecs),
        jnp.asarray(norms), jnp.asarray(bits_to_onehot8(rbits, R, R)),
        jnp.asarray(bits_to_onehot8(per_query, R, R)), jnp.float32(1.0), 10,
        q_tile=Q, block_rows=2048, group=group, merge="none", metric=metric,
        score_shift=score_shift, interpret=True)
    t = torch.from_numpy
    got = int8_group_minima(
        t(queries), t(vecs), t(norms), t(rbits.view(np.int32)),
        t(slots.view(np.int32)), group=group, metric=metric,
        score_shift=score_shift, mask_sub_block=SB, slot_tile=slot_tile)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the query that reads the empty mask sees nothing
    empty = np.flatnonzero(~per_query.any(axis=1))
    assert len(empty) and (got.numpy()[:, empty] == 0x7F000000).all()


def test_slot_form_refuses_ragged_slots(slot_prob):
    vecs, norms, rbits, queries, slots = slot_prob
    t = torch.from_numpy
    args = (t(queries), t(vecs), t(norms), t(rbits.view(np.int32)))
    with pytest.raises(ValueError, match="bitset shapes"):
        int8_group_minima(*args, t(slots[:-1].view(np.int32)),
                          mask_sub_block=SB)
    with pytest.raises(ValueError, match="do not tile"):
        int8_group_minima(*args, t(slots.view(np.int32)), mask_sub_block=SB,
                          slot_tile=12)


# ---- the cascade, approx and auto merges against _merge_group_minima

def _minima(ng, nq, seed, distinct=False):
    """(ng, nq) packed minima with many equal values (scores from a small
    range, so ties between groups are common), or with none (distinct),
    some inadmissible groups, and one query with nothing admissible."""
    rng = np.random.default_rng(seed)
    if distinct:
        score = np.stack([rng.choice(1 << 22, ng, replace=False) - (1 << 21)
                          for _ in range(nq)], axis=1)
    else:
        score = rng.integers(-3000, 3000, size=(ng, nq))
    packed = (score * 128 + rng.integers(0, 4, size=(ng, nq))).astype(np.int32)
    packed[rng.random((ng, nq)) < 0.2] = 0x7F000000
    packed[:, 1] = 0x7F000000
    return packed


@pytest.mark.parametrize("ng,k,merge", [
    (4096, 10, "cascade"), (4096, 100, "cascade"),   # t 8 and t 24
    (1024, 10, "cascade"),                           # < 2048: exact
    (4096, 10, "approx"), (256, 100, "approx"),      # < 4k: exact
    (40960, 10, "auto"), (4096, 10, "auto"),         # approx / exact
    (4096, 600, "kernel"),                           # gate refuses: cascade
])
def test_merges_match_reference(ng, k, merge):
    """merge_group_minima against the reference's _merge_group_minima on
    the same packed minima: ids and distances equal, ties to the lower
    group as lax.top_k orders them. "kernel" on a shape the merge gate
    refuses is the cascade, as the reference's "pallas" there.

    The approx cases take minima without equal values: on the CPU
    approx_min_k falls back to XLA's unstable sort, whose order of equal
    keys is its own (the set it selects is the exact 2k, as here)."""
    from vectorsearch_rbac_tpu.ops.pallas_scan_int8 import _merge_group_minima
    from vectorsearch_rbac_tpu_torch.ops.scan_int8 import merge_group_minima

    nq, group = 8, 16
    approx = merge == "approx" or (merge == "auto" and ng > 32768)
    packed = _minima(ng, nq, seed=ng + k, distinct=approx)
    qn = np.random.default_rng(1).integers(0, 10**6, nq).astype(np.int32)
    want_d, want_i = _merge_group_minima(
        jnp.asarray(packed), jnp.asarray(qn), jnp.float32(0.25), k, group,
        "pallas" if merge == "kernel" else merge, "l2", None, 0)
    got_d, got_i = merge_group_minima(
        torch.from_numpy(packed), torch.from_numpy(qn), 0.25, k, group, merge,
        "l2")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert (got_i.numpy()[1] == -1).all()


def test_cascade_keeps_t_per_subgroup():
    """The cascade keeps the t smallest of each subgroup of 128 groups: a
    subgroup holding more than t of the true top-k loses the rest, which
    the exact merge keeps."""
    from vectorsearch_rbac_tpu_torch.ops.scan_int8 import merge_group_minima

    ng, k = 2048, 10                        # t = max(10 // 4 + 4, 8) = 8
    packed = np.full((ng, 1), 1000 * 128, np.int32)
    packed[:12, 0] = np.arange(12) * 128    # 12 best, all in subgroup 0
    args = (torch.from_numpy(packed), torch.zeros(1, dtype=torch.int32), 1.0,
            k, 8)
    _, exact = merge_group_minima(*args, "exact", "l2")
    _, cascade = merge_group_minima(*args, "cascade", "l2")
    assert exact[0, :10].tolist() == [g * 8 for g in range(10)]
    assert cascade[0, :8].tolist() == [g * 8 for g in range(8)]
    # the 9th best (group 8) is lost: next comes subgroup 1's first group
    assert cascade[0, 8] == 128 * 8
    with pytest.raises(ValueError, match="not one of"):
        merge_group_minima(*args, "pallas", "l2")
