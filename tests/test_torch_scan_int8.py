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
    int8_group_minima, int8_masked_topk)

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
    """The ip/cosine decode needs per-query scales the port does not carry
    yet: it refuses rather than return wrong distances."""
    q8, qn, x8, norms, rbits, qbits = _torch_args(prob)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        int8_masked_topk(q8, qn, x8, norms, rbits, qbits, 1.0, 10,
                         group=128, metric="ip")
