"""The port's group-minima merge (vectorsearch_rbac_tpu_torch.ops.merge)
against the JAX kernels it replaces, run in Pallas interpret mode on the
CPU, on the fixture of tests/test_pallas_merge.py.

The port's CPU path is the kernels' plain PyTorch versions: values must be
identical and positions identical wherever the value is a real candidate
(below 0x7E000000)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.ops.pallas_merge import pallas_merge_topk
from vectorsearch_rbac_tpu_torch.ops.merge import (
    extract_pairs, merge_supported, merge_topk)

MASKED = 0x7F000000
EMPTY = 0x7E000000


def _fixture(rng, dup: bool):
    ng, q = 512, 128
    if dup:   # 16 scores x 4 lanes: equal packed values in every column
        p = (rng.integers(1 << 10, (1 << 10) + 16, size=(ng, q))
             .astype(np.int32) << 7)
    else:
        p = (rng.integers(1 << 10, 1 << 28, size=(ng, q), dtype=np.int64)
             .astype(np.int32) & ~np.int32(127))
    lanes = 4 if dup else 128
    p |= rng.integers(0, lanes, size=(ng, q), dtype=np.int64).astype(np.int32)
    # query 5: only 3 admissible groups; query 7: none at all
    p[3:, 5] = MASKED
    p[:, 7] = MASKED
    return p


@pytest.fixture(scope="module", params=[False, True], ids=["distinct", "ties"])
def packed(request):
    return _fixture(np.random.default_rng(3), request.param)


def _both(packed, k=10):
    want_v, want_p = pallas_merge_topk(jnp.asarray(packed), k, nsub=8, t=8,
                                       q_tile=128, interpret=True)
    got_v, got_p = merge_topk(torch.from_numpy(packed), k, nsub=8, t=8)
    return (np.asarray(want_v), np.asarray(want_p), got_v.numpy(),
            got_p.numpy())


def test_merge_matches_pallas(packed):
    want_v, want_p, got_v, got_p = _both(packed)
    np.testing.assert_array_equal(got_v, want_v)
    real = want_v < EMPTY
    np.testing.assert_array_equal(got_p[real], want_p[real])
    # positions agree with values
    qi, _ = np.nonzero(real)
    np.testing.assert_array_equal(packed[got_p[real], qi], got_v[real])


def test_drained_subgroups(packed):
    """Fewer admissible groups than k: the extraction sentinel lands in
    the empty range, never decoding to a row."""
    want_v, _, got_v, _ = _both(packed)
    np.testing.assert_array_equal(got_v[[5, 7]], want_v[[5, 7]])
    assert (got_v[5, 3:] >= EMPTY).all() and (got_v[5, :3] < EMPTY).all()
    assert (got_v[7] >= EMPTY).all()


def test_extract_is_distinct_minima(packed):
    """Stage 1 alone against its definition: per subgroup, the t smallest
    distinct values ascending, each with the smallest meta among its rows."""
    nsub, t = 8, 8
    y, meta = extract_pairs(torch.from_numpy(packed), nsub, t)
    y, meta = y.numpy(), meta.numpy()
    sub = packed.shape[0] // nsub
    for j in range(nsub):
        for q in (0, 5, 7, 64):
            col = packed[j * sub:(j + 1) * sub, q]
            vals = np.unique(col)[:t]
            np.testing.assert_array_equal(y[j * t:j * t + len(vals), q], vals)
            assert (y[j * t + len(vals):(j + 1) * t, q] == 2**31 - 1).all()
            for r, v in enumerate(vals):
                rows = np.nonzero(col == v)[0]
                want = min(((j * sub + p) << 7) | (int(v) & 127) for p in rows)
                assert meta[j * t + r, q] == want


def test_merge_gate():
    assert merge_supported(8192, 100)          # the 1M main-path shape
    assert merge_supported(78848, 100)         # the 10M shape
    assert merge_supported(2048, 10)           # 64 groups per subgroup
    assert not merge_supported(8192, 600)      # k beyond the survivors
    assert not merge_supported(100, 10)        # subgroups do not tile
    assert not merge_supported(1024, 10)       # 32 groups per subgroup
    assert not merge_supported(8192, 10, nsub=32, t=12)  # npc not 2^n
    assert not merge_supported(65536, 10, nsub=256, t=16)  # npc > 2048


def test_gate_refusal_takes_exact_merge():
    """A shape the gate refuses decodes through the exact merge: same
    result as sorting every group minimum."""
    from vectorsearch_rbac_tpu_torch.ops.scan_int8 import merge_group_minima

    rng = np.random.default_rng(5)
    p = (rng.integers(0, 1 << 20, size=(64, 16)).astype(np.int32) << 7)
    p |= rng.integers(0, 128, size=p.shape).astype(np.int32)
    assert not merge_supported(64, 10)
    d, i = merge_group_minima(torch.from_numpy(p), torch.zeros(16, dtype=torch.int32),
                              1.0, 10, 128, "kernel", "l2")
    order = np.argsort(p.T, axis=1, kind="stable")[:, :10]
    want = order * 128 + (np.take_along_axis(p.T, order, 1) & 127)
    np.testing.assert_array_equal(i.numpy(), want)
