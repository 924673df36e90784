"""The port's result wire (ops/scan_int8.py pack_results_device /
unpack_results_host) against the reference's, byte for byte, for the "ids"
and "f32" wires."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.ops import pallas_scan_int8 as ref
from vectorsearch_rbac_tpu_torch.ops.scan_int8 import (
    pack_results_device, unpack_results_host)


def _results(k: int, id_bits: int, seed: int = 0):
    """Ascending dists with an empty (+inf) suffix on some rows, ids spanning
    the full id width, -1 on the empty slots."""
    rng = np.random.default_rng(seed)
    q = 12
    d = np.sort(rng.random((q, k), dtype=np.float32) * 1e6, axis=1)
    i = rng.integers(0, 1 << id_bits, size=(q, k)).astype(np.int32)
    i[0, 0] = (1 << id_bits) - 1
    for row, n_real in ((1, 0), (2, 3), (3, k - 1)):
        d[row, n_real:] = np.inf
        i[row, n_real:] = -1
    return d, i


@pytest.mark.parametrize("dist", ["ids", "f32"])
@pytest.mark.parametrize("k,id_bits", [(10, 14), (10, 20), (100, 20),
                                       (100, 24), (30, 17)])
def test_pack_unpack_byte_identical(dist, k, id_bits):
    d, i = _results(k, id_bits)
    want = np.asarray(ref.pack_results_device(
        jnp.asarray(d), jnp.asarray(i), id_bits=id_bits, dist=dist))
    got = pack_results_device(torch.from_numpy(d), torch.from_numpy(i),
                              id_bits=id_bits, dist=dist)
    assert got.dtype == torch.int16
    got = got.numpy().view(np.uint16)
    assert got.tobytes() == want.tobytes() and got.shape == want.shape

    want_d, want_i = ref.unpack_results_host(want, k, id_bits=id_bits,
                                             dist=dist)
    got_d, got_i = unpack_results_host(got, k, id_bits=id_bits, dist=dist)
    assert got_d.tobytes() == want_d.tobytes()
    np.testing.assert_array_equal(got_i, want_i)
    # the ids survive the round trip; f32 keeps the distances bit for bit
    np.testing.assert_array_equal(got_i, i)
    if dist == "f32":
        assert got_d.astype(np.float32).tobytes() == d.tobytes()
