"""The port's result wire (ops/scan_int8.py pack_results_device /
unpack_results_host) against the reference's, byte for byte, for all four
wires: ids, f32, bf16 and u8. The u8 code computes (d - dmin) / range * 254
in the reference's order and rounds half to even; XLA's CPU code for the
same float32 ops gives the same bytes on these inputs, so the test holds
u8 byte-identical with no tolerance."""

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
    for row, n_real in ((1, 0), (2, 3), (3, k - 1), (4, 1)):
        d[row, n_real:] = np.inf
        i[row, n_real:] = -1
    d[5] = 1234.5                     # one value all along: range 1e-9
    d[6, : k // 2] = d[6, 0]          # ties
    d[7] = np.sort(rng.integers(0, 300, k)).astype(np.float32) * 0.5
    return d, i


@pytest.mark.parametrize("dist", ["ids", "f32", "bf16", "u8"])
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
    elif dist == "bf16":
        # 8 significant bits, rounded to nearest: half an ulp, 2^-8 of
        # the value at most
        fin = np.isfinite(d)
        assert (np.abs(got_d[fin] - d[fin]) <= np.abs(d[fin]) * 2.0**-8).all()
    elif dist == "u8":
        # half a code step of each row's own span
        fin = np.isfinite(d)
        span = np.where(fin, d, -np.inf).max(1) - np.where(fin, d, np.inf).min(1)
        step = np.maximum(np.where(fin.any(1), span, 0.0), 1e-9) / 254.0
        bound = 0.5 * step[:, None] * 1.0001 + 1e-6 * np.abs(d)
        assert (np.abs(got_d[fin] - d[fin]) <= bound[fin]).all()


def test_u8_wire_needs_even_k():
    """The u8 code packs two results to a u16: an odd k is refused (the
    index sends it on bf16 instead, as the reference's does); bf16 takes
    any k."""
    d, i = _results(11, 20)
    with pytest.raises(ValueError, match="even k"):
        pack_results_device(torch.from_numpy(d), torch.from_numpy(i),
                            id_bits=20, dist="u8")
    want = np.asarray(ref.pack_results_device(
        jnp.asarray(d), jnp.asarray(i), id_bits=20, dist="bf16"))
    got = pack_results_device(torch.from_numpy(d), torch.from_numpy(i),
                              id_bits=20, dist="bf16")
    assert got.numpy().view(np.uint16).tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="not one of"):
        pack_results_device(torch.from_numpy(d), torch.from_numpy(i),
                            dist="f16")
