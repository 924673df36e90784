"""The port's sharded scans and k-means step against the JAX reference on
the CPU, on the reference's own problem (tests/test_parallel.py: 1,024 x
32 rows, 2 bitset words, 16 queries, k 8, block 64).

The reference runs on the 8 virtual CPU devices of tests/conftest.py (its
Pallas kernels in interpret mode); the port on make_mesh(...,
devices=["cpu"] * 8), its kernels' plain versions. Tolerances: distances
to rtol 1e-5 of the case's largest distance (the float scans sum in
another order), ids equal except among distances within that tolerance,
compared as sets (the ROADMAP tie rule); the int8 flagship's distances
and ids exactly where no two candidates tie; k-means centroids to rtol
and atol 1e-4, the reference's own bound for its sharded step (the sum
over shards rounds in another order than XLA's psum)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from vectorsearch_rbac_tpu import core as ref_core
from vectorsearch_rbac_tpu.ops import kmeans as ref_kmeans
from vectorsearch_rbac_tpu.parallel import make_mesh as ref_make_mesh
from vectorsearch_rbac_tpu.parallel import place_partitions as ref_place
from vectorsearch_rbac_tpu.parallel import sharded as ref_sharded
from vectorsearch_rbac_tpu.parallel.mesh import SHARD_AXIS as REF_SHARD
from vectorsearch_rbac_tpu_torch.core import quantize_corpus
from vectorsearch_rbac_tpu_torch.ops import kmeans
from vectorsearch_rbac_tpu_torch.ops.scan import masked_scan_topk
from vectorsearch_rbac_tpu_torch.parallel import (make_mesh,
                                                  place_partitions,
                                                  shard_arena_arrays,
                                                  sharded_masked_topk)
from vectorsearch_rbac_tpu_torch.parallel.mesh import (REPL_AXIS, SHARD_AXIS,
                                                       shard_map_compat)
from vectorsearch_rbac_tpu_torch.parallel.sharded import (shard_quant_arrays,
                                                          shard_rows,
                                                          sharded_int8_topk)

CPU8 = ["cpu"] * 8
RTOL = 1e-5


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test (many small ops stall
    on a contended intra-op pool when other test workers share the
    cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same_topk(got, want, rtol=RTOL):
    """Equal empty slots; finite distances within rtol of the case's
    largest; per query, the ids strictly inside the k-th distance (less
    the tolerance) equal as sets."""
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
        assert (set(gi[q][np.isfinite(gd[q]) & (gd[q] < last - tol)])
                == set(wi[q][ok & (wd[q] < last - tol)])), q


def assert_equal_unless_tied(got, want):
    """Distances bit-equal; ids equal in every query whose distances hold
    no tie, as sets in the others."""
    gd, gi = (np.asarray(a) for a in got)
    wd, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gd, wd)
    for q in range(len(wd)):
        f = wd[q][np.isfinite(wd[q])]
        if len(np.unique(f)) == len(f):
            np.testing.assert_array_equal(gi[q], wi[q])
        else:
            assert set(gi[q]) == set(wi[q]), q


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n, d, w = 1024, 32, 2
    vecs = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.einsum("nd,nd->n", vecs, vecs).astype(np.float32)
    bits = rng.integers(1, 2**31, size=(n, w)).astype(np.uint32)
    q = rng.standard_normal((16, d)).astype(np.float32)
    masks = rng.integers(1, 2**31, size=(16, w)).astype(np.uint32)
    return vecs, norms, bits, q, masks


# ---- the mesh


def test_make_mesh_refuses_missing_devices():
    """More devices than there are raise, with the reference's message; a
    CPU mesh comes only from an explicit device list."""
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"requested {have + 1} devices, "
                       f"have {have}"):
        make_mesh(have + 1)
    with pytest.raises(ValueError, match="requested 9 devices, have 8"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match="divide by n_replicas"):
        make_mesh(8, n_replicas=3, devices=CPU8)
    mesh = make_mesh(8, n_replicas=2, devices=CPU8)
    assert mesh.shape == {REPL_AXIS: 2, SHARD_AXIS: 4}
    assert dict(mesh.shape) == dict(ref_make_mesh(8, n_replicas=2).shape)
    cells = shard_map_compat(lambda r, s, dev: (r, s, dev.type), mesh)()
    assert cells == [[(r, s, "cpu") for s in range(4)] for r in range(2)]


# ---- the sharded float scan


@pytest.mark.parametrize("n_repl", [1, 2])
def test_sharded_scan_matches_reference(problem, n_repl, one_thread):
    """The port's sharded scan against the reference's on the same rows,
    and against its own one-device scan (the same blocks, so the same
    distances; ids may swap only among ties)."""
    vecs, norms, bits, q, masks = problem
    mesh = ref_make_mesh(8, n_replicas=n_repl)
    want = ref_sharded.sharded_masked_topk(
        mesh, jnp.asarray(q), *ref_sharded.shard_arena_arrays(
            mesh, vecs, norms, bits), jnp.asarray(masks), k=8,
        block_rows=64, mode="exact")
    mine = make_mesh(8, n_replicas=n_repl, devices=CPU8)
    got = sharded_masked_topk(mine, q, *shard_arena_arrays(
        mine, vecs, norms, bits), masks, 8, block_rows=64)
    assert_same_topk(got, want)
    one = masked_scan_topk(*(torch.from_numpy(a) for a in (
        q, vecs, norms, bits.view(np.int32), masks.view(np.int32))), 8,
        block_rows=64)
    assert_equal_unless_tied(got, one)


# ---- the sharded int8 flagship


@pytest.mark.parametrize("n_repl", [1, 2])
def test_sharded_int8_matches_reference(problem, n_repl, one_thread):
    """The flagship over 8 shards (or 4 x 2 replicas), group 8, against
    the reference's sharded_int8_topk (its Pallas kernel in interpret
    mode, the exact merge) on the same quantized rows: the same
    distances and ids up to ties."""
    vecs, _, bits, q, masks = problem
    n = vecs.shape[0]
    xq, nq, scale, center, _, qclip = quantize_corpus(vecs, n)
    rq, rnq, rscale, *_ = ref_core.quantize_corpus(vecs, n)
    np.testing.assert_array_equal(xq, rq)
    qs = np.clip(np.rint((q - center) * scale), -qclip, 127).astype(np.int8)
    q8 = np.zeros((len(q), xq.shape[1]), np.int8)
    q8[:, :q.shape[1]] = qs
    qn = np.einsum("qd,qd->q", q8.astype(np.int64),
                   q8.astype(np.int64)).astype(np.int32)
    rmesh = ref_make_mesh(8, n_replicas=n_repl)
    roles8 = ref_core.bits_to_onehot8(bits, 64, 128)
    masks8 = ref_core.bits_to_onehot8(masks, 64, 128)
    want = ref_sharded.sharded_int8_topk(
        rmesh, jnp.asarray(q8), jnp.asarray(qn),
        *ref_sharded.shard_quant_arrays(rmesh, rq, rnq, roles8),
        jnp.asarray(masks8), jnp.float32(1.0 / rscale**2), 8,
        q_tile=16 // n_repl, block_rows=128, group=8, merge="auto",
        interpret=True)
    mesh = make_mesh(8, n_replicas=n_repl, devices=CPU8)
    got = sharded_int8_topk(mesh, q8, qn, *shard_quant_arrays(
        mesh, xq, nq, bits), masks, 1.0 / scale**2, 8, group=8)
    assert_equal_unless_tied(got, want)


# ---- k-means


def test_sharded_kmeans_matches_reference(problem, one_thread):
    """One sharded Lloyd step over 8 shards: centroids to 1e-4 of the
    reference's sharded step and of the port's one-device step, equal
    assignments; the centroids land on every device."""
    vecs = problem[0]
    rmesh = ref_make_mesh(8, n_replicas=1)
    dv = jax.device_put(vecs, NamedSharding(rmesh, P(REF_SHARD, None)))
    init = kmeans.kmeans_init(vecs, 8, seed=1)
    want_c, want_a = ref_kmeans.sharded_kmeans_step(rmesh, dv,
                                                    jnp.asarray(init))
    mesh = make_mesh(8, devices=CPU8)
    got_c, got_a = kmeans.sharded_kmeans_step(mesh, shard_rows(mesh, vecs),
                                              torch.from_numpy(init))
    assert got_c.replicated and len(got_c.parts[0]) == 8
    np.testing.assert_allclose(got_c.gather().numpy(), np.asarray(want_c),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_a.gather().numpy(), np.asarray(want_a))
    one_c, _ = kmeans._update_step(torch.from_numpy(vecs),
                                   torch.from_numpy(init))
    np.testing.assert_allclose(got_c.gather().numpy(), one_c.numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_pad", [0, 100])
def test_weighted_kmeans_matches_reference(problem, n_pad, one_thread):
    """Row weights in the update step, one step and a 4-step fit, against
    the reference's at 1e-4 (n_pad rows more take its padded block); the
    weighted sharded step against the weighted one-device step."""
    vecs = problem[0][:1024 - n_pad]
    rng = np.random.default_rng(3)
    w = rng.uniform(0.0, 2.0, len(vecs)).astype(np.float32)
    w[::7] = 0.0
    init = kmeans.kmeans_init(vecs, 8, seed=2)
    want_c, want_a = ref_kmeans._update_step(
        jnp.asarray(vecs), jnp.asarray(init), jnp.asarray(w))
    got_c, got_a = kmeans._update_step(*(torch.from_numpy(a) for a in (
        vecs, init, w)))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    want_c, want_a = ref_kmeans.kmeans_fit(
        jnp.asarray(vecs), jnp.asarray(init), iters=4, weights=jnp.asarray(w))
    got_c, got_a = kmeans.kmeans_fit(*(torch.from_numpy(a) for a in (
        vecs, init)), iters=4, weights=torch.from_numpy(w))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    if n_pad == 0:
        mesh = make_mesh(4, devices=CPU8)
        sh_c, _ = kmeans.sharded_kmeans_step(
            mesh, shard_rows(mesh, vecs), torch.from_numpy(init),
            shard_rows(mesh, w))
        one_c, _ = kmeans._update_step(*(torch.from_numpy(a) for a in (
            vecs, init, w)))
        np.testing.assert_allclose(sh_c.gather().numpy(), one_c.numpy(),
                                   rtol=1e-4, atol=1e-4)


# ---- placement

LOADS = {0: 10.0, 1: 8.0, 2: 3.0, 3: 3.0, 4: 2.0, 5: 2.0}


@pytest.mark.parametrize("loads,n_devices,replicate", [
    (LOADS, 2, ()), (LOADS, 2, (0,)), (LOADS, 3, (1, 4)), (LOADS, 8, ()),
    ({p: float((p * 37) % 11 + 1) for p in range(40)}, 4, (3,)),
    ({p: 1.0 for p in range(9)}, 4, ())])
def test_place_partitions_matches_reference(loads, n_devices, replicate):
    """The greedy longest-processing-time placement, dict for dict the
    reference's, with and without replicated partitions."""
    got = place_partitions(loads, n_devices, replicate)
    assert got == ref_place(loads, n_devices, replicate)
    for pid in replicate:
        assert got[pid] == tuple(range(n_devices))
