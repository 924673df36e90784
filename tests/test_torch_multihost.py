"""The port's process axis on the CPU: `local_row_range` against the
reference's, the one-process `multihost_quant_arena` against the plain
sharded upload (and the reference's arrays) and, with a scale hint on
float rows, against quantize_corpus; a process group the arrays were not
ingested over leaving the search in process; a gloo leg of two spawned
processes x two local shards serving the int8 flagship (its plain
version) equal to the in-process four-shard mesh, and the port's
`dryrun_multichip` over ["cpu"] * 8.

The gloo leg's group waits at most 30 s to start and its run 55 s in all;
a hang fails the test instead of holding the suite. Its rows split on the
same shard boundaries in both layouts (4,096 rows, blocks of 256), so the
two hold the same group minima in the same order: dists and ids equal,
array for array."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.parallel import make_mesh as ref_make_mesh
from vectorsearch_rbac_tpu.parallel import multihost as ref_multihost
from vectorsearch_rbac_tpu_torch.core import ArenaQuant, quantize_corpus
from vectorsearch_rbac_tpu_torch.data import sift_like_corpus
from vectorsearch_rbac_tpu_torch.parallel import make_mesh
from vectorsearch_rbac_tpu_torch.parallel.dryrun import dryrun_multichip
from vectorsearch_rbac_tpu_torch.parallel.multihost import (
    local_row_range, multihost_quant_arena, spawn_flagship,
    start_process_group)
from vectorsearch_rbac_tpu_torch.parallel.sharded import (shard_quant_arrays,
                                                          sharded_int8_topk)
from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator

CPU8 = ["cpu"] * 8


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test (many small ops stall
    on a contended intra-op pool when other test workers share the
    cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n,block_rows,pc", [
    (1000, 64, 1), (1000, 64, 2), (4096, 256, 2), (100_003, 4096, 3),
    (5, 4096, 4), (262_144, 4096, 2)])
def test_local_row_range_matches_reference(n, block_rows, pc):
    """Every process's [start, end) equals the reference's; the ranges
    tile [0, n); with no process group, one process owns every row."""
    got = [local_row_range(n, block_rows, pi, pc) for pi in range(pc)]
    assert got == [ref_multihost.local_row_range(n, block_rows, pi, pc)
                   for pi in range(pc)]
    covered = np.concatenate([np.arange(s, e) for s, e in got])
    np.testing.assert_array_equal(covered, np.arange(n))
    assert local_row_range(n, block_rows) == (0, n)


def test_single_process_ingest_matches_sharded_upload(small_world,
                                                      small_corpus):
    """One process: multihost_quant_arena's shards equal the plain
    sharded upload of the whole quantized corpus, and the reference's
    assembled codes and norms; the shards start at row 0."""
    world = TreeRBACGenerator(num_users=120, num_roles=24, num_docs=200,
                              h=3, b0=2, b1=3, seed=7).generate()
    vecs = small_corpus.vectors
    bits = small_corpus.vector_role_bits(small_world)
    np.testing.assert_array_equal(bits, small_corpus.vector_role_bits(world))
    mesh = make_mesh(8, n_replicas=2, devices=CPU8)
    vq, nq, bd, (scale, center, qclip) = multihost_quant_arena(
        vecs, bits, mesh, n_global=len(vecs), block_rows=64)
    assert vq.row_offset == 0 and vq.shape[0] % 4 == 0
    assert not (vq.across_processes or nq.across_processes
                or bd.across_processes)
    xq, nq_, s2, c2, _, q2 = quantize_corpus(vecs, vq.shape[0])
    assert (scale, qclip) == (s2, q2)
    np.testing.assert_array_equal(center, c2)
    bits_pad = np.zeros((vq.shape[0], bits.shape[1]), np.uint32)
    bits_pad[:len(bits)] = bits
    for got, want in zip((vq, nq, bd),
                         shard_quant_arrays(mesh, xq, nq_, bits_pad)):
        assert got.shape == want.shape
        for r in range(2):
            for s in range(4):
                assert torch.equal(got.parts[r][s], want.parts[r][s])
    rvq, rnq, _, _ = ref_multihost.multihost_quant_arena(
        vecs, bits, small_world, ref_make_mesh(8, n_replicas=2),
        n_global=len(vecs), block_rows=64)
    np.testing.assert_array_equal(vq.gather().numpy(), np.asarray(rvq))
    np.testing.assert_array_equal(nq.gather().numpy(), np.asarray(rnq))


def test_scale_hint_ingest_equals_quantize_corpus(small_world,
                                                  small_corpus):
    """A float corpus (not lossless: its own center and scale) ingested
    with the corpus's global parameters as the hint: the codes and norms
    equal quantize_corpus's on the whole corpus."""
    vecs = small_corpus.vectors
    bits = small_corpus.vector_role_bits(small_world)
    mesh = make_mesh(4, devices=CPU8)
    npad = multihost_quant_arena(vecs, bits, mesh, len(vecs),
                                 block_rows=64)[0].shape[0]
    xq, nq_, scale, center, lossless, qclip = quantize_corpus(vecs, npad)
    assert not lossless and not np.all(center == 128.0)
    vq, nq, _, hint = multihost_quant_arena(
        vecs, bits, mesh, len(vecs), block_rows=64,
        scale_hint=(scale, center, qclip))
    assert hint[0] == scale and hint[2] == qclip
    np.testing.assert_array_equal(vq.gather().numpy(), xq)
    np.testing.assert_array_equal(nq.gather().numpy(), nq_)


def test_unrelated_process_group_keeps_search_in_process(
        small_world, small_corpus, monkeypatch, one_thread):
    """A default process group of two ranks that the arrays were not
    ingested over (started for another reason) leaves the sharded
    flagship in process: no collective is called and the result is the
    one without a group."""
    vecs = small_corpus.vectors
    bits = small_corpus.vector_role_bits(small_world)
    mesh = make_mesh(4, devices=CPU8)
    xq, nq_, scale, center, _, qclip = quantize_corpus(vecs, 1024)
    vq, nqd, bd = shard_quant_arrays(mesh, xq, nq_, np.concatenate(
        [bits, np.zeros((1024 - len(bits), bits.shape[1]), np.uint32)]))
    quant = ArenaQuant(vectors_q=vq, norms_q=nqd, scale=scale,
                       center=center, lossless=False, qclip=qclip)
    q8, qn = quant.quantize_queries(vecs[:8] + 0.01)
    qbits = small_world.user_masks[np.arange(8) % small_world.num_users]

    def search():
        return sharded_int8_topk(mesh, q8, qn, vq, nqd, bd, qbits,
                                 1.0 / scale**2, 5, group=8,
                                 score_shift=quant.score_shift)

    want = search()

    def no_collective(*args, **kwargs):
        raise AssertionError("a collective was called")

    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a, **k: 2)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 1)
    monkeypatch.setattr(dist, "all_gather", no_collective)
    got = search()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_process_group_backend_is_named():
    """The backend is the caller's, never guessed: another name raises
    before any rendezvous."""
    with pytest.raises(ValueError, match="backend 'mpi'"):
        start_process_group("mpi", 0, 1, 29500)


def test_gloo_two_processes_equal_in_process_mesh(one_thread):
    """Two spawned CPU processes over gloo, each ingesting its half of a
    4,096-row SIFT-like corpus onto 2 local shards, serve the flagship
    (candidates all-gathered over the group): both ranks' dists and ids
    equal the in-process 4-shard mesh's on the same rows."""
    corpus, pool = sift_like_corpus(num_vectors=4096, blocks_per_doc=8,
                                    seed=0)
    world = TreeRBACGenerator(num_users=200, num_roles=24,
                              num_docs=corpus.num_docs, h=3, b0=2, b1=3,
                              seed=1).generate()
    bits = corpus.vector_role_bits(world)
    rng = np.random.default_rng(2)
    queries = pool[:32]
    qbits = world.user_masks[rng.integers(0, world.num_users, 32)]
    n, block_rows, k, group = corpus.n, 256, 10, 8
    xq, nq, scale, center, lossless, qclip = quantize_corpus(
        corpus.vectors, n)
    assert lossless and n % (4 * block_rows) == 0
    ranks = spawn_flagship(2, 2, "cpu", "gloo", corpus.vectors, bits,
                           queries, qbits, (scale, center, qclip), k, group,
                           block_rows, timeout_s=30.0, deadline_s=55.0)
    mesh = make_mesh(4, devices=CPU8)
    vq, nqd, bd = shard_quant_arrays(mesh, xq, nq, bits)
    quant = ArenaQuant(vectors_q=vq, norms_q=nqd, scale=scale, center=center,
                       lossless=True, qclip=qclip)
    q8, qn = quant.quantize_queries(queries)
    d, i = sharded_int8_topk(mesh, q8, qn, vq, nqd, bd, qbits,
                             1.0 / scale**2, k, group=group,
                             score_shift=quant.score_shift)
    assert (i >= 0).float().mean() > 0.9
    for rd, ri in ranks:
        np.testing.assert_array_equal(rd, d.numpy())
        np.testing.assert_array_equal(ri, i.numpy())


def test_dryrun_multichip_on_cpu_mesh(capsys, one_thread):
    """The port's dryrun over 4 shards x 2 replicas of the CPU: the five
    paths run and hold against one device."""
    dryrun_multichip(8, devices=CPU8)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK: mesh {'repl': 2, 'shard': 4}" in out
    assert "sharded graph probes executed" in out
