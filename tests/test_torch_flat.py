"""The port's flat family against the JAX reference on the CPU: the bfloat16
and float32 arenas, l1, the exact and approx scans, the augmented scan,
FlatIndex over rows, make_partition_index's kinds, ROLE/USER/AnonySys in
the packed=False layout, and ROLE and QDTree on an l1 arena.

Both packages build the world (64 roles) and the corpora from the same
seeds with their own code: a SIFT-like corpus (2,000 integer-valued rows
of 32 dimensions) and the float synthetic one (1,600 standard-normal rows
of 48 dimensions). The port's arena comes from the reference's through
arena_from_reference, so both compute on the same state.

Tolerances: distances within rtol 1e-5 of the case's largest finite
distance (float32 summation order differs); ids equal except among
distances within that tolerance of the k-th, which compare as sets (the
ROADMAP tie rule). On the CPU XLA's `lax.approx_min_k` falls back to the
exact top-k (held below), so the reference's approx mode is compared
with the port's, which is exact by design.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsearch_rbac_tpu_torch as port
from test_torch_packed import assert_readable, assert_same_topk
from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_sift
from vectorsearch_rbac_tpu.data import synthetic_corpus as ref_synthetic
from vectorsearch_rbac_tpu.index.flat import FlatIndex as RefFlatIndex
from vectorsearch_rbac_tpu.ops.scan import scan_topk_fn as ref_scan
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.partition import base as ref_base
from vectorsearch_rbac_tpu.partition import qdtree as ref_qdtree
from vectorsearch_rbac_tpu.partition import strategies as ref_strategies
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch.core import augment_with_norms
from vectorsearch_rbac_tpu_torch.data import synthetic_corpus
from vectorsearch_rbac_tpu_torch.index.binary import BinaryQuantIndex
from vectorsearch_rbac_tpu_torch.index.flat import FlatIndex
from vectorsearch_rbac_tpu_torch.ops.scan import (masked_scan_topk,
                                                  masked_scan_topk_aug)
from vectorsearch_rbac_tpu_torch.partition import qdtree, strategies
from vectorsearch_rbac_tpu_torch.partition.base import make_partition_index
from vectorsearch_rbac_tpu_torch.partition.packed import PackedSearcher

WORLD = dict(num_users=90, num_roles=64, num_docs=200, h=3, b0=3, b1=3,
             seed=11)
NQ, K, BLOCK = 24, 10, 512
RTOL = 1e-5
# (corpus, dtype, metric)
ARENAS = [("sift", "float32", "l2"), ("sift", "bfloat16", "l2"),
          ("synthetic", "float32", "l1"), ("synthetic", "bfloat16", "l1"),
          ("synthetic", "bfloat16", "cosine"), ("synthetic", "float32", "ip")]


def _id(a):
    return "-".join(a)


@pytest.fixture(scope="module")
def worlds():
    rw = RefTreeGenerator(**WORLD).generate()
    pw = port.TreeRBACGenerator(**WORLD).generate()
    corpora = {
        "sift": ref_sift(num_vectors=2_000, dim=32, blocks_per_doc=10,
                         seed=3)[0],
        "synthetic": ref_synthetic(num_docs=200, blocks_per_doc=8, dim=48,
                                   seed=4),
    }
    rng = np.random.default_rng(5)
    queries = {}
    for name, c in corpora.items():
        rows = rng.integers(0, c.n, NQ)
        noise = 9.0 if name == "sift" else 0.4
        q = c.vectors[rows] + rng.normal(0, noise, (NQ, c.dim))
        queries[name] = (np.rint(q) if name == "sift" else q).astype(
            np.float32)
    users = rng.integers(0, rw.num_users, NQ)
    arenas = {a: ref_arena(corpora[a[0]], rw, block_rows=BLOCK, dtype=a[1],
                           metric=a[2]) for a in ARENAS}
    return dict(rw=rw, pw=pw, corpora=corpora, q=queries, users=users,
                arenas=arenas)


def _cfgs(kind, batch=16):
    out = []
    for cfg in (RefFrameworkConfig(), port.FrameworkConfig()):
        cfg.index.kind = kind
        cfg.search.batch_size = batch
        cfg.search.block_rows = BLOCK
        out.append(cfg)
    return out


def _masks(w):
    return w["rw"].user_masks[w["users"]]


def _aug(arena):
    """The augmented layout the port builds for the whole arena (FlatIndex
    in approx mode), or None."""
    return FlatIndex(arena, block_rows=BLOCK, mode="approx")._vectors_aug


def _aug_bytes(ix):
    """The bytes of an index's augmented layout (0 without one): the port
    counts them under "vectors", the reference nowhere."""
    aug = getattr(ix, "_vectors_aug", None)
    return 0 if aug is None else aug.numel() * aug.element_size()


def test_arena_from_reference_keeps_dtype_and_aug(worlds):
    """The port's arena keeps the reference's storage dtype and its
    bfloat16 rows bit for bit; the augmented layout FlatIndex builds for
    the whole arena in approx mode is the reference arena's bit for bit,
    and none on l1."""
    for a in ARENAS:
        ra = worlds["arenas"][a]
        pa = arena_from_reference(ra, "cpu")
        assert pa.vectors.dtype == getattr(torch, a[1])
        np.testing.assert_array_equal(
            pa.vectors.to(torch.float32).numpy(),
            np.asarray(ra.vectors).astype(np.float32))
        aug = _aug(pa)
        assert (aug is None) == (ra.vectors_aug is None) == (a[2] == "l1")
        if aug is not None:
            assert aug.dtype == pa.vectors.dtype
            np.testing.assert_array_equal(
                aug.to(torch.float32).numpy(),
                np.asarray(ra.vectors_aug).astype(np.float32))
        np.testing.assert_array_equal(pa.host_norms, ra.host_norms)


def test_build_device_arena_matches_reference(worlds):
    """build_device_arena on its own: bfloat16 l1 and float32 cosine
    arenas from the port's own corpus copy equal the reference's; l1
    refuses int8 as the reference does."""
    w = worlds
    pc = synthetic_corpus(num_docs=200, blocks_per_doc=8, dim=48, seed=4)
    for dtype, metric in (("bfloat16", "l1"), ("float32", "cosine")):
        want = ref_arena(w["corpora"]["synthetic"], w["rw"],
                         block_rows=BLOCK, dtype=dtype, metric=metric)
        got = port.build_device_arena(pc, w["pw"], device="cpu",
                                      block_rows=BLOCK, dtype=dtype,
                                      metric=metric)
        assert torch.equal(got.vectors,
                           arena_from_reference(want, "cpu").vectors)
        assert (_aug(got) is None) == (want.vectors_aug is None)
        np.testing.assert_array_equal(got.host_bits, want.host_bits)
    with pytest.raises(ValueError, match="l1"):
        port.build_device_arena(pc, w["pw"], device="cpu", dtype="int8",
                                metric="l1")
    with pytest.raises(AssertionError):
        ref_arena(w["corpora"]["synthetic"], w["rw"], dtype="int8",
                  metric="l1")


def test_approx_min_k_is_exact_on_the_cpu(worlds):
    """The premise of comparing approx modes: on the CPU the reference's
    approx scan returns its exact scan's results."""
    w = worlds
    ra = w["arenas"][("sift", "float32", "l2")]
    args = (jnp.asarray(w["q"]["sift"]), ra.vectors, ra.norms, ra.role_bits,
            jnp.asarray(_masks(w)), K, BLOCK)
    de, ie = ref_scan(*args, "exact")
    da, ia = ref_scan(*args, "approx", 0.5)
    np.testing.assert_array_equal(np.asarray(ia), np.asarray(ie))
    np.testing.assert_array_equal(np.asarray(da), np.asarray(de))


@pytest.mark.parametrize("mode", ["exact", "approx"])
@pytest.mark.parametrize("subset", [False, True], ids=["arena", "rows"])
@pytest.mark.parametrize("arena", ARENAS, ids=_id)
def test_flat_index_matches_reference(worlds, arena, subset, mode):
    """FlatIndex over the whole arena or a row subset (a physical
    partition: a bucket-padded row map, arena ids back), exact and approx
    (the augmented layout on every metric but l1): the reference's
    distances and ids; storage counted as the reference counts it."""
    w = worlds
    ra = w["arenas"][arena]
    rows = (np.flatnonzero(np.random.default_rng(6).random(ra.n) < 0.4)
            if subset else None)
    want_ix = RefFlatIndex(ra, rows, block_rows=BLOCK, mode=mode,
                           query_batch=16)
    got_ix = FlatIndex(arena_from_reference(ra, "cpu"), rows,
                       block_rows=BLOCK, mode=mode, query_batch=16)
    q, m = w["q"][arena[0]], _masks(w)
    want = want_ix.search(q, m, K)
    got = got_ix.search(q, m, K)
    assert_same_topk(got, want)
    assert (got[1] >= 0).sum() > 0.5 * got[1].size
    if subset:
        assert set(got[1][got[1] >= 0]) <= set(rows)
    want_sb = dict(want_ix.storage_bytes())
    want_sb["vectors"] += _aug_bytes(got_ix)
    assert got_ix.storage_bytes() == want_sb


def test_flat_index_partition_dtype(worlds):
    """A partition of a bfloat16 arena keeps the arena's dtype (the
    reference's default, dtype=None) and its results; the reference's
    `dtype` option is not carried."""
    w = worlds
    ra = w["arenas"][("synthetic", "bfloat16", "l1")]
    rows = np.arange(0, ra.n, 3)
    want_ix = RefFlatIndex(ra, rows, block_rows=BLOCK)
    pa = arena_from_reference(ra, "cpu")
    got_ix = FlatIndex(pa, rows, block_rows=BLOCK)
    assert got_ix._vectors.dtype == torch.bfloat16
    with pytest.raises(TypeError):
        FlatIndex(pa, rows, block_rows=BLOCK, dtype="float32")
    q, m = w["q"]["synthetic"], _masks(w)
    assert_same_topk(got_ix.search(q, m, K), want_ix.search(q, m, K))
    assert got_ix.storage_bytes() == want_ix.storage_bytes()


@pytest.mark.parametrize("arena", [a for a in ARENAS if a[2] != "l1"],
                         ids=_id)
def test_aug_scan_matches_plain_scan(worlds, arena):
    """The augmented scan against the plain scan on the same arena: the
    same ids, distances within the norm's hi/lo split."""
    w = worlds
    pa = arena_from_reference(w["arenas"][arena], "cpu")
    aug = augment_with_norms(pa.vectors.to(torch.float32), pa.norms).to(
        pa.vectors.dtype)
    q = torch.from_numpy(w["q"][arena[0]])
    m = torch.from_numpy(_masks(w).view(np.int32))
    got = masked_scan_topk_aug(q, aug, pa.role_bits, m, K, BLOCK,
                               metric=pa.metric)
    want = masked_scan_topk(q, pa.vectors, pa.norms, pa.role_bits, m, K,
                            BLOCK, metric=pa.metric)
    assert_same_topk([t.numpy() for t in got], [t.numpy() for t in want])
    with pytest.raises(ValueError, match="l1"):
        masked_scan_topk_aug(q, aug, pa.role_bits, m, K, BLOCK,
                             metric="l1")


def test_l1_scan_against_numpy(worlds):
    """The l1 scan's top-k against a float64 numpy recomputation."""
    w = worlds
    pa = arena_from_reference(w["arenas"][("synthetic", "float32", "l1")],
                              "cpu")
    q, m = w["q"]["synthetic"], _masks(w)
    d, i = FlatIndex(pa, block_rows=BLOCK).search(q, m, K)
    x = pa.host_vectors[:pa.n].astype(np.float64)
    ok = (pa.host_bits[:pa.n, None, :] & m[None]).any(axis=2)   # (N, Q)
    for qi in range(NQ):
        dist = np.abs(x - q[qi]).sum(axis=1)
        dist[~ok[:, qi]] = np.inf
        want = np.sort(dist)[:K]
        np.testing.assert_allclose(d[qi], want, rtol=RTOL)
        np.testing.assert_allclose(dist[i[qi]], d[qi], rtol=RTOL)


@pytest.mark.parametrize("kind", ["flat", "flat_approx", "binary"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_partition_index_kinds(worlds, kind, dtype):
    """make_partition_index builds the reference's index kind over a row
    subset on float32 and bfloat16 arenas, with its ids."""
    w = worlds
    ra = w["arenas"][("sift", dtype, "l2")]
    rows = np.arange(1, ra.n, 2)
    rcfg, pcfg = _cfgs(kind)
    want_ix = ref_base.make_partition_index(ra, rows, rcfg)
    got_ix = make_partition_index(arena_from_reference(ra, "cpu"), rows,
                                  pcfg)
    assert type(got_ix).__name__ == type(want_ix).__name__
    if kind != "binary":
        assert got_ix.mode == want_ix.mode
    q, m = w["q"]["sift"], _masks(w)
    assert_same_topk(got_ix.search(q, m, K), want_ix.search(q, m, K))
    want_sb = dict(want_ix.storage_bytes())
    want_sb["vectors"] += _aug_bytes(got_ix)
    assert got_ix.storage_bytes() == want_sb


@pytest.mark.parametrize("name,arena", [
    (name, a) for a in [("sift", "float32", "l2"), ("sift", "bfloat16", "l2"),
                        ("synthetic", "float32", "l1")]
    for name in ("role", "user")] + [("dynamic", ("sift", "float32", "l2"))],
    ids=lambda v: v if isinstance(v, str) else _id(v))
def test_unpacked_strategies_match_reference(worlds, name, arena):
    """ROLE, USER and AnonySys (the port's planner) in the packed=False
    layout, a FlatIndex a partition in approx mode: the reference's ids,
    every row readable by its user."""
    w = worlds
    ra = w["arenas"][arena]
    rcfg, pcfg = _cfgs("flat_approx")
    corpus = w["corpora"][arena[0]]
    pc = port.Corpus(vectors=corpus.vectors, doc_ids=corpus.doc_ids,
                     block_ids=corpus.block_ids)
    pa = arena_from_reference(ra, "cpu")
    want_s = ref_searcher(name, corpus, w["rw"], ra, rcfg, packed=False) \
        if name == "dynamic" else ref_strategies.STRATEGIES[name](
            corpus, w["rw"], ra, rcfg, packed=False)
    got_s = build_searcher(name, pc, w["pw"], pa, pcfg, packed=False) \
        if name == "dynamic" else strategies.STRATEGIES[name](
            pc, w["pw"], pa, pcfg, packed=False)
    assert not isinstance(got_s, PackedSearcher)
    assert sorted(got_s.partitions) == sorted(want_s.partitions)
    q = w["q"][arena[0]]
    want = want_s.search_batch(q, w["users"], w["rw"].user_masks, K)
    got = got_s.search_batch(q, w["users"], w["pw"].user_masks, K)
    assert_same_topk(got, want)
    assert_readable(pc, w["pw"], got[1], w["users"])
    want_mb, got_mb = want_s.storage_report(), got_s.storage_report()
    aug_mb = sum(_aug_bytes(p.index) for p in got_s.partitions.values()) \
        / 2**20
    assert (aug_mb > 0) == (arena[2] != "l1")
    for key in ("partition_vectors_mb", "total_mb"):
        want_mb[key] += aug_mb
    assert {k: got_mb[k] for k in want_mb} == pytest.approx(want_mb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_role_on_l1_packed_matches_unpacked(worlds, dtype):
    """ROLE on an l1 arena through the PackedSearcher (the probed scan's
    l1 form; the reference's ranks by squared L2) returns the ids of
    ROLE's packed=False layout, a FlatIndex a partition."""
    w = worlds
    pa = arena_from_reference(w["arenas"][("synthetic", dtype, "l1")], "cpu")
    corpus = w["corpora"]["synthetic"]
    pc = port.Corpus(vectors=corpus.vectors, doc_ids=corpus.doc_ids,
                     block_ids=corpus.block_ids)
    _, pcfg = _cfgs("flat")
    packed = build_searcher("role", pc, w["pw"], pa, pcfg)
    unpacked = strategies.build_role_searcher(pc, w["pw"], pa, pcfg,
                                              packed=False)
    assert isinstance(packed, PackedSearcher)
    q = w["q"]["synthetic"]
    got = packed.search_batch(q, w["users"], w["pw"].user_masks, K)
    want = unpacked.search_batch(q, w["users"], w["pw"].user_masks, K)
    assert_same_topk(got, want)
    assert_readable(pc, w["pw"], got[1], w["users"])


def test_qdtree_on_l1_routes_with_l2_radius(worlds):
    """QDTree on an l1 arena routes with the reference's L2 route radius
    and serves readable rows through the PackedSearcher."""
    w = worlds
    corpus = w["corpora"]["synthetic"]
    pc = port.Corpus(vectors=corpus.vectors, doc_ids=corpus.doc_ids,
                     block_ids=corpus.block_ids)
    q = w["q"]["synthetic"]
    docsets = [w["rw"].user_docs(int(u)) for u in w["users"]]
    kw = dict(min_leaf=16, max_depth=6, seed=0)
    got = qdtree.build_qd_tree(pc, w["pw"], docsets, query_vecs=q,
                               metric="l1", **kw)
    want = ref_qdtree.build_qd_tree(corpus, w["rw"], docsets, query_vecs=q,
                                    **kw)
    assert got.route_radius == pytest.approx(want.route_radius, rel=1e-6)
    pa = arena_from_reference(w["arenas"][("synthetic", "float32", "l1")],
                              "cpu")
    _, pcfg = _cfgs("flat")
    s = build_searcher("qdtree", pc, w["pw"], pa, pcfg, tree=got)
    assert isinstance(s, PackedSearcher)
    _, ids = s.search_batch(q, w["users"], w["pw"].user_masks, K)
    assert (ids >= 0).any()
    assert_readable(pc, w["pw"], ids, w["users"])


def test_binary_index_on_bf16_arena_reranks_from_the_arena(worlds):
    """The binary index on a bfloat16 arena reranks from the arena's
    bfloat16 rows: the reference's ids and distances."""
    from vectorsearch_rbac_tpu.index.binary import (
        BinaryQuantIndex as RefBinary)
    w = worlds
    ra = w["arenas"][("synthetic", "bfloat16", "cosine")]
    want_ix = RefBinary(ra, block_rows=BLOCK, query_batch=16)
    got_ix = BinaryQuantIndex(arena_from_reference(ra, "cpu"),
                              block_rows=BLOCK, query_batch=16)
    q, m = w["q"]["synthetic"], _masks(w)
    assert_same_topk(got_ix.search(q, m, K), want_ix.search(q, m, K))


def test_ivf_refuses_l1(worlds):
    """IVF keeps the reference's refusal of l1 (pgvector's ivfflat has no
    l1 opclass)."""
    from vectorsearch_rbac_tpu.index.ivf import IVFIndex as RefIVF
    from vectorsearch_rbac_tpu_torch.index.ivf import IVFIndex

    ra = worlds["arenas"][("synthetic", "float32", "l1")]
    with pytest.raises(AssertionError):
        RefIVF(ra, nlist=4)
    with pytest.raises(ValueError, match="l1"):
        IVFIndex(arena_from_reference(ra, "cpu"), nlist=4)
