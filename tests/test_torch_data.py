"""The port's data layer against the JAX reference's on the CPU: the
dataset-file readers on tiny files the test writes (ann-benchmarks HDF5,
the SIFT10M .mat, .npy/.npz embedding dumps with and without a queries
file, arXiv's JSON-lines metadata) and resolve_dataset over them, the
HashingEmbedder and the text ingestion (bit-equal), and the query
workloads (query_dataset.json byte-equal, the role-targeted generator
equal)."""

import json

import numpy as np
import pytest

import vectorsearch_rbac_tpu.data as ref_data
from vectorsearch_rbac_tpu.bench import queries as ref_queries
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu_torch import data
from vectorsearch_rbac_tpu_torch.bench import queries
from vectorsearch_rbac_tpu_torch.rbac import TreeRBACGenerator


def assert_same_corpus(got, want):
    (gc, gq), (wc, wq) = got, want
    for f in ("vectors", "doc_ids", "block_ids"):
        np.testing.assert_array_equal(getattr(gc, f), getattr(wc, f))
    np.testing.assert_array_equal(gq, wq)


def _rows(n, d, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, d)).astype(
        np.float32)


def test_hdf5_readers_match_reference(tmp_path):
    h5py = pytest.importorskip("h5py")
    sift = tmp_path / "sift-128-euclidean.hdf5"
    with h5py.File(sift, "w") as f:
        f["train"] = _rows(1000, 16, 0)
        f["test"] = _rows(30, 16, 1)
    mat = tmp_path / "SIFT10Mfeatures.mat"
    with h5py.File(mat, "w") as f:
        f["fea"] = _rows(12_000, 8, 2).T     # MATLAB's column-major layout
    for kw in (dict(), dict(max_vectors=500, blocks_per_doc=10)):
        assert_same_corpus(data.load_sift_hdf5(str(sift), **kw),
                           ref_data.load_sift_hdf5(str(sift), **kw))
    for kw in (dict(), dict(max_vectors=1500)):
        assert_same_corpus(data.load_sift10m(str(mat), **kw),
                           ref_data.load_sift10m(str(mat), **kw))
    for name, path in (("sift1m", str(tmp_path)), ("sift", str(sift)),
                       ("sift10m", str(tmp_path))):
        assert_same_corpus(
            data.resolve_dataset(name, dataset_path=path, num_vectors=800),
            ref_data.resolve_dataset(name, dataset_path=path,
                                     num_vectors=800))


def test_embedding_dumps_match_reference(tmp_path):
    vecs = np.random.default_rng(3).standard_normal((600, 24)).astype(
        np.float32)
    np.save(tmp_path / "cohere.npy", vecs)
    np.savez(tmp_path / "dump.npz", embeddings=vecs[:300], other=vecs[:2])
    np.save(tmp_path / "q.npy", vecs[:400])
    np.save(tmp_path / "q_queries.npy", vecs[400:420])
    for path, kw in ((tmp_path / "cohere.npy", {}),
                     (tmp_path / "dump.npz", dict(blocks_per_doc=3)),
                     (tmp_path / "q.npy", dict(max_vectors=100)),
                     (tmp_path / "cohere.npy", dict(query_holdout=7))):
        assert_same_corpus(data.load_embedding_dump(str(path), **kw),
                           ref_data.load_embedding_dump(str(path), **kw))
    for name, path in (("cohere", str(tmp_path)),
                       ("wikipedia", str(tmp_path / "dump.npz"))):
        assert_same_corpus(
            data.resolve_dataset(name, dataset_path=path, num_vectors=200),
            ref_data.resolve_dataset(name, dataset_path=path,
                                     num_vectors=200))
    with pytest.raises(ValueError, match="unsupported"):
        data.load_embedding_dump(str(tmp_path / "x.csv"))
    with pytest.raises(ValueError, match="unknown dataset"):
        data.resolve_dataset("imagenet")


def test_arxiv_categories_match_reference(tmp_path):
    path = tmp_path / "arxiv.json"
    cats = ["cs.LG stat.ML", "math.CO", "cs.LG", "hep-th cs.LG",
            "math.CO", None]
    with open(path, "w") as f:
        for c in cats:
            f.write(json.dumps({} if c is None else {"categories": c}))
            f.write("\n\n")
    for kw in (dict(), dict(max_docs=4)):
        np.testing.assert_array_equal(
            data.load_arxiv_categories(str(path), **kw),
            ref_data.load_arxiv_categories(str(path), **kw))


TEXTS = ["Role based access control for vector search over document "
         "blocks, with partitions planned under a storage budget. " * 9,
         "", "a b c",
         "Zipf skewed categories; HNSW graphs and IVF lists " * 30]


def test_hashing_embedder_and_ingest_match_reference():
    for kw in (dict(), dict(dim=64, seed=5)):
        np.testing.assert_array_equal(
            data.HashingEmbedder(**kw).embed(TEXTS),
            ref_data.HashingEmbedder(**kw).embed(TEXTS))
    for kw in (dict(), dict(words_per_block=16, max_blocks_per_doc=3),
               dict(embedder=data.HashingEmbedder(dim=32, seed=2))):
        ref_kw = dict(kw)
        if "embedder" in kw:
            ref_kw["embedder"] = ref_data.HashingEmbedder(dim=32, seed=2)
        got = data.ingest_text_corpus(TEXTS, **kw)
        want = ref_data.ingest_text_corpus(TEXTS, **ref_kw)
        for f in ("vectors", "doc_ids", "block_ids"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.fixture(scope="module")
def world_and_corpus():
    kw = dict(num_users=60, num_roles=12, num_docs=80, h=3, b0=2, b1=3,
              seed=4)
    corpus = data.synthetic_corpus(80, 5, 16, seed=1)
    ref_corpus = ref_data.synthetic_corpus(80, 5, 16, seed=1)
    return (TreeRBACGenerator(**kw).generate(), corpus,
            RefTreeGenerator(**kw).generate(), ref_corpus)


@pytest.mark.parametrize("kw", [
    dict(num_queries=25), dict(num_queries=9, repetitions=3, zipf_param=0),
    dict(num_queries=12, topk=4, query_pool="pool")])
def test_query_dataset_json_matches_reference(kw, world_and_corpus,
                                              tmp_path):
    world, corpus, ref_world, ref_corpus = world_and_corpus
    kw = dict(kw)
    if kw.get("query_pool") == "pool":
        kw["query_pool"] = np.random.default_rng(7).standard_normal(
            (50, 16)).astype(np.float32)
    got = queries.generate_query_workload(corpus, world, seed=3, **kw)
    want = ref_queries.generate_query_workload(ref_corpus, ref_world,
                                               seed=3, **kw)
    got.save_json(str(tmp_path / "a.json"))
    want.save_json(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    back = queries.QueryWorkload.load_json(str(tmp_path / "b.json"))
    ref_back = ref_queries.QueryWorkload.load_json(str(tmp_path / "a.json"))
    for f in ("vectors", "user_ids", "selectivities", "repetitions"):
        np.testing.assert_array_equal(getattr(back, f), getattr(got, f))
        np.testing.assert_array_equal(getattr(back, f),
                                      getattr(ref_back, f))
    assert back.topk == got.topk == ref_back.topk


@pytest.mark.parametrize("kw", [
    dict(), dict(queries_per_role=3, repetitions=2),
    dict(roles=np.array([0, 5, 7]), queries_per_role=4, query_pool="pool")])
def test_role_targeted_workload_matches_reference(kw, world_and_corpus):
    world, corpus, ref_world, ref_corpus = world_and_corpus
    kw = dict(kw)
    if kw.get("query_pool") == "pool":
        kw["query_pool"] = np.random.default_rng(8).standard_normal(
            (5, 16)).astype(np.float32)
    got = queries.generate_query_workload_for_roles(corpus, world, seed=2,
                                                    **kw)
    want = ref_queries.generate_query_workload_for_roles(
        ref_corpus, ref_world, seed=2, **kw)
    for f in ("vectors", "user_ids", "selectivities", "repetitions"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    held = [set(world.user_to_roles[int(u)]) for u in got.user_ids]
    assert all(held)
