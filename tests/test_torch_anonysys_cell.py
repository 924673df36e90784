"""HoneyBee's own deployment, the benchmark's `sift10m-tree100-anonysys`
configuration, cut to a CPU size: the port's AnonySys searcher (the
planner at storage budget 2.0, top-10, the TiledSearcher's big tier and
chunk engine, the host fan-out merge) over the benchmark's own generators
(`rbacbench/corpora`, `worlds`, `traffic`), judged against
`rbacbench/reference.py`'s exact filtered top-k.

The int8 codes of integer features are lossless, so every distance the
searcher returns is the row's exact squared L2. A big-tier partition keeps
one row a group of `group` consecutive rows of its own order (the group
minima) before its top-k; the chunk engine's partitions here are small
enough to keep every row. So each answer must be the exact top-k of those
candidates, and equals the reference's top-k wherever no two of a query's
nearest rows share a group."""

import copy

import numpy as np
import pytest
import torch

from rbacbench import reference
from rbacbench.manifest import generator, load_cell
from vectorsearch_rbac_tpu_torch.utils import tracing

DOCS = 2000          # one big-tier partition, the rest in the chunk engine
QUERIES = 512
SEED = 2**31 + 2601


@pytest.fixture(scope="module")
def cell():
    """The configuration's corpus, world, one call of its traffic and the
    port's searcher, built as the benchmark's `searcher` entry builds it,
    on one torch thread."""
    from vectorsearch_rbac_tpu_torch.core import Corpus, build_device_arena
    from vectorsearch_rbac_tpu_torch.partition import build_searcher
    from vectorsearch_rbac_tpu_torch.rbac import RBACWorld
    from rbacbench import port

    spec = load_cell("sift10m-anonysys-bulk")
    cfg = copy.deepcopy(spec.config)
    cfg["corpus"].update(num_vectors=DOCS * 100 - 34, query_pool=2000)
    cfg["world"].update(num_users=1000)
    cfg["port"]["arena"]["block_rows"] = 4096
    mix = dict(spec.mix, queries_per_call=QUERIES, distinct_calls=1)
    dev = torch.device("cpu")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        corpus = generator("corpora", "sift_like").make(cfg["corpus"], SEED,
                                                        dev)
        world = generator("worlds", cfg["world"]["kind"]).make(
            cfg["world"], corpus.num_docs, SEED + 1)
        ((queries, users),) = generator("traffic", "closed_loop").bank(
            mix, corpus.pool, world.num_users,
            np.random.SeedSequence([SEED, 2]))
        pcorpus = Corpus(vectors=corpus.rows.astype(np.float32),
                         doc_ids=corpus.doc_ids, block_ids=corpus.block_ids)
        pworld = RBACWorld(num_users=world.num_users,
                           num_roles=world.num_roles,
                           num_docs=world.num_docs,
                           user_to_roles=world.user_to_roles,
                           role_to_docs=world.role_to_docs)
        arena = build_device_arena(pcorpus, pworld, device=dev,
                                   metric=cfg["metric"],
                                   **cfg["port"]["arena"])
        searcher = build_searcher(
            cfg["port"]["strategy"], pcorpus, pworld, arena,
            port.framework_config(cfg["port"]["framework"]))
        tracing.reset_counts()
        dists, ids = searcher.search_batch(queries, users, pworld.user_masks,
                                           int(mix["k"]))
        counts = dict(tracing.COUNTS)
    finally:
        torch.set_num_threads(prev)
    return dict(corpus=corpus, world=world, queries=queries, users=users,
                searcher=searcher, dists=dists, ids=ids, counts=counts,
                k=int(mix["k"]))


def _readable(c, rows, user):
    bits = c["world"].doc_role_bits[c["corpus"].doc_ids[rows]]
    return (bits & c["world"].user_masks[user]).any(axis=-1)


def test_both_tiers_hold_a_partition(cell):
    s = cell["searcher"]
    assert cell["k"] == 10
    assert len(s._big) >= 1 and len(s.part_chunks) >= 1
    # the chunk engine keeps every row of these partitions (group 0)
    assert all(s._adapt_scan_group([pid]) == 0 for pid in s.part_chunks)


def test_answers_are_readable_distinct_and_exact(cell):
    c, k = cell, cell["k"]
    rows = torch.from_numpy(c["corpus"].rows)
    for qi in range(QUERIES):
        got = c["ids"][qi][c["ids"][qi] >= 0]
        assert len(set(got.tolist())) == len(got)
        assert _readable(c, got, c["users"][qi]).all()
    valid = c["ids"] >= 0
    exact = reference.metric("l2").exact(
        rows, torch.from_numpy(c["queries"]),
        torch.from_numpy(c["ids"])).numpy()
    assert np.array_equal(c["dists"][valid], exact[valid].astype(np.float64))
    assert np.isinf(c["dists"][~valid]).all()
    assert valid.sum() == QUERIES * k    # every user reads >= k rows here


def _candidates(c, qi, dist_row):
    """The rows the query's partitions keep before their top-k: in a
    big-tier partition the nearest readable row of each group of its row
    order (the lowest lane on a tie), in a chunk-engine one every readable
    row."""
    s = c["searcher"]
    user = c["users"][qi]
    out = set()
    for pid in s.router(int(user)):
        if pid in s._big:
            idx8 = s._big[pid]
            order = idx8._row_map[:idx8.n_rows].numpy().astype(np.int64)
            g = idx8.group
            pad = -len(order) % g
            d = np.where(_readable(c, order, user), dist_row[order], np.inf)
            d = np.concatenate([d, np.full(pad, np.inf)]).reshape(-1, g)
            best = d.argmin(axis=1)
            keep = np.isfinite(d[np.arange(len(d)), best])
            out.update(order[(np.arange(len(d)) * g + best)[keep]].tolist())
        elif pid in s.part_chunks:
            rows = s._rowC[s.part_chunks[pid]].reshape(-1).numpy()
            rows = rows[rows >= 0].astype(np.int64)
            out.update(rows[_readable(c, rows, user)].tolist())
    return np.fromiter(out, dtype=np.int64, count=len(out))


def test_top10_is_the_exact_top10_of_the_partitions_candidates(cell):
    """Every answer's distances are the k smallest of the candidates its
    partitions keep, and equal the reference's top-10 on all but the
    queries where two near rows shared a group."""
    c, k = cell, cell["k"]
    rows = torch.from_numpy(c["corpus"].rows).to(torch.float32)
    l2 = reference.metric("l2")
    norms = l2.norms(rows)
    doc_of_row = torch.from_numpy(c["corpus"].doc_ids.astype(np.int64))
    doc_bits = torch.from_numpy(c["world"].doc_role_bits.view(np.int32))
    ref_d, _, _ = reference.filtered_topk(
        torch.from_numpy(c["corpus"].rows), doc_of_row, doc_bits,
        c["world"].user_masks[c["users"]], c["queries"], k, "l2")
    differ = 0
    with reference.tf32_off():
        for q0 in range(0, QUERIES, 64):
            d_all = l2.pairwise(torch.from_numpy(c["queries"][q0:q0 + 64]),
                                rows, norms).numpy()
            for j, dist_row in enumerate(d_all):
                qi = q0 + j
                cand = _candidates(c, qi, dist_row)
                want = np.sort(dist_row[cand])[:k]
                assert np.array_equal(c["dists"][qi], want), qi
                differ += not np.array_equal(c["dists"][qi], ref_d[qi])
    # C(10, 2) * group / rows of a big partition: a few in a hundred
    assert differ <= QUERIES // 20


def test_counters_of_one_call(cell):
    """tiled.queries is the call's queries, tiled.probes the router's
    fan-out summed over them, tiled.big_searches the big-tier partitions
    routed to, and the chunk engine's slots and dispatches are those its
    routed queries fill."""
    s, counts = cell["searcher"], cell["counts"]
    routed = [s.router(int(u)) for u in cell["users"]]
    assert counts["tiled.queries"] == QUERIES
    assert counts["tiled.probes"] == sum(len(r) for r in routed)
    assert counts["tiled.big_searches"] == len(
        {p for r in routed for p in r if p in s._big})
    per_pid = {}
    for r in routed:
        for p in r:
            if p in s.part_chunks:
                per_pid[p] = per_pid.get(p, 0) + 1
    assert counts["tiled.slots"] == sum(-(-n // s.q_tile)
                                        for n in per_pid.values())
    assert 1 <= counts["tiled.chunk_dispatches"] <= counts["tiled.slots"]
