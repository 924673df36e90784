"""The port's online maintenance against the JAX reference on the CPU: the
HNSW insert, refine and delete (the native edge update, the graph repair),
the IVF insert and delete, and the AnonySys role insert and delete with
the plan update on the device.

Both packages start from the same state (the port's arena through
arena_from_reference, its graph through the reference index's
graph_state, its IVF lists through ivf_from_reference, its plan through
plan_from_reference) and take the same steps; after each step the host
mirrors, the device tensors, the IVF lists and the plans must be equal,
and the searches return the same ids (ties as sets, the ROADMAP tie
rule). The graph data is tests/test_torch_graph.py's (SIFT-like integer
rows on an int8 arena), where the fixed beam that finds an insert's
candidates returns the reference's ids exactly."""

import numpy as np
import pytest
import torch

from vectorsearch_rbac_tpu.core import build_device_arena as ref_arena
from vectorsearch_rbac_tpu.data import sift_like_corpus as ref_corpus
from vectorsearch_rbac_tpu.data import synthetic_corpus as ref_synthetic
from vectorsearch_rbac_tpu.index.hnsw import HNSWIndex as RefHNSWIndex
from vectorsearch_rbac_tpu.index.ivf import IVFIndex as RefIVFIndex
from vectorsearch_rbac_tpu.models.cost import (
    CostModelParams as RefCostModelParams)
from vectorsearch_rbac_tpu.partition import build_searcher as ref_searcher
from vectorsearch_rbac_tpu.partition.dynamic import (
    PlannerInputs as RefPlannerInputs)
from vectorsearch_rbac_tpu.partition.dynamic import (
    apply_plan_update as ref_apply_plan_update)
from vectorsearch_rbac_tpu.partition.dynamic import (
    choose_partition_for_new_role as ref_choose)
from vectorsearch_rbac_tpu.partition.dynamic import delete_role as ref_delete
from vectorsearch_rbac_tpu.partition.dynamic import insert_role as ref_insert
from vectorsearch_rbac_tpu.partition.dynamic import (
    plan_dynamic_partitions as ref_plan)
from vectorsearch_rbac_tpu.partition.dynamic.maintenance import (
    orphaned_docs_after_role_delete as ref_orphan_docs)
from vectorsearch_rbac_tpu.partition.dynamic.maintenance import (
    orphaned_rows_after_role_delete as ref_orphan_rows)
from vectorsearch_rbac_tpu.rbac.generators import (
    TreeRBACGenerator as RefTreeGenerator)
from vectorsearch_rbac_tpu.utils.config import (
    FrameworkConfig as RefFrameworkConfig)
from vectorsearch_rbac_tpu_torch import arena_from_reference, build_searcher
from vectorsearch_rbac_tpu_torch.config import FrameworkConfig
from vectorsearch_rbac_tpu_torch.index.flat import FlatIndex
from vectorsearch_rbac_tpu_torch.index.hnsw import HNSWIndex
from vectorsearch_rbac_tpu_torch.index.ivf import ivf_from_reference
from vectorsearch_rbac_tpu_torch.models.cost import CostModelParams
from vectorsearch_rbac_tpu_torch.partition.dynamic import (
    PlannerInputs, apply_plan_update, choose_partition_for_new_role,
    delete_role, insert_role, orphaned_docs_after_role_delete,
    orphaned_rows_after_role_delete, plan_from_reference)
from vectorsearch_rbac_tpu_torch.partition.packed import PackedSearcher
from vectorsearch_rbac_tpu_torch.partition.tiled import TiledSearcher
from vectorsearch_rbac_tpu_torch.rbac import RBACWorld
from test_torch_ivf import assert_same_topk

WORLD = dict(num_users=80, num_roles=16, num_docs=60, h=3, b0=2, b1=2,
             seed=5)
CORPUS = dict(num_vectors=3000, dim=32, blocks_per_doc=50, seed=4)
M, NQ, K, EF = 8, 48, 12, 24


@pytest.fixture(autouse=True)
def one_thread():
    """torch's CPU ops on one thread: the graph searches run many small
    ops, which stall on a contended intra-op pool when other test workers
    share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---- HNSW: insert, refine, delete on a graph carried from the reference

HNSW_STEPS = ("insert_grows_to_2048", "insert_grows_to_4096", "refine",
              "delete", "double_delete", "refine_after_delete",
              "insert_after_delete")


def _hnsw_state(ix):
    return dict(hgraph=ix._hgraph.copy(), hrmap=ix._hrmap.copy(),
                graph=np.asarray(ix._graph).copy(),
                row_map=np.asarray(ix._row_map).copy(), entry=int(ix.entry),
                n_rows=int(ix.n_rows),
                deleted=(ix._deleted_local.copy()
                         if hasattr(ix, "_deleted_local") else None))


@pytest.fixture(scope="module")
def hnsw_run():
    """The reference's and the port's index through HNSW_STEPS, each from
    the same graph over rows [0, 900) (npad 1024): the state and a
    sampled-entry search after every step."""
    torch.set_num_threads(1)
    world = RefTreeGenerator(**WORLD).generate()
    corpus, _ = ref_corpus(**CORPUS)
    ra = ref_arena(corpus, world, block_rows=1024, dtype="int8")
    pa = arena_from_reference(ra, "cpu")
    ref = RefHNSWIndex(ra, np.arange(900), m=M, ef_construction=32,
                       ef_search=EF, builder="classic", logical=True)
    mine = HNSWIndex(pa, np.arange(900), m=M, ef_search=EF,
                     graph_state=ref.graph_state())
    rng = np.random.default_rng(9)
    q = rng.integers(0, 256, (NQ, corpus.dim)).astype(np.float32)
    masks = world.user_masks[rng.integers(0, world.num_users, NQ)]
    new = np.arange(900, 2200)
    # the entry's row among the deleted: the entry moves
    dels = np.union1d(rng.choice(2200, 150, replace=False),
                      [ref._hrmap[ref.entry]])
    steps = {
        "insert_grows_to_2048": lambda ix, a: ix.insert_rows(
            a, np.arange(900, 1100)),
        "insert_grows_to_4096": lambda ix, a: ix.insert_rows(
            a, np.arange(1100, 2200)),
        "refine": lambda ix, a: ix.refine_rows(a, new),
        "delete": lambda ix, a: ix.delete_rows(a, dels),
        "double_delete": lambda ix, a: ix.delete_rows(a, dels),
        "refine_after_delete": lambda ix, a: ix.refine_rows(a, new),
        "insert_after_delete": lambda ix, a: ix.insert_rows(
            a, np.arange(2200, 2600)),
    }
    out = {}
    for name in HNSW_STEPS:
        got = steps[name](mine, pa)
        want = steps[name](ref, ra)
        out[name] = dict(
            ret=(got, want), state=(_hnsw_state(mine), _hnsw_state(ref)),
            search=(mine.search(q, masks, K, sampled_entry=True),
                    ref.search(q, masks, K, sampled_entry=True)),
            sample=(mine._entry_sample[0].copy(),
                    np.asarray(ref._entry_sample[0])))
    return out, dels


@pytest.mark.parametrize("step", HNSW_STEPS)
def test_hnsw_maintenance_matches_reference(hnsw_run, step):
    """After each step the host mirrors (graph, row map, deleted nodes),
    the device graph and row map, the entry and the node count equal the
    reference's; the sampled-entry search returns its ids."""
    run, dels = hnsw_run
    got, want = run[step]["state"]
    for key in ("hgraph", "hrmap", "graph", "row_map"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["entry"] == want["entry"] and got["n_rows"] == want["n_rows"]
    if want["deleted"] is None:      # the reference's array comes at the
        assert not got["deleted"].any()     # first delete
    else:
        np.testing.assert_array_equal(got["deleted"], want["deleted"])
    np.testing.assert_array_equal(got["graph"], got["hgraph"])
    assert_same_topk(*run[step]["search"])
    assert run[step]["ret"][0] == run[step]["ret"][1]
    if step == "double_delete":
        assert run[step]["ret"][0] == 0
    if step == "delete":
        assert run[step]["ret"][0] == len(dels)


def test_hnsw_delete_state(hnsw_run):
    """After the delete: the graph grew across two buckets, the deleted
    nodes have empty lists and row map -1, no live list holds one, the
    sampled entries draw only live nodes (the reference's :904-905), and
    no search returns a deleted row."""
    run, dels = hnsw_run
    for step in HNSW_STEPS[3:]:
        st = run[step]["state"][0]
        dead = np.flatnonzero(st["deleted"])
        assert len(dead) == len(dels) and st["hgraph"].shape[0] == 4096
        assert (st["hgraph"][dead] < 0).all()
        assert (st["hrmap"][dead] == -1).all()
        assert not np.isin(st["hgraph"][~st["deleted"]], dead).any()
        assert not np.isin(run[step]["sample"][0], dead).any()
        np.testing.assert_array_equal(*run[step]["sample"])
        assert not np.isin(run[step]["search"][0][1], dels).any()


# ---- IVF: insert with growth, delete, insert into the freed slots

IVF_STEPS = ("insert_grows", "delete", "reinsert")


@pytest.fixture(scope="module", params=["float32", "int8"])
def ivf_run(request):
    world = RefTreeGenerator(num_users=120, num_roles=24, num_docs=200, h=3,
                             b0=2, b1=3, seed=7).generate()
    corpus = ref_synthetic(num_docs=200, blocks_per_doc=4, dim=32, seed=3)
    ra = ref_arena(corpus, world, block_rows=128, dtype=request.param)
    pa = arena_from_reference(ra, "cpu")
    n0 = corpus.n // 2
    ref = RefIVFIndex(ra, rows=np.arange(n0), nlist=8, nprobe=8,
                      kmeans_iters=5, query_batch=16, seed=1,
                      pad_quantile=0.5)     # tight lists: the insert grows
    mine = ivf_from_reference(ref, "cpu")
    dels = np.arange(0, corpus.n, 7)
    rng = np.random.default_rng(5)
    q = rng.standard_normal((16, corpus.dim)).astype(np.float32)
    masks = world.user_masks[rng.integers(0, world.num_users, 16)]
    steps = {"insert_grows": lambda ix, a: ix.insert_rows(
                 a, np.arange(n0, corpus.n)),
             "delete": lambda ix, a: ix.delete_rows(a, dels),
             "reinsert": lambda ix, a: ix.insert_rows(a, dels)}
    out = {"l_pad0": ref.l_pad}
    for name in IVF_STEPS:
        ret = (steps[name](mine, pa), steps[name](ref, ra))
        out[name] = dict(ret=ret, mine=mine, l_pad=(mine.l_pad, ref.l_pad),
                         n_rows=(mine.n_rows, ref.n_rows),
                         lists=(mine._inv_rows.numpy().copy(),
                                np.asarray(ref._inv_rows)),
                         bits=(mine._inv_bits.numpy().view(np.uint32).copy(),
                               np.asarray(ref._inv_bits)),
                         full=(mine.search(q, masks, 10, nprobe=8),
                               ref.search(q, masks, 10, nprobe=8)))
        live = out[name]["lists"][0]
        flat = FlatIndex(pa, np.sort(live[live >= 0]).astype(np.int64))
        out[name]["flat"] = flat.search(q, masks, 10)
    return out, dels


@pytest.mark.parametrize("step", IVF_STEPS)
def test_ivf_maintenance_matches_reference(ivf_run, step):
    """After each step the lists' rows and bits, L_pad and the row count
    equal the reference's (placements slot for slot: the nearest list with
    a free slot, its lowest free slot; growth past every full list), and
    the full probe returns the reference's results and FlatIndex's over
    the live rows."""
    run, dels = ivf_run
    r = run[step]
    np.testing.assert_array_equal(*r["lists"])
    np.testing.assert_array_equal(*r["bits"])
    assert r["l_pad"][0] == r["l_pad"][1] and r["n_rows"][0] == r["n_rows"][1]
    assert r["ret"][0] == r["ret"][1]
    assert_same_topk(*r["full"])
    assert_same_topk(r["full"][0], r["flat"])
    live = r["lists"][0]
    live = live[live >= 0]
    assert len(live) == len(np.unique(live)) == r["n_rows"][0]
    if step == "insert_grows":
        assert r["l_pad"][0] > run["l_pad0"] and r["l_pad"][0] % 8 == 0
    if step == "delete":
        assert r["ret"][0] == len(dels)
        assert not np.isin(r["full"][0][1], dels).any()
    if step == "reinsert":     # the freed slots take the rows back
        assert r["l_pad"][0] == run["delete"]["l_pad"][0]


# ---- role insert and delete: plans, partition choice, orphans

@pytest.fixture(scope="module")
def planned():
    """A reference world, its planner inputs and plan, and the port's
    copies of the three."""
    world = RefTreeGenerator(num_users=120, num_roles=24, num_docs=200, h=3,
                             b0=2, b1=3, seed=7).generate()
    ref_in = RefPlannerInputs(
        role_to_docs=world.role_to_docs, combs=world.combs,
        comb_weights=world.comb_weights,
        single_role_weights={r: 1.0 for r in range(world.num_roles)},
        params=RefCostModelParams(), alpha=2.0, topk=10)
    plan = ref_plan(world, ref_in)
    mine = _port_inputs(world.role_to_docs, world.combs, world.comb_weights,
                        {r: 1.0 for r in range(world.num_roles)})
    return world, ref_in, plan, mine, plan_from_reference(plan)


def _port_inputs(r2d, combs, weights, single):
    return PlannerInputs(role_to_docs=r2d, combs=combs, comb_weights=weights,
                         single_role_weights=single,
                         params=CostModelParams(), alpha=2.0, topk=10)


def _port_world(w) -> RBACWorld:
    return RBACWorld(num_users=w.num_users, num_roles=w.num_roles,
                     num_docs=w.num_docs, user_to_roles=dict(w.user_to_roles),
                     role_to_docs=dict(w.role_to_docs))


def _same_plan(got, want):
    assert got.assignment == want.assignment
    assert got.trackers == want.trackers
    assert got.split_log == want.split_log


@pytest.mark.parametrize("docs", [range(0, 30), range(150, 200),
                                  range(0, 200, 3), [5]],
                         ids=["head", "tail", "spread", "one"])
def test_insert_role_matches_reference(planned, docs):
    """choose_partition_for_new_role and insert_role (with the combs that
    hold the new role) give the reference's partition, is_new flag and
    plan; the given plan is left as it was (rollback is keeping it)."""
    world, ref_in, plan, _, mine_plan = planned
    new_role, new_docs = world.num_roles, set(docs)
    r2d = dict(ref_in.role_to_docs)
    r2d[new_role] = frozenset(new_docs)
    combs = list(ref_in.combs) + [(new_role,), (0, new_role)]
    single = {**ref_in.single_role_weights, new_role: 1.0}
    ref_in2 = RefPlannerInputs(
        role_to_docs=r2d, combs=combs, comb_weights=ref_in.comb_weights,
        single_role_weights=single, params=ref_in.params, alpha=2.0,
        topk=10)
    mine_in2 = _port_inputs(r2d, combs, ref_in.comb_weights, single)
    assert (choose_partition_for_new_role(mine_plan, mine_in2, new_docs)
            == ref_choose(plan, ref_in2, new_docs))
    kw = dict(combs_with_role={(new_role,), (0, new_role)})
    got, pid = insert_role(mine_plan, mine_in2, new_role, new_docs, **kw)
    want, want_pid = ref_insert(plan, ref_in2, new_role, new_docs, **kw)
    assert pid == want_pid
    _same_plan(got, want)
    _same_plan(mine_plan, plan_from_reference(plan))


@pytest.mark.parametrize("pick", [0, 5, -1])
def test_delete_role_matches_reference(planned, pick):
    """delete_role gives the reference's plan (trackers without the role,
    documents pruned, empty partitions dropped), and the orphan helpers
    the reference's documents and rows."""
    world, ref_in, plan, mine_in, mine_plan = planned
    victim = world.combs[pick][0]
    _same_plan(delete_role(mine_plan, mine_in, victim),
               ref_delete(plan, ref_in, victim))
    mine_world = _port_world(world)
    doc_ids = np.repeat(np.arange(world.num_docs), 3)
    for role in (victim, world.num_roles - 1, 0):
        assert (orphaned_docs_after_role_delete(mine_world, role)
                == ref_orphan_docs(world, role))
        np.testing.assert_array_equal(
            orphaned_rows_after_role_delete(mine_world, doc_ids, role),
            ref_orphan_rows(world, doc_ids, role))


# ---- the plan update on the device

def _cfgs(packed_kind="flat_approx"):
    ref_cfg, cfg = RefFrameworkConfig(), FrameworkConfig()
    for c in (ref_cfg, cfg):
        c.search.block_rows = 128
        c.search.batch_size = 16
        c.optimizer.storage_alpha = 2.0
        c.index.kind = packed_kind
    return ref_cfg, cfg


@pytest.fixture(scope="module")
def small():
    world = RefTreeGenerator(num_users=120, num_roles=24, num_docs=200, h=3,
                             b0=2, b1=3, seed=7).generate()
    corpus, _ = ref_corpus(num_vectors=800, dim=32, blocks_per_doc=4,
                           seed=3)
    return world, corpus


def test_apply_plan_update_reuses_unchanged_partitions(small):
    """packed=False (an Int8FlatIndex a partition): a role delete's plan
    keeps the index object of every partition whose documents did not
    change and builds the others (the reference's choice, partition for
    partition); the updated searcher returns the reference's ids."""
    world, corpus = small
    ref_cfg, cfg = _cfgs()
    ra = ref_arena(corpus, world, block_rows=128, dtype="int8")
    pa = arena_from_reference(ra, "cpu")
    ref = ref_searcher("dynamic", corpus, world, ra, ref_cfg, packed=False)
    mine = build_searcher("dynamic", corpus, _port_world(world), pa, cfg,
                          plan=plan_from_reference(ref.plan), packed=False)
    ref_in = RefPlannerInputs(
        role_to_docs=world.role_to_docs, combs=world.combs,
        comb_weights=world.comb_weights,
        single_role_weights={r: 1.0 for r in range(world.num_roles)},
        params=RefCostModelParams(), alpha=2.0, topk=10)
    # the first role whose delete changes some partitions but not all
    for victim in sorted(world.role_to_docs):
        plan2 = ref_delete(ref.plan, ref_in, victim)
        changed = [pid for pid, docs in plan2.assignment.items()
                   if ref.plan.assignment.get(pid) != docs]
        if 0 < len(changed) < len(plan2.assignment):
            break
    want = ref_apply_plan_update(ref, corpus, world, ref_cfg, plan2)
    got = apply_plan_update(mine, corpus, _port_world(world), cfg,
                            plan_from_reference(plan2))
    assert sorted(got.partitions) == sorted(want.partitions)
    shared = [pid for pid, p in got.partitions.items()
              if mine.partitions.get(pid) is p]
    want_shared = [pid for pid, p in want.partitions.items()
                   if ref.partitions.get(pid) is p]
    assert shared == want_shared
    assert sorted(set(got.partitions) - set(shared)) == sorted(changed)
    for pid, p in got.partitions.items():
        np.testing.assert_array_equal(p.rows, want.partitions[pid].rows)
    assert not any(victim in c for c in got.plan.trackers)
    rng = np.random.default_rng(2)
    q = rng.integers(0, 256, (24, corpus.dim)).astype(np.float32)
    users = rng.integers(0, world.num_users, 24)
    assert_same_topk(got.search_batch(q, users, world.user_masks, 10),
                     want.search_batch(q, users, world.user_masks, 10))


@pytest.mark.parametrize("dtype,layout", [("int8", TiledSearcher),
                                          ("float32", PackedSearcher)])
def test_insert_role_end_to_end_matches_reference(small, dtype, layout):
    """The reference's insert flow: plan, insert a role granted to user 0,
    rebuild the arena for the new world, materialize the old plan on it
    and apply the updated plan; the packed layout is rebuilt whole (a new
    searcher on the new plan), and user 0's search returns the reference's
    ids, which are the brute-force top-10 over the rows user 0 reads."""
    world, corpus = small
    ref_cfg, cfg = _cfgs()
    ra = ref_arena(corpus, world, block_rows=128, dtype=dtype)
    ref = ref_searcher("dynamic", corpus, world, ra, ref_cfg)
    new_docs = set(range(0, 40))
    world2, new_role = world.with_new_role(new_docs, users=[0])
    mine_world2, mine_role = _port_world(world).with_new_role(new_docs,
                                                               users=[0])
    assert mine_role == new_role
    ref_in2 = RefPlannerInputs(
        role_to_docs=world2.role_to_docs, combs=world2.combs,
        comb_weights=world2.comb_weights,
        single_role_weights={r: 1.0 for r in range(world2.num_roles)},
        params=RefCostModelParams(), alpha=2.0, topk=10)
    mine_in2 = _port_inputs(mine_world2.role_to_docs, mine_world2.combs,
                            mine_world2.comb_weights,
                            {r: 1.0 for r in range(world2.num_roles)})
    combs = {tuple(world2.user_to_roles[0]), (new_role,)}
    plan2, pid = ref_insert(ref.plan, ref_in2, new_role, new_docs,
                            combs_with_role=combs)
    mine_plan2, mine_pid = insert_role(plan_from_reference(ref.plan),
                                       mine_in2, new_role, new_docs,
                                       combs_with_role=combs)
    assert pid == mine_pid
    _same_plan(mine_plan2, plan2)
    ra2 = ref_arena(corpus, world2, block_rows=128, dtype=dtype)
    pa2 = arena_from_reference(ra2, "cpu")
    ref_mid = ref_searcher("dynamic", corpus, world2, ra2, ref_cfg,
                           plan=ref.plan)
    mid = build_searcher("dynamic", corpus, mine_world2, pa2, cfg,
                         plan=plan_from_reference(ref.plan))
    want = ref_apply_plan_update(ref_mid, corpus, world2, ref_cfg, plan2)
    got = apply_plan_update(mid, corpus, mine_world2, cfg, mine_plan2)
    assert isinstance(got, layout) and got is not mid
    assert got.plan is mine_plan2
    q = np.random.default_rng(0).integers(0, 256, (1, corpus.dim)).astype(
        np.float32)
    d, ids = got.search_batch(q, np.array([0]), mine_world2.user_masks, 10)
    assert_same_topk((d, ids), want.search_batch(q, np.array([0]),
                                                 world2.user_masks, 10))
    docs = world2.user_docs(0)
    rows = corpus.rows_for_docs(np.fromiter(docs, np.int64, len(docs)))
    dd = ((corpus.vectors[rows].astype(np.float64) - q[0]) ** 2).sum(1)
    assert set(ids[0].tolist()) == set(
        rows[np.argsort(dd, kind="stable")[:10]].tolist())


# ---- bench.online at a small size

def test_online_cell_matches_reference_recalls():
    """bench.online's cell at 6,000 rows (4,000 built, 2,000 inserted;
    the classic builder at this size): the report carries the keys of the
    reference's record (results/online_insert_scale.json), and its HNSW
    recalls before, after and after refine (and over the inserted region)
    are those of the reference's index taken through the same build,
    insert, refine and sampled-entry searches against the same truth."""
    import json
    import os

    from vectorsearch_rbac_tpu_torch.bench import online

    dev = torch.device("cpu")
    cell = online.make_cell(dev, n=6000, n_old=4000, nq=32)
    truth_old = online.exact_topk(cell.arena, cell.queries, 4000, 10)
    truth_all = online.exact_topk(cell.arena, cell.queries, 6000, 10)
    rep, ix = online.drive_hnsw(cell, truth_old, truth_all)
    ivf_rep, _ = online.drive_ivf(cell, truth_old, truth_all, nlist=16,
                                  nprobe=16)
    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "online_insert_scale.json")
    with open(path) as f:
        record = json.load(f)
    assert set(record["hnsw"]) <= set(rep) and set(record["ivf"]) == set(
        ivf_rep)
    assert ivf_rep["recall_after"] == 1.0     # full probe: exact
    world = RefTreeGenerator(num_users=1_000, num_roles=30,
                             num_docs=cell.corpus.num_docs, h=3, b0=3, b1=4,
                             seed=0).generate()
    ra = ref_arena(cell.corpus, world, block_rows=65536, dtype="float32")
    ref = RefHNSWIndex(ra, np.arange(4000), m=16, ef_construction=64,
                       ef_search=64, query_batch=256, seed=0, logical=True)

    def ids():
        return ref.search(cell.queries, cell.masks, 10, sampled_entry=True)[1]

    want = {"recall_before": online.recall_against(ids(), truth_old)}
    ref.insert_rows(ra, np.arange(4000, 6000))
    got = ids()
    want["recall_after"] = online.recall_against(got, truth_all)
    want["recall_inserted_region"] = online.region_recall(got, truth_all,
                                                          4000)
    ref.refine_rows(ra, np.arange(4000, 6000))
    got = ids()
    want["recall_after_refine"] = online.recall_against(got, truth_all)
    want["recall_inserted_region_after_refine"] = online.region_recall(
        got, truth_all, 4000)
    assert {key: rep[key] for key in want} == want
    np.testing.assert_array_equal(ix._hgraph, np.asarray(ref._graph))
    assert set(rep["phases_s"]) == {f"{a}.{b}" for a in ("insert", "refine")
                                    for b in ("search", "link", "scatter")}


def test_role_cycle_at_a_small_size():
    """bench.online's role cycle on a 20,000-row SIFT-like scenario and its
    AnonySys plan: a role inserted by the CLI's rule and served after
    apply_plan_update (every row readable, checked inside), the role with
    the most orphaned documents deleted, and the rls pass over the
    tombstoned arena returning none of its orphaned rows (checked inside)
    where the same pass before the tombstone returned some."""
    from vectorsearch_rbac_tpu_torch.bench import (make_scenario, online,
                                                   serving_config)
    from vectorsearch_rbac_tpu_torch.partition.dynamic import (
        plan_dynamic_partitions, planner_inputs)

    corpus, world, wl = make_scenario(n=20000, num_queries=256, topk=10)
    cfg = serving_config(topk=10, strategy="dynamic", block_rows=4096)
    cfg.optimizer.storage_alpha = 2.0
    cfg.optimizer.topk = 10
    plan = plan_dynamic_partitions(world, planner_inputs(corpus, world, cfg))
    rep, served = online.role_cycle(corpus, world, plan, cfg,
                                    torch.device("cpu"), wl.vectors,
                                    wl.user_ids, 10, block_rows=4096)
    new_docs, users = online.sample_new_role(world)
    assert rep["new_role"] == world.num_roles
    assert rep["new_role_docs"] == len(new_docs) > 0
    assert rep["assigned_users"] == len(users) == world.num_users // 100
    assert rep["layout"] == "TiledSearcher" and rep["recall"] >= 0.95
    assert rep["orphaned_rows"] > 0
    assert rep["orphaned_returned_before_tombstone"] > 0
    assert rep["deleted_role"] != rep["new_role"]
    u2r = served["world"].user_to_roles
    assert all(rep["new_role"] in u2r[u] for u in served["users"][::4])
    assert served["ids"].shape == (len(wl.user_ids), 10)


def test_online_runner_flags():
    """bench.online's command line: the sizes set the cell's, --roles runs
    at its own fixed size and refuses them, and without CUDA it exits 2
    before building anything."""
    from vectorsearch_rbac_tpu_torch.bench import online

    with pytest.raises(SystemExit) as e:
        online.main(["--roles", "--n", "1000"])
    assert e.value.code == 2
    with pytest.raises(SystemExit):
        online.main(["--k", "5"])
    if not torch.cuda.is_available():
        assert online.main(["--n", "1000", "--n-old", "500"]) == 2
        assert online.main(["--roles"]) == 2
