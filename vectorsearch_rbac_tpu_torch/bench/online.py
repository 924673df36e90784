"""Online maintenance on the card: the online-insert cell and the role cycle.

    python -m vectorsearch_rbac_tpu_torch.bench.online [--n 300000]
        [--n-old 200000] [--queries 512]
    python -m vectorsearch_rbac_tpu_torch.bench.online --roles

The port's runner for scripts/online_insert_scale.py, at its sizes by
default: sift_like_corpus(300,000 x 128, 100 blocks a document, seed 0),
the tree world of 1,000 users and 30 roles (h 3, b0 3, b1 4, seed 0), a
float32 arena, 512 queries from the held-out pool (default_rng(1)) with
full-access masks, top-10. An HNSW graph (m 16, ef_construction 64,
ef_search 64; the "tpu" builder, its kNN exact at 200,000 rows) over rows
[0, n_old) takes one insert_rows of rows [n_old, n), then refine_rows of
the same rows; an IVF index (nlist 512, nprobe 48) takes the same split.
Recall@k (sampled entries for HNSW) against the exact top-k over the rows
the index holds: before the insert over [0, n_old), after it over [0, n),
and over the inserted region alone (the truth rows >= n_old).
chip_smoke.py's phase 4j drives the same cell through these functions and
then deletes rows from it (`delete_leg`).

--roles runs the role cycle instead, on the bench's 1M SIFT scenario and
its AnonySys plan at alpha 2.0, top-10 (chip_smoke.py's 4c): one role
inserted by the reference CLI's sampling rule (insert-role: 1/num_roles of
each role's documents, granted to 1% of the users, default_rng(0)), the
arena rebuilt for the new world, the old plan materialized on it and
apply_plan_update'd; a 4,096-query pass whose every fourth user holds the
new role, every returned row readable under the new world, recall@10
against the exact oracle; then delete_role of the role with the most
orphaned documents, its orphaned rows tombstoned, and an rls
Int8FlatIndex pass over the tombstoned arena with the old masks of that
role's users (which still carry its bit), near the orphaned rows: no
orphaned row may come back (the same pass over the arena before the
tombstone must return some).

Prints one JSON line: the keys of results/online_insert_scale.json (the
role cycle's own), and the card's nvidia-smi name and power limit. Exits
2 without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core import (Corpus, DeviceArena, build_device_arena,
                    tombstone_rows)
from ..data import sift_like_corpus
from ..index.hnsw import HNSWIndex
from ..index.ivf import IVFIndex
from ..ops.scan import exact_f32_matmul
from ..rbac import RBACWorld, TreeRBACGenerator
from .evidence import card, readable_or_raise

N, N_OLD, NQ, K, EF = 300_000, 200_000, 512, 10, 64
NLIST, NPROBE = 512, 48
ROLE_QUERIES = 4096      # the role cycle's pass
ORPHAN_QUERIES = 2048    # the tombstoned rls pass (one query batch)


@dataclass
class Cell:
    corpus: Corpus
    world: RBACWorld
    arena: DeviceArena
    pool: np.ndarray       # the held-out query pool
    queries: np.ndarray    # (nq, d) float32
    masks: np.ndarray      # (nq, W) uint32, every bit set
    n_old: int


def make_cell(device, n: int = N, n_old: int = N_OLD, nq: int = NQ,
              seed: int = 0) -> Cell:
    """The script's corpus, world, arena, queries and full-access masks."""
    corpus, pool = sift_like_corpus(num_vectors=n, blocks_per_doc=100,
                                    seed=seed)
    world = TreeRBACGenerator(num_users=1_000, num_roles=30,
                              num_docs=corpus.num_docs, h=3, b0=3, b1=4,
                              seed=seed).generate()
    arena = build_device_arena(corpus, world, device=device,
                               block_rows=65536, dtype="float32")
    rng = np.random.default_rng(1)
    queries = pool[rng.choice(len(pool), nq, replace=True)].astype(
        np.float32)
    masks = np.full((nq, world.words), 0xFFFFFFFF, dtype=np.uint32)
    return Cell(corpus, world, arena, pool, queries, masks, n_old)


def exact_topk(arena: DeviceArena, queries: np.ndarray, n_rows: int, k: int,
               excluded: Optional[np.ndarray] = None) -> np.ndarray:
    """(Q, k) int64: each query's k nearest of rows [0, n_rows) of the
    arena's float32 host rows by squared L2, without `excluded`, from
    float32 products on the arena's device (TF32 off; exact on SIFT's
    integer rows)."""
    dev = arena.device
    x = torch.from_numpy(np.ascontiguousarray(
        arena.host_vectors[:n_rows], np.float32)).to(dev)
    keep = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    if excluded is not None and len(excluded):
        keep[torch.from_numpy(np.asarray(excluded, np.int64)).to(dev)] = True
    nrm = torch.where(keep, torch.inf, (x * x).sum(1))
    q = torch.from_numpy(np.ascontiguousarray(queries, np.float32)).to(dev)
    out = []
    with exact_f32_matmul():
        for s in range(0, len(q), 256):
            sc = nrm[None, :] - 2.0 * (q[s:s + 256] @ x.T)
            out.append(torch.topk(sc, k, dim=1, largest=False).indices)
    return torch.cat(out).cpu().numpy().astype(np.int64)


def recall_against(ids: np.ndarray, truth: np.ndarray) -> float:
    """Mean over queries of |returned & truth| / |truth| (the script's)."""
    return float(np.mean([
        len({int(x) for x in got if x >= 0} & {int(x) for x in want})
        / len(want) for got, want in zip(ids, truth)]))


def region_recall(ids: np.ndarray, truth: np.ndarray, lo: int) -> float:
    """Recall over the truth rows with id >= lo (the inserted region)."""
    hit = tot = 0
    for got, want in zip(ids, truth):
        w = {int(x) for x in want if x >= lo}
        tot += len(w)
        hit += len({int(x) for x in got if x >= 0} & w)
    return hit / tot if tot else float("nan")


def _timed(fn, device) -> Tuple[object, float]:
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def drive_hnsw(cell: Cell, truth_old: np.ndarray, truth_all: np.ndarray,
               k: int = K, ef: int = EF) -> Tuple[Dict, HNSWIndex]:
    """Build over [0, n_old), insert [n_old, n), refine them; the script's
    "hnsw" report (and the insert's and refine's phases, host seconds)
    and the index."""
    a, dev = cell.arena, cell.arena.device
    n = cell.corpus.n
    rows_new = np.arange(cell.n_old, n, dtype=np.int64)
    ix, build_s = _timed(lambda: HNSWIndex(
        a, np.arange(cell.n_old, dtype=np.int64), m=16, ef_construction=64,
        ef_search=ef, query_batch=256, seed=0), dev)

    def ids():
        return ix.search(cell.queries, cell.masks, k, sampled_entry=True)[1]

    r_before = recall_against(ids(), truth_old)
    _, ins_s = _timed(lambda: ix.insert_rows(a, rows_new), dev)
    got = ids()
    r_after = recall_against(got, truth_all)
    r_region = region_recall(got, truth_all, cell.n_old)
    _, ref_s = _timed(lambda: ix.refine_rows(a, rows_new), dev)
    got = ids()
    return {
        "build_s": build_s, "insert_s": ins_s,
        "insert_rows_per_s": len(rows_new) / ins_s,
        "recall_before": r_before, "recall_after": r_after,
        "recall_inserted_region": r_region,
        "refine_s": ref_s,
        "insert_plus_refine_rows_per_s": len(rows_new) / (ins_s + ref_s),
        "recall_after_refine": recall_against(got, truth_all),
        "recall_inserted_region_after_refine": region_recall(
            got, truth_all, cell.n_old),
        "phases_s": dict(ix.maintenance_s),
    }, ix


def drive_ivf(cell: Cell, truth_old: np.ndarray, truth_all: np.ndarray,
              k: int = K, nlist: int = NLIST, nprobe: int = NPROBE
              ) -> Tuple[Dict, IVFIndex]:
    """IVF over [0, n_old), one insert of [n_old, n); the script's "ivf"
    report and the index."""
    a, dev = cell.arena, cell.arena.device
    rows_new = np.arange(cell.n_old, cell.corpus.n, dtype=np.int64)
    ivf, build_s = _timed(lambda: IVFIndex(
        a, np.arange(cell.n_old, dtype=np.int64), nlist=nlist, nprobe=nprobe,
        query_batch=256, seed=0), dev)
    r_before = recall_against(ivf.search(cell.queries, cell.masks, k)[1],
                              truth_old)
    _, ins_s = _timed(lambda: ivf.insert_rows(a, rows_new), dev)
    got = ivf.search(cell.queries, cell.masks, k)[1]
    return {"build_s": build_s, "insert_s": ins_s,
            "insert_rows_per_s": len(rows_new) / ins_s,
            "recall_before": r_before,
            "recall_after": recall_against(got, truth_all),
            "recall_inserted_region": region_recall(got, truth_all,
                                                    cell.n_old)}, ivf


def delete_leg(arena: DeviceArena, rows: np.ndarray, hnsw=(), ivf=()
               ) -> Tuple[DeviceArena, Dict]:
    """Tombstone `rows` in `arena`, then delete them from each HNSW index
    (graph repair, the index rebound to the tombstoned arena) and each
    IVF index; returns (the tombstoned arena, seconds and counts)."""
    dev = arena.device
    arena2, t_s = _timed(lambda: tombstone_rows(arena, rows), dev)
    rep = {"tombstone_s": t_s, "hnsw": [], "ivf": []}
    for ix in hnsw:
        before = dict(ix.maintenance_s)
        n, s = _timed(lambda ix=ix: ix.delete_rows(arena2, rows), dev)
        rep["hnsw"].append({"deleted": n, "repaired_nodes": ix.repaired_nodes,
                            "delete_s": s, "phases_s": {
                                key: v - before.get(key, 0.0) for key, v in
                                ix.maintenance_s.items()
                                if key.startswith("delete.")}})
    for iv in ivf:
        n, s = _timed(lambda iv=iv: iv.delete_rows(arena2, rows), dev)
        rep["ivf"].append({"deleted": n, "delete_s": s})
    return arena2, rep


def run_cell(device, n: int = N, n_old: int = N_OLD, nq: int = NQ) -> Dict:
    """The online-insert cell; the script's report."""
    cell = make_cell(device, n, n_old, nq)
    truth_old = exact_topk(cell.arena, cell.queries, n_old, K)
    truth_all = exact_topk(cell.arena, cell.queries, n, K)
    report = {"n_old": n_old, "n_insert": n - n_old, "k": K, "ef": EF,
              "nq": nq}
    report["hnsw"], _ = drive_hnsw(cell, truth_old, truth_all)
    report["ivf"], _ = drive_ivf(cell, truth_old, truth_all)
    return report


# ---- the role cycle

def sample_new_role(world: RBACWorld, seed: int = 0, docs: int = 0,
                    assign_users: int = 0) -> Tuple[set, np.ndarray]:
    """The reference CLI's insert-role sampling (cli.py:232-252), from one
    default_rng(seed): `docs` documents drawn from all of them, or (docs
    0) max(1, int(|docs| / num_roles)) of each role's documents; then
    `assign_users` users, or (0) 1% of them, at least one."""
    rng = np.random.default_rng(seed)
    if docs > 0:
        new_docs = set(int(d) for d in rng.choice(
            world.num_docs, size=min(docs, world.num_docs), replace=False))
    else:
        ratio = 1.0 / world.num_roles if world.num_roles > 0 else 0.05
        new_docs = set()
        for role_docs in world.role_to_docs.values():
            role_docs = np.fromiter(role_docs, dtype=np.int64,
                                    count=len(role_docs))
            take = max(1, int(len(role_docs) * ratio))
            new_docs.update(int(d) for d in rng.choice(
                role_docs, size=min(take, len(role_docs)), replace=False))
    n_assign = assign_users if assign_users > 0 else max(
        1, world.num_users // 100)
    users = rng.choice(world.num_users, size=min(n_assign, world.num_users),
                       replace=False)
    return new_docs, users


def role_cycle(corpus: Corpus, world: RBACWorld, plan, cfg, device,
               queries: np.ndarray, user_ids: np.ndarray, k: int = 10,
               block_rows: int = 131072, seed: int = 0
               ) -> Tuple[Dict, Dict]:
    """Insert a role into `plan` and its world, re-materialize on the new
    world's arena with apply_plan_update, serve a pass; then delete the
    role with the most orphaned documents and serve an rls pass over the
    arena with its orphaned rows tombstoned. Raises where a check fails;
    returns (seconds, recall, counts and each pass's kernel launches, the
    counts set to 0 just before the pass; the served pass: its ids and
    users, the new world and its arena)."""
    from ..index.flat_int8 import Int8FlatIndex
    from ..ops import _build
    from ..partition.dynamic import (apply_plan_update,
                                     build_dynamic_searcher, delete_role,
                                     insert_role,
                                     orphaned_docs_after_role_delete,
                                     orphaned_rows_after_role_delete,
                                     planner_inputs)
    from .ground_truth import GroundTruthOracle, per_query_recall
    from .queries import QueryWorkload

    rep: Dict = {}
    t0 = time.perf_counter()
    new_docs, assignees = sample_new_role(world, seed)
    world2, new_role = world.with_new_role(new_docs, users=assignees)
    inputs = planner_inputs(corpus, world2, cfg)
    combs = {c for c in world2.combs if new_role in c} | {(new_role,)}
    plan2, pid = insert_role(plan, inputs, new_role, new_docs,
                             combs_with_role=combs)
    rep.update(new_role=new_role, new_role_docs=len(new_docs),
               assigned_users=len(assignees), partition=int(pid),
               partitions=len(plan2.assignment),
               insert_role_s=time.perf_counter() - t0)
    arena2, rep["arena_s"] = _timed(lambda: build_device_arena(
        corpus, world2, device=device, block_rows=block_rows, dtype="int8"),
        device)
    mid, rep["old_plan_s"] = _timed(lambda: build_dynamic_searcher(
        corpus, world2, arena2, cfg, plan=plan), device)
    upd, rep["apply_plan_update_s"] = _timed(lambda: apply_plan_update(
        mid, corpus, world2, cfg, plan2), device)
    rep["layout"] = type(upd).__name__
    rep["big_tier_partitions"] = len(getattr(upd, "_big", {}))
    rep["reused_partitions"] = sum(
        1 for pid, p in getattr(upd, "partitions", {}).items()
        if getattr(mid, "partitions", {}).get(pid) is p)
    del mid
    users = np.array(user_ids, dtype=np.int64)
    users[::4] = assignees[np.arange(len(users[::4])) % len(assignees)]
    _build.reset_launches()
    (_, ids), rep["pass_s"] = _timed(lambda: upd.search_batch(
        queries, users, world2.user_masks, k), device)
    rep["launches_update_pass"] = {n: v for n, v in _build.LAUNCHES.items()
                                   if v}
    readable_or_raise("role insert", ids, world2.user_masks[users],
                      arena2.host_bits)
    gt_arena = build_device_arena(corpus, world2, device=device,
                                  block_rows=65536, dtype="float32")
    wl = QueryWorkload(vectors=queries, user_ids=users, topk=k,
                       selectivities=np.zeros(len(users)),
                       repetitions=np.zeros(len(users), dtype=np.int64))
    truth = GroundTruthOracle(gt_arena, block_rows=65536,
                              query_batch=1024).compute(corpus, world2, wl, k)
    del gt_arena
    rep["recall"] = float(np.mean(per_query_recall(ids, truth)))
    rep["recall_new_role_users"] = float(np.mean(
        per_query_recall(ids[::4], truth[::4])))
    mine = ids[::4]
    rep["new_role_rows_returned"] = int((np.isin(
        corpus.doc_ids[np.maximum(mine, 0)],
        np.fromiter(new_docs, np.int64)) & (mine >= 0)).sum())

    # delete the role with the most orphaned documents
    t0 = time.perf_counter()
    orphans = {r: len(orphaned_docs_after_role_delete(world2, r))
               for r in sorted(world2.role_to_docs)}
    victim = max(orphans, key=lambda r: (orphans[r], -r))
    if not orphans[victim]:
        raise RuntimeError("no role owns an orphaned document")
    plan3 = delete_role(plan2, inputs, victim)
    rows = orphaned_rows_after_role_delete(world2, corpus.doc_ids, victim)
    rep.update(deleted_role=victim, orphaned_docs=orphans[victim],
               orphaned_rows=len(rows),
               partitions_after_delete=len(plan3.assignment),
               delete_role_s=time.perf_counter() - t0)
    if any(victim in c or any(victim in rs for rs in parts.values())
           for c, parts in plan3.trackers.items()):
        raise RuntimeError(f"role {victim} is still tracked")
    arena3, rep["tombstone_s"] = _timed(lambda: tombstone_rows(arena2, rows),
                                        device)
    holders = np.array(sorted(u for u, rs in world2.user_to_roles.items()
                              if victim in rs), dtype=np.int64)
    rng = np.random.default_rng(seed)
    q = corpus.vectors[rng.choice(rows, ORPHAN_QUERIES)].astype(np.float32)
    masks = world2.user_masks[holders[np.arange(ORPHAN_QUERIES)
                                      % len(holders)]]
    before = Int8FlatIndex(arena2, None, query_batch=ORPHAN_QUERIES,
                           wire="f32").search(q, masks, k)[1]
    rep["orphaned_returned_before_tombstone"] = int(
        np.isin(before, rows).sum())
    if not rep["orphaned_returned_before_tombstone"]:
        raise RuntimeError("the pass before the tombstone returned no "
                           "orphaned row: the check would prove nothing")
    rls = Int8FlatIndex(arena3, None, query_batch=ORPHAN_QUERIES, wire="f32")
    _build.reset_launches()
    (_, got), rep["tombstoned_pass_s"] = _timed(
        lambda: rls.search(q, masks, k), device)
    rep["launches_tombstoned_pass"] = {n: v for n, v in
                                       _build.LAUNCHES.items() if v}
    back = np.intersect1d(got[got >= 0], rows)
    if len(back):
        raise RuntimeError(f"the rls pass over the tombstoned arena returned "
                           f"{len(back)} orphaned rows, e.g. "
                           f"{back[:5].tolist()}")
    rep["tombstoned_pass_rows_returned"] = int((got >= 0).sum())
    return rep, dict(ids=ids, users=users, world=world2, arena=arena2)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=None,
                    help=f"rows in all (default {N:,})")
    ap.add_argument("--n-old", type=int, default=None,
                    help=f"rows the index is built over (default {N_OLD:,})")
    ap.add_argument("--queries", type=int, default=None,
                    help=f"queries (default {NQ})")
    ap.add_argument("--roles", action="store_true",
                    help="the role cycle on the 1M SIFT AnonySys plan")
    args = ap.parse_args(argv)
    sizes = (args.n, args.n_old, args.queries)
    if args.roles and any(v is not None for v in sizes):
        ap.error("--roles runs at 4c's fixed size: --n, --n-old and "
                 "--queries set the cell's")
    if not torch.cuda.is_available():
        print("bench.online measures the card: no CUDA device",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    if args.roles:
        from ..partition.dynamic import (plan_dynamic_partitions,
                                         planner_inputs)
        from .scenario import make_scenario, serving_config
        corpus, world, wl = make_scenario(n=1_000_000,
                                          num_queries=ROLE_QUERIES, topk=K,
                                          seed=0)
        cfg = serving_config(seed=0, topk=K, strategy="dynamic")
        cfg.optimizer.storage_alpha = 2.0
        cfg.optimizer.topk = K
        t0 = time.perf_counter()
        plan = plan_dynamic_partitions(world, planner_inputs(corpus, world,
                                                             cfg))
        plan_s = time.perf_counter() - t0
        rep, _ = role_cycle(corpus, world, plan, cfg, device, wl.vectors,
                            wl.user_ids, K)
        rep["plan_s"] = plan_s
        report = {"roles": rep}
    else:
        n, n_old, nq = (v if v is not None else d
                        for v, d in zip(sizes, (N, N_OLD, NQ)))
        report = run_cell(device, n, n_old, nq)
    report["card"] = card()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
