"""QDTree's recall / QPS knobs at 1M on the card: the routing radius
ladder and the centroid-prune margin.

    python -m vectorsearch_rbac_tpu_torch.bench.qdtree_sweeps radius
        [--visit-rows V] [--checkpoint PATH] [--device cuda|cpu]
    python -m vectorsearch_rbac_tpu_torch.bench.qdtree_sweeps margin
        [--legs script margin_rule] [--checkpoint PATH] [--device cuda|cpu]

The port's runner for scripts/qdtree_radius_sweep.py and
scripts/qdtree_margin_sweep.py, on the set-up of bench.strategy_compare
(the same corpus, world, truth and int8 arena; 4,096 queries for the
radius ladder, 1,024 for the margin), top-10, FrameworkConfig(seed=0)
with a batch of 1,024.

radius: ROLE, and QDTree built from the workload at radius_scale 0.2,
0.25 and 0.3. Each is warmed once, then 3 rounds of one pass a searcher,
in turns in one process; each gives recall_at_10 (the last round's),
qps (the median), partitions, storage_mb (the port's own bytes), build_s,
its walls and the kernels its passes launched. A QDTree key carries the
split scorer's visit tax it was built at, qdtree@<scale>_v<visit>:
build_qd_tree's default, min(8192, n / 16), is 8,192 at 1M, which the TPU
record holds as qdtree@0.25_v8192 and qdtree@0.3_v8192; its qdtree@<scale>
keys are the first ladder's, built at a visit tax of 512 (its _config),
which --visit-rows 512 repeats. "tpu_key" names the record's entry each
row compares with (null where it has none).

margin: one tree from the 1,024-query workload, margins 0.0, 0.1, 0.2,
0.3 and 0.5; for each the recall, the QPS (one warm pass, median of 3)
and avg_leaves, the mean count of leaves vector_router gives the first
256 queries. Two legs:

- script: as the script does it, vector_router swapped on today's tree.
  The tree has a route radius, and both routers decide by the radius
  whenever one is set, and the search asks batch_router first: the margin
  reaches neither. Each row says whether its routed leaves (vector_router
  on the first 256 queries, batch_router on all) and its ids equal
  margin 0.0's.
- margin_rule: the same tree with route_radius=None
  (dataclasses.replace), passed as tree= with prune_margin=m, so that
  batch_router and vector_router both decide by the margin rule. The TPU
  record's tree was doc-level and had no radius; this is its setting on
  today's row-level tree, a neighbour of its figures, not a target. Each
  row adds avg_routed_leaves (batch_router, every query) and build_s.

The margin record's "tree" gives the tree's leaves, its centroid
predicates and the leaves under one: a margin acts only there.

Every returned row must be readable by its user. The radius ladder and
the script leg are checkpointed whole, each margin_rule row as it is
measured, to --checkpoint
(state/qdtree_sweeps.json); a rerun skips what is there. Prints one JSON
line: "protocol" (naming the TPU records results/qdtree_radius_sweep_1m.json
and results/qdtree_margin_sweep_1m.json), "hardware" (the card's nvidia-smi
name and power limit), "radius" and "margin". Exits 2 without CUDA unless
given --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..config import FrameworkConfig
from ..partition import build_searcher
from . import evidence
from .evidence import free, log
from .ground_truth import compute_recall
from .strategy_compare import make_data, timed_passes

N, K = 1_000_000, 10
NQ_RADIUS, NQ_MARGIN = 4096, 1024
SCALES = (0.2, 0.25, 0.3)
MARGINS = (0.0, 0.1, 0.2, 0.3, 0.5)
MARGIN_LEGS = ("script", "margin_rule")
LEAVES_SAMPLE = 256
RADIUS_RECORD = "results/qdtree_radius_sweep_1m.json"
MARGIN_RECORD = "results/qdtree_margin_sweep_1m.json"
CHECKPOINT = os.path.join("state", "qdtree_sweeps.json")


def sweep_config(topk: Optional[int] = None) -> FrameworkConfig:
    """The scripts' FrameworkConfig (the radius sweep also sets topk)."""
    cfg = FrameworkConfig(seed=0)
    cfg.search.batch_size = 1024
    if topk is not None:
        cfg.optimizer.topk = topk
    return cfg


def visit_of(n: int, visit_rows: Optional[float]) -> int:
    """The visit tax a tree is built at (build_qd_tree's default)."""
    return int(visit_rows if visit_rows is not None
               else min(8192.0, max(n / 16.0, 8.0)))


def radius_keys(n: int, visit_rows: Optional[float]) -> Dict[str, tuple]:
    """{record key: (scale or None for ROLE, the TPU record's key)}."""
    visit = visit_of(n, visit_rows)
    keys = {"role": (None, "role")}
    for scale in SCALES:
        tpu = (f"qdtree@{scale}" if visit == 512 else
               f"qdtree@{scale}_v8192" if visit == 8192 and scale != 0.2
               else None)
        keys[f"qdtree@{scale}_v{visit}"] = (scale, tpu)
    return keys


def build_ladder(data: Dict, visit_rows: Optional[float]) -> Dict:
    """{key: (searcher, build seconds)}: ROLE, then QDTree a scale."""
    out = {}
    for key, (scale, _) in radius_keys(data["corpus"].n, visit_rows).items():
        t0 = time.perf_counter()
        if scale is None:
            s = build_searcher("role", data["corpus"], data["world"],
                               data["arena"], sweep_config(data["k"]))
        else:
            s = build_searcher("qdtree", data["corpus"], data["world"],
                               data["arena"], sweep_config(data["k"]),
                               workload=data["workload"], radius_scale=scale,
                               visit_rows=visit_rows)
            log(f"built {key}: {s.storage_report()['num_partitions']} "
                "partitions")
        out[key] = (s, time.perf_counter() - t0)
    return out


def radius_ladder(data: Dict, searchers: Dict, visit_rows: Optional[float],
                  rounds: int = 3) -> Dict:
    """The script's protocol over built searchers: a warm pass each, then
    `rounds` rounds of one pass a searcher in turns."""
    q, uids, k = data["queries"], data["uids"], data["k"]
    masks = data["world"].user_masks
    for s, _ in searchers.values():
        s.search_batch(q, uids, masks, k)
    walls = {key: [] for key in searchers}
    launches = {key: {} for key in searchers}
    ids = {}
    for _ in range(rounds):
        for key, (s, _) in searchers.items():
            ids[key], w, got = timed_passes(key, s, data, 1)
            walls[key] += w
            for name, v in got.items():
                launches[key][name] = launches[key].get(name, 0) + v
    tpu = radius_keys(data["corpus"].n, visit_rows)
    out = {}
    for key, (s, build_s) in searchers.items():
        rep = s.storage_report()
        out[key] = {
            f"recall_at_{k}": round(compute_recall(ids[key], data["truth"]),
                                    4),
            "qps": round(len(q) / float(np.median(walls[key])), 1),
            "partitions": rep.get("num_partitions", 1),
            "storage_mb": round(rep["total_mb"], 1),
            "build_s": round(build_s, 1),
            "pass_walls_s": [round(w, 4) for w in walls[key]],
            "kernels": launches[key],
            "tpu_key": tpu[key][1],
        }
    return out


def served(searcher) -> set:
    """The partition ids a TiledSearcher serves (the script's
    s.partitions): its chunk engine's and its big tier's."""
    return set(searcher.part_chunks) | set(searcher._big)


def script_router(searcher, world, margin: float):
    """scripts/qdtree_margin_sweep.py make_router: tree.route at the
    margin (the tree's radius, where it has one, decides)."""
    tree, pids, docs = searcher.tree, served(searcher), {}

    def vr(uid, qvec):
        if uid not in docs:
            docs[uid] = set(world.user_docs(uid))
        return tuple(p for p in tree.route(docs[uid], qvec, True,
                                           prune_margin=margin) if p in pids)
    return vr


def leaves(vector_router, data: Dict):
    """vector_router's leaves for the first LEAVES_SAMPLE queries."""
    q, uids = data["queries"], data["uids"]
    return [vector_router(int(u), q[j])
            for j, u in enumerate(uids[:LEAVES_SAMPLE])]


def margin_row(name: str, searcher, data: Dict):
    """(row, ids, sampled leaves, batch routes): one warm pass, 3 timed
    passes (median), avg_leaves over the first LEAVES_SAMPLE queries."""
    q, uids, k = data["queries"], data["uids"], data["k"]
    searcher.search_batch(q, uids, data["world"].user_masks, k)
    ids, walls, launches = timed_passes(name, searcher, data, 3)
    fan = leaves(searcher.vector_router, data)
    routes = searcher.batch_router(q, uids)
    row = {f"recall_at_{k}": round(compute_recall(ids, data["truth"]), 4),
           "qps": round(len(q) / float(np.median(walls)), 1),
           "avg_leaves": round(float(np.mean([len(f) for f in fan])), 1),
           "avg_routed_leaves": round(float(np.mean([len(r) for r in
                                                     routes])), 2),
           "pass_walls_s": [round(w, 4) for w in walls],
           "kernels": launches}
    return row, ids, fan, routes


def margin_searcher(data: Dict):
    """The margin script's searcher: QDTree built from the workload."""
    return build_searcher("qdtree", data["corpus"], data["world"],
                          data["arena"], sweep_config(),
                          workload=data["workload"])


def margin_rule_searcher(data: Dict, tree, margin: float):
    """QDTree over `tree` without its route radius, routed by the margin
    rule at `margin` (both routers)."""
    return build_searcher("qdtree", data["corpus"], data["world"],
                          data["arena"], sweep_config(),
                          tree=dataclasses.replace(tree, route_radius=None),
                          prune_margin=margin)


def tree_shape(tree) -> Dict:
    """What a margin can act on: the tree's leaves, its centroid
    predicates, and the leaves that lie under one (the others are reached
    by role predicates alone, whatever the margin)."""
    cents, paths = tree.routing_arrays()
    return {"leaves": len(tree.leaf_rows),
            "centroid_nodes": len(cents) // 2,
            "leaves_under_centroids": sum(1 for p in paths.values() if p),
            "route_radius": tree.route_radius}


def margin_legs(data: Dict, legs: Sequence[str], done: Dict,
                save=lambda: None) -> Dict:
    """The margin rows of `legs` that `done` ({leg: {margin: row}}) lacks;
    `save` is called after the script leg and each margin_rule row."""
    world = data["world"]
    t0 = time.perf_counter()
    s = margin_searcher(data)
    log(f"margin tree: {time.perf_counter() - t0:.1f}s, radius "
        f"{s.tree.route_radius}")
    done["tree"] = tree_shape(s.tree)
    for leg in legs:
        rows = done.setdefault(leg, {})
        todo = [m for m in MARGINS if str(m) not in rows]
        if leg == "script" and todo:
            # the leg is one unit: each margin is held to margin 0.0's
            # leaves and ids, measured in the same process
            base = None
            for m in MARGINS:
                s.vector_router = script_router(s, world, m)
                row, ids, fan, routes = margin_row(f"script@{m}", s, data)
                base = base or (ids, fan, routes)
                row["leaves_same_as_0.0"] = (fan == base[1]
                                             and routes == base[2])
                row["ids_same_as_0.0"] = bool(np.array_equal(ids, base[0]))
                rows[str(m)] = row
                log(f"[script {m}] " + json.dumps(row))
            save()
            continue
        if leg == "script":
            continue
        for m in todo:
            t0 = time.perf_counter()
            sm = margin_rule_searcher(data, s.tree, m)
            build_s = time.perf_counter() - t0
            row = margin_row(f"margin_rule@{m}", sm, data)[0]
            row["build_s"] = round(build_s, 1)
            rows[str(m)] = row
            log(f"[margin_rule {m}] " + json.dumps(row))
            save()
            del sm
            free(data["arena"].device)
    return done


def protocol(n: int) -> Dict:
    return {"n": n, "topk": K, "queries": {"radius": NQ_RADIUS,
                                           "margin": NQ_MARGIN},
            "radius": "warm each, 3 rounds in turns, median",
            "margin": "1 warm, median of 3; avg_leaves over the first "
                      f"{LEAVES_SAMPLE} queries",
            "reference_records": [RADIUS_RECORD + " (taken on a TPU v5e)",
                                  MARGIN_RECORD + " (taken on a TPU v5e, "
                                  "on a doc-level tree with no radius)"]}


def run(sweep: str, device, n: int = N, nq: Optional[int] = None,
        visit_rows: Optional[float] = None,
        legs: Sequence[str] = MARGIN_LEGS, out: Optional[Dict] = None,
        checkpoint: Optional[str] = None) -> Dict:
    """The record with the rows of `sweep` ("radius" or "margin") that
    `out` does not hold yet measured and checkpointed; nq defaults to the
    sweep's script's."""
    out = out if out is not None else {}
    out.setdefault("protocol", protocol(n))
    out.setdefault("hardware", evidence.hardware(device))
    radius = out.setdefault("radius", {})
    margin = out.setdefault("margin", {})
    if sweep == "radius":
        if all(key in radius for key in radius_keys(n, visit_rows)):
            log("the ladder is checkpointed: skip")
            return out
        data = make_data(n, nq or NQ_RADIUS, K, device)
        searchers = build_ladder(data, visit_rows)
        radius.update(radius_ladder(data, searchers, visit_rows))
        log("radius " + json.dumps(radius))
        evidence.save_checkpoint(checkpoint, out)
        return out
    if all(str(m) in margin.get(leg, {}) for leg in legs for m in MARGINS):
        log("every margin row is checkpointed: skip")
        return out
    data = make_data(n, nq or NQ_MARGIN, K, device)
    margin_legs(data, legs, margin,
                lambda: evidence.save_checkpoint(checkpoint, out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sweep", choices=("radius", "margin"))
    ap.add_argument("--visit-rows", type=float, default=None,
                    help="radius: the split scorer's visit tax (default "
                         "build_qd_tree's, 8,192 at 1M; 512 repeats the "
                         "record's first ladder)")
    ap.add_argument("--legs", nargs="+", choices=MARGIN_LEGS,
                    default=list(MARGIN_LEGS),
                    help="margin: the legs to run (default both)")
    ap.add_argument("--checkpoint", default=CHECKPOINT,
                    help=f"the rows measured so far (default {CHECKPOINT})")
    evidence.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = evidence.resolve_device(args.device, "bench.qdtree_sweeps")
    if device is None:
        return 2
    out = evidence.load_checkpoint(args.checkpoint) or {}
    out["hardware"] = evidence.hardware(device)
    out = run(args.sweep, device, visit_rows=args.visit_rows,
              legs=args.legs, out=out, checkpoint=args.checkpoint)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
