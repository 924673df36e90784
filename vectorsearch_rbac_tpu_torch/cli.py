"""The port's command line.

Counterpart of vectorsearch_rbac_tpu/cli.py, with its ten subcommands,
flags and defaults. State between commands lives in an artifact directory:
the pickled world and query pool (state.pkl, the port's own classes), the
query dataset (query_dataset.json), the ground-truth cache, the plan
(dynamic_plan.pkl), fitted parameters (parameter_<index>.json) and each
command's JSON results.

`--device` (default cuda) picks where the searches, oracles and fits run:
cuda:0 unless `--device cpu` is given. A subcommand that runs on the
device exits non-zero without a card unless it is told to use the CPU;
the host-only ones (prepare, generate-queries, plan-dynamic, insert-role,
delete-role, rollback) read no device.

Usage:
  python -m vectorsearch_rbac_tpu_torch.cli prepare --dataset sift1m \\
      --n 1000000 --generator tree --num-roles 100 --num-users 10000
  python -m vectorsearch_rbac_tpu_torch.cli generate-queries \\
      --num-queries 1000 --topk 10
  python -m vectorsearch_rbac_tpu_torch.cli plan-dynamic --storage 2.0
  python -m vectorsearch_rbac_tpu_torch.cli test --algorithm AnonySys
  python -m vectorsearch_rbac_tpu_torch.cli --device cpu test \\
      --algorithm RLS --dtype float32 --index flat
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import sys
import time

import numpy as np

from .config import get_logger

logger = get_logger("cli")

ALGORITHM_TO_STRATEGY = {
    "RLS": "rls",
    "ROLE": "role",
    "USER": "user",
    "AnonySys": "dynamic",
    "QDTree": "qdtree",
}


def _art(args, name: str) -> str:
    os.makedirs(args.artifacts, exist_ok=True)
    return os.path.join(args.artifacts, name)


def _device(args):
    """The torch device of a subcommand that searches: cuda:0 (or the
    given CUDA device) unless --device cpu; no card and no --device cpu
    is an error, not a quiet fall-back to the CPU."""
    import torch

    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this subcommand runs on the card; "
                         "pass --device cpu to run it on the CPU")
    dev = torch.device(args.device)
    return torch.device("cuda", dev.index or 0)


def _load(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def _load_state(args):
    return _load(_art(args, "state.pkl"))


def _load_plan(args, command: str):
    pfile = _art(args, "dynamic_plan.pkl")
    if not os.path.exists(pfile):
        raise SystemExit(f"{command} requires a dynamic plan: run "
                         "plan-dynamic first")
    return _load(pfile)


def _corpus_from_state(state):
    from .data import resolve_dataset

    corpus, _ = resolve_dataset(
        state["dataset"], dataset_path=state.get("dataset_path", ""),
        num_vectors=state["n"], seed=state["seed"])
    return corpus


def _workload(args, state, corpus, num_queries: int, topk: int):
    """query_dataset.json where generate-queries wrote one, else a uniform
    workload drawn from the state's pool."""
    from .bench import generate_query_workload
    from .bench.queries import QueryWorkload

    qfile = _art(args, "query_dataset.json")
    if os.path.exists(qfile):
        return QueryWorkload.load_json(qfile)
    return generate_query_workload(
        corpus, state["world"], num_queries=num_queries, topk=topk,
        query_pool=state.get("query_pool"), seed=state["seed"] + 1)


def _clear_gt_cache(args) -> None:
    for f in os.listdir(args.artifacts):
        if f.startswith("gt_"):
            os.remove(os.path.join(args.artifacts, f))


def cmd_prepare(args) -> None:
    """The dataset, the RBAC world and the state the other commands read."""
    from .data import resolve_dataset
    from .rbac import GENERATORS

    corpus, query_pool = resolve_dataset(
        args.dataset, dataset_path=args.dataset_path, num_vectors=args.n,
        seed=args.seed)
    kwargs = dict(num_users=args.num_users, num_docs=corpus.num_docs,
                  seed=args.seed)
    kwargs[{"erbac": "n_froles", "arxiv_business": "num_categories"}.get(
        args.generator, "num_roles")] = args.num_roles
    world = GENERATORS[args.generator](**kwargs).generate()
    _dump({"dataset": args.dataset, "dataset_path": args.dataset_path,
           "n": args.n, "seed": args.seed, "generator": args.generator,
           "world": world, "query_pool": query_pool},
          _art(args, "state.pkl"))
    logger.info(
        "prepared: corpus %d x %d, %d roles, %d users, avg user sel %.4f",
        corpus.n, corpus.dim, world.num_roles, world.num_users,
        world.average_user_selectivity())


def cmd_generate_queries(args) -> None:
    """query_dataset.json (uniform, zipf or role-targeted); the
    ground-truth cache is cleared."""
    from .bench import (generate_query_workload,
                        generate_query_workload_for_roles)

    state = _load_state(args)
    corpus = _corpus_from_state(state)
    if args.per_role > 0:
        wl = generate_query_workload_for_roles(
            corpus, state["world"], queries_per_role=args.per_role,
            topk=args.topk, repetitions=args.repetitions,
            query_pool=state.get("query_pool"), seed=args.seed + 1)
    else:
        wl = generate_query_workload(
            corpus, state["world"], num_queries=args.num_queries,
            topk=args.topk, zipf_param=args.zipf,
            repetitions=args.repetitions,
            query_pool=state.get("query_pool"), seed=args.seed + 1)
    wl.save_json(_art(args, "query_dataset.json"))
    _clear_gt_cache(args)
    logger.info("wrote %d queries (topk=%d)", wl.num_queries, args.topk)


def _apply_tombstones(state, corpus, arena):
    """Zero the role bits of the rows that delete-role orphaned: every
    scan and graph admit test then rejects them."""
    docs = state.get("tombstoned_docs")
    if not docs:
        return arena
    from .core import tombstone_rows

    rows = corpus.rows_for_docs(np.asarray(docs, dtype=np.int64))
    logger.info("tombstoned %d rows of %d orphaned docs", len(rows),
                len(docs))
    return tombstone_rows(arena, rows)


def _planner_inputs(args, world, corpus, *, alpha: float, topk: int,
                    recall=None):
    """The planner's inputs: fitted parameters and workload weights where
    the artifacts hold them, else the defaults and the world's weights."""
    from .bench.queries import QueryWorkload
    from .models.cost import CostModelParams
    from .partition.dynamic import (PlannerInputs, comb_weights_from_workload,
                                    single_role_weights_from_workload)

    params = CostModelParams()
    for name in ("parameter_hnsw.json", "parameter_ivf.json",
                 "parameter_model.json"):
        pfile = _art(args, name)
        if os.path.exists(pfile):
            with open(pfile) as f:
                params = CostModelParams.from_dict(json.load(f))
            logger.info("loaded fitted params from %s", pfile)
            break
    qfile = _art(args, "query_dataset.json")
    if os.path.exists(qfile):
        wl = QueryWorkload.load_json(qfile)
        comb_w = comb_weights_from_workload(world, wl)
        single_w = single_role_weights_from_workload(world, wl)
    else:
        comb_w = world.comb_weights
        single_w = {r: 1.0 / max(world.num_roles, 1)
                    for r in range(world.num_roles)}
    return PlannerInputs(
        role_to_docs=world.role_to_docs, combs=world.combs,
        comb_weights=comb_w, single_role_weights=single_w, params=params,
        alpha=alpha, topk=topk, target_recall=recall,
        avg_blocks_per_doc=corpus.avg_blocks_per_doc)


def cmd_plan_dynamic(args) -> None:
    """The AnonySys plan at storage budget --storage (and --recall)."""
    from .partition.dynamic import plan_dynamic_partitions

    state = _load_state(args)
    world = state["world"]
    corpus = _corpus_from_state(state)
    inputs = _planner_inputs(args, world, corpus, alpha=args.storage,
                             topk=args.topk, recall=args.recall)
    t0 = time.perf_counter()
    plan = plan_dynamic_partitions(world, inputs)
    _dump(plan, _art(args, "dynamic_plan.pkl"))
    logger.info("planned %d partitions in %.1fs (alpha=%.2f)",
                len(plan.assignment), time.perf_counter() - t0, args.storage)


def _backup_artifact(args, name: str) -> None:
    """Copy an artifact aside before a maintenance step; rollback restores
    it."""
    path = _art(args, name)
    if os.path.exists(path):
        shutil.copyfile(path, path + ".bak")


def _commit_maintenance(args, state, world, plan) -> None:
    _backup_artifact(args, "state.pkl")
    _backup_artifact(args, "dynamic_plan.pkl")
    _dump(plan, _art(args, "dynamic_plan.pkl"))
    state["world"] = world
    _dump(state, _art(args, "state.pkl"))
    _clear_gt_cache(args)   # user masks changed


def cmd_insert_role(args) -> None:
    """Insert a role: its documents and users sampled by the reference's
    rule (bench.online.sample_new_role), the plan updated by
    partition.dynamic.insert_role. rollback undoes it."""
    from .bench.online import sample_new_role
    from .partition.dynamic import insert_role

    state = _load_state(args)
    world = state["world"]
    corpus = _corpus_from_state(state)
    plan = _load_plan(args, "insert-role")
    new_docs, assignees = sample_new_role(world, seed=args.seed,
                                          docs=args.docs,
                                          assign_users=args.assign_users)
    new_world, new_role = world.with_new_role(new_docs,
                                              [int(u) for u in assignees])
    inputs = _planner_inputs(args, new_world, corpus, alpha=args.storage,
                             topk=args.topk)
    combs_with_role = {c for c in new_world.combs if new_role in c}
    combs_with_role.add((new_role,))
    plan2, pid = insert_role(plan, inputs, new_role, new_docs,
                             combs_with_role=combs_with_role)
    _commit_maintenance(args, state, new_world, plan2)
    logger.info("inserted role %d (%d docs, %d users) into partition %d; "
                "rollback with the `rollback` subcommand", new_role,
                len(new_docs), len(assignees), pid)
    print(json.dumps({"new_role": new_role, "num_docs": len(new_docs),
                      "assigned_users": len(assignees), "partition": pid,
                      "num_partitions": len(plan2.assignment)}))


def cmd_delete_role(args) -> None:
    """Delete a role from the world and the plan. Documents only it could
    read are recorded as tombstoned: test, serve and compute-ground-truth
    zero their rows' role bits (core.tombstone_rows)."""
    from .partition.dynamic import delete_role
    from .partition.dynamic.maintenance import orphaned_docs_after_role_delete

    state = _load_state(args)
    world = state["world"]
    corpus = _corpus_from_state(state)
    role = args.role
    if role not in world.role_to_docs:
        raise SystemExit(f"role {role} does not exist")
    plan = _load_plan(args, "delete-role")
    orphaned = orphaned_docs_after_role_delete(world, role)
    new_world = world.without_role(role)
    inputs = _planner_inputs(args, new_world, corpus, alpha=args.storage,
                             topk=args.topk)
    plan2 = delete_role(plan, inputs, role)
    state["tombstoned_docs"] = sorted(
        set(state.get("tombstoned_docs", ())) | orphaned)
    _commit_maintenance(args, state, new_world, plan2)
    logger.info("deleted role %d: %d partitions remain, %d docs orphaned "
                "(tombstoned at serve time); rollback with `rollback`",
                role, len(plan2.assignment), len(orphaned))
    print(json.dumps({"deleted_role": role, "orphaned_docs": len(orphaned),
                      "num_partitions": len(plan2.assignment)}))


def cmd_rollback(args) -> None:
    """Restore state.pkl and dynamic_plan.pkl from before the last
    maintenance step."""
    restored = []
    for name in ("state.pkl", "dynamic_plan.pkl"):
        bak = _art(args, name) + ".bak"
        if os.path.exists(bak):
            shutil.copyfile(bak, _art(args, name))
            restored.append(name)
    if not restored:
        raise SystemExit("no .bak snapshots found: nothing to roll back")
    _clear_gt_cache(args)
    logger.info("rolled back: %s", ", ".join(restored))


def cmd_compute_ground_truth(args) -> None:
    """The exact ground truth of query_dataset.json, cached (gt_*.npy) and
    written as (doc, block) pointers to ground_truth_cache.json."""
    from .bench import GroundTruthOracle
    from .bench.queries import QueryWorkload
    from .core import build_device_arena

    dev = _device(args)
    state = _load_state(args)
    world = state["world"]
    corpus = _corpus_from_state(state)
    qfile = _art(args, "query_dataset.json")
    if not os.path.exists(qfile):
        raise SystemExit("no query_dataset.json: run generate-queries first")
    wl = QueryWorkload.load_json(qfile)
    arena = _apply_tombstones(state, corpus, build_device_arena(
        corpus, world, device=dev, block_rows=args.block_rows,
        dtype="float32", metric=args.metric))
    oracle = GroundTruthOracle(arena, cache_dir=args.artifacts,
                               block_rows=args.block_rows)
    t0 = time.perf_counter()
    idx = oracle.compute(corpus, world, wl, args.topk)
    dt = time.perf_counter() - t0
    pointer = [[[int(corpus.doc_ids[r]), int(corpus.block_ids[r])]
                if r >= 0 else [-1, -1] for r in row]
               for row in np.asarray(idx)]
    out = _art(args, "ground_truth_cache.json")
    with open(out, "w") as f:
        json.dump({"topk": args.topk, "num_queries": int(idx.shape[0]),
                   "results": pointer}, f)
    logger.info("ground truth for %d queries (top-%d) in %.1fs -> %s",
                idx.shape[0], args.topk, dt, out)


def _searcher_kwargs(args, strategy: str, wl=None) -> dict:
    kwargs = {}
    pfile = _art(args, "dynamic_plan.pkl")
    if strategy == "dynamic" and os.path.exists(pfile):
        kwargs["plan"] = _load(pfile)
    if strategy == "qdtree" and wl is not None:
        kwargs["workload"] = wl
    return kwargs


def cmd_serve(args) -> None:
    """Closed-loop online serving: --clients threads submit single queries
    from the query dataset through the micro-batching front-end
    (serving.BatchingServer) for --duration seconds; reports QPS, latency
    percentiles and the device batches."""
    from .config import FrameworkConfig
    from .core import build_device_arena
    from .partition import build_searcher
    from .serving import BatchingServer, closed_loop

    dev = _device(args)
    state = _load_state(args)
    world = state["world"]
    corpus = _corpus_from_state(state)
    cfg = FrameworkConfig(seed=state["seed"])
    cfg.search.block_rows = args.block_rows
    cfg.index.kind = args.index
    cfg.search.ef_search = args.efs
    arena = _apply_tombstones(state, corpus, build_device_arena(
        corpus, world, device=dev, block_rows=cfg.search.block_rows,
        dtype=args.dtype))
    strategy = ALGORITHM_TO_STRATEGY[args.algorithm]
    searcher = build_searcher(strategy, corpus, world, arena, cfg,
                              **_searcher_kwargs(args, strategy))
    wl = _workload(args, state, corpus, 1024, args.topk)
    pool_q, pool_u = wl.vectors, wl.user_ids
    # warm outside the measured window
    searcher.search_batch(pool_q[:16], pool_u[:16], world.user_masks,
                          args.topk)

    def draw(r):
        j = int(r.integers(0, len(pool_q)))
        return pool_q[j], int(pool_u[j])

    with BatchingServer(searcher, world.user_masks, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms) as srv:
        rep, _ = closed_loop(srv, draw, args.topk, args.clients,
                             args.duration, seed0=7000)
    report = {"algorithm": args.algorithm, "clients": args.clients,
              "duration_s": rep.pop("wall_s"), **rep}
    with open(_art(args, "serve_results.json"), "w") as f:
        json.dump(report, f, indent=2)
    logger.info("served %d requests at %.0f QPS (p50 %.1f ms)",
                report["requests"], report["qps"], report["p50_ms"])
    print(json.dumps(report))


def cmd_fit_params(args) -> None:
    """Fit the cost model by sweeping the index's search width against
    exact ground truth: (k, beta, ef_offset) on the global index at the
    workload's mean selectivity, (a, b) jointly over subset indexes of
    several sizes, the join time over 1, 2 and 4 partitions of one row
    set; IVF fits the coverage family instead. Writes
    parameter_<index>.json and model_validation.json."""
    from .bench import GroundTruthOracle, generate_query_workload
    from .core import build_device_arena
    from .index.hnsw import HNSWIndex
    from .index.ivf import IVFIndex
    from .models.cost import CostModelParams
    from .models.fitting import (fit_ivf_coverage, fit_join_time,
                                 fit_qps_params, fit_recall_params)
    from .models.validate import sweep_search_width, validate_models
    from .utils.persist import save_params

    dev = _device(args)
    state = _load_state(args)
    world = state["world"]
    corpus = _corpus_from_state(state)
    arena = build_device_arena(corpus, world, device=dev,
                               block_rows=args.block_rows, dtype=args.dtype)
    wl = generate_query_workload(corpus, world, num_queries=args.num_queries,
                                 topk=args.topk,
                                 query_pool=state.get("query_pool"),
                                 seed=state["seed"] + 2)
    gt_arena = arena if args.dtype == "float32" else build_device_arena(
        corpus, world, device=dev, block_rows=args.block_rows,
        dtype="float32")
    oracle = GroundTruthOracle(gt_arena, cache_dir=args.artifacts,
                               block_rows=args.block_rows)
    truth = oracle.compute(corpus, world, wl, args.topk)
    masks = world.user_masks[wl.user_ids]

    def make_index(rows=None):
        if args.index == "hnsw":
            idx = HNSWIndex(arena, rows=rows, m=16, ef_construction=64,
                            query_batch=1024, seed=state["seed"])
            return idx, lambda q, m, k, ef: idx.search(q, m, k, ef_search=ef)
        idx = IVFIndex(arena, rows=rows, nlist=args.nlist, query_batch=1024,
                       seed=state["seed"])
        return idx, lambda q, m, k, ef: idx.search(q, m, k, nprobe=ef)

    global_idx, search_fn = make_index()
    sweep = sweep_search_width(search_fn, wl.vectors, masks, truth,
                               args.topk, args.efs)
    sel = float(np.mean(wl.selectivities))

    # (a, b): the log(n) factor is fitted over subset indexes of several
    # sizes, not assumed
    rng = np.random.default_rng(state["seed"] + 7)
    sizes = sorted({max(2048, corpus.n // f) for f in (8, 4, 2, 1)})
    qn, qe, qt = [], [], []
    for size in sizes:
        rows = (None if size >= corpus.n
                else np.sort(rng.choice(corpus.n, size, replace=False)))
        _, sfn = make_index(rows)
        ssweep = sweep_search_width(sfn, wl.vectors, masks, truth,
                                    args.topk, args.efs, timing_reps=1)
        qn += [size] * len(args.efs)
        qe += list(ssweep["efs"])
        qt += ssweep["times_s"]

    # the join time: one row set split over m partitions, so the slope of
    # t(m) is the per-partition dispatch and merge overhead alone
    ef_j = args.efs[len(args.efs) // 2]
    base_rows = np.sort(rng.choice(corpus.n, min(sizes[0], corpus.n),
                                   replace=False))
    jm, jt = [], []
    for m_probes in (1, 2, 4):
        fns = [make_index(np.sort(part))[1]
               for part in np.array_split(base_rows, m_probes)]
        for fn in fns:   # warm outside the timed region
            fn(wl.vectors, masks, args.topk, ef_j)
        t0 = time.perf_counter()
        for fn in fns:
            fn(wl.vectors, masks, args.topk, ef_j)
        jm.append(m_probes)
        jt.append((time.perf_counter() - t0) / len(wl.vectors))
    join_time = fit_join_time(jm, jt)

    a, b = fit_qps_params(qn, qe, qt)
    if args.index == "ivf":
        # IVF recall is coverage-shaped: fit the coverage family
        params = fit_ivf_coverage(sweep["efs"], sweep["recalls"],
                                  l_pad=global_idx.l_pad, a=a, b=b)
        pred = np.asarray([params.recall(m) for m in sweep["efs"]])
        report = {
            "index": "ivf", "family": "ivf_coverage",
            "recall_mae": float(np.mean(np.abs(
                pred - np.asarray(sweep["recalls"])))),
            "sweep": {"nprobe": list(map(float, sweep["efs"])),
                      "measured": list(map(float, sweep["recalls"])),
                      "predicted": [float(x) for x in pred]},
        }
        logger.info(
            "fitted ivf coverage k=%.3f lam=%.4g sigma=%.3f a=%.4g b=%.4g "
            "(recall MAE %.3f)", params.k, params.lam, params.sigma,
            params.a, params.b, report["recall_mae"])
    else:
        rp = fit_recall_params(sweep["efs"], sweep["recalls"], args.topk,
                               sel, fit_offset=True)
        params = CostModelParams(k=rp[0], beta=rp[1], a=a, b=b,
                                 join_time=join_time, ef_offset=rp[2])
        report = validate_models(sweep, params, topk=args.topk, sel=sel,
                                 n_vectors=corpus.n)
        logger.info(
            "fitted k=%.3f beta=%.4f ef0=%.1f a=%.4g b=%.4g join=%.2e "
            "(recall MAE %.3f, %d sizes)", params.k, params.beta,
            params.ef_offset, params.a, params.b, params.join_time,
            report["recall_mae"], len(sizes))
    save_params(params, _art(args, f"parameter_{args.index}.json"))
    with open(_art(args, "model_validation.json"), "w") as f:
        json.dump(report, f, indent=2)


def cmd_test(args) -> None:
    """One algorithm over the query dataset at each --efs: build, then
    run_benchmark against the exact oracle; writes
    <algorithm>_results.json and prints the last result."""
    from .bench import GroundTruthOracle, run_benchmark
    from .config import FrameworkConfig
    from .core import build_device_arena
    from .partition import build_searcher

    dev = _device(args)
    state = _load_state(args)
    world = state["world"]
    corpus = _corpus_from_state(state)
    cfg = FrameworkConfig(seed=state["seed"])
    cfg.search.block_rows = args.block_rows
    cfg.index.kind = args.index
    cfg.search.nprobe = args.nprobe
    cfg.optimizer.storage_alpha = args.storage
    # the planner takes the parameters a fit-params run cached, where they
    # are its family's (fit-params --index ivf caches the IVF coverage
    # family, which the planner's recall model does not read)
    pjson = _art(args, f"parameter_{args.index}.json")
    if os.path.exists(pjson):
        from .models.cost import CostModelParams
        from .utils.persist import load_params

        p = load_params(pjson)
        if isinstance(p, CostModelParams):
            o = cfg.optimizer
            o.recall_k, o.recall_beta, o.qps_a, o.qps_b = (p.k, p.beta, p.a,
                                                           p.b)
            o.join_time, o.ef_offset = p.join_time, p.ef_offset
            o.n_ref, o.gamma_n = p.n_ref, p.gamma_n
            logger.info("loaded fitted cost-model params from %s", pjson)

    arena = _apply_tombstones(state, corpus, build_device_arena(
        corpus, world, device=dev, block_rows=cfg.search.block_rows,
        dtype=args.dtype, metric=args.metric))
    gt_arena = arena if args.dtype == "float32" else _apply_tombstones(
        state, corpus, build_device_arena(
            corpus, world, device=dev, block_rows=cfg.search.block_rows,
            dtype="float32", metric=args.metric))
    oracle = GroundTruthOracle(gt_arena, cache_dir=args.artifacts,
                               block_rows=cfg.search.block_rows)
    wl = _workload(args, state, corpus, args.queries_num, args.topk)
    strategy = ALGORITHM_TO_STRATEGY[args.algorithm]
    kwargs = _searcher_kwargs(args, strategy, wl)

    results = []
    for ef in args.efs:
        cfg.search.ef_search = ef
        if args.index == "ivf":
            cfg.search.nprobe = ef
        t0 = time.perf_counter()
        searcher = build_searcher(strategy, corpus, world, arena, cfg,
                                  **kwargs)
        build_s = time.perf_counter() - t0
        if args.cache:
            # the cache workload: the comb-keyed LRU, no warm-up, so the
            # pass sees cold misses and repetition hits
            from .bench.result_cache import CachedSearcher

            searcher = CachedSearcher(searcher, world,
                                      capacity=args.cache_capacity)
            res = run_benchmark(searcher, corpus, world, wl, oracle,
                                k=args.topk, build_time_s=build_s,
                                warmup_runs=0)
            d = json.loads(res.to_json())
            d["cache"] = searcher.stats()
            results.append(d)
            continue
        res = run_benchmark(searcher, corpus, world, wl, oracle, k=args.topk,
                            build_time_s=build_s)
        results.append(json.loads(res.to_json()))
    out = _art(args, f"{args.algorithm.lower()}_results.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    logger.info("wrote %s", out)
    print(json.dumps(results[-1]))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m vectorsearch_rbac_tpu_torch.cli")
    p.add_argument("--artifacts", default="artifacts")
    p.add_argument("--device", default="cuda",
                   help="cuda (cuda:0), cuda:N or cpu: where the searching "
                        "subcommands run")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("prepare")
    sp.add_argument("--dataset", default="sift1m")
    sp.add_argument("--dataset-path", default="")
    sp.add_argument("--n", type=int, default=1_000_000)
    sp.add_argument("--generator", default="tree",
                    choices=["tree", "sharing_tree", "erbac", "random",
                             "arxiv_business"])
    sp.add_argument("--num-roles", type=int, default=100)
    sp.add_argument("--num-users", type=int, default=10_000)
    sp.add_argument("--seed", type=int, default=0)
    sp.set_defaults(fn=cmd_prepare)

    sq = sub.add_parser("generate-queries")
    sq.add_argument("--num-queries", type=int, default=1000)
    sq.add_argument("--topk", type=int, default=10)
    sq.add_argument("--zipf", type=float, default=0)
    sq.add_argument("--repetitions", type=int, default=1)
    sq.add_argument("--per-role", type=int, default=0, metavar="Q",
                    help="role-targeted workload: Q queries per role")
    sq.add_argument("--seed", type=int, default=0)
    sq.set_defaults(fn=cmd_generate_queries)

    sd = sub.add_parser("plan-dynamic")
    sd.add_argument("--storage", type=float, default=1.5)
    sd.add_argument("--recall", type=float, default=None)
    sd.add_argument("--topk", type=int, default=10)
    sd.set_defaults(fn=cmd_plan_dynamic)

    si = sub.add_parser("insert-role", help="online role insertion")
    si.add_argument("--docs", type=int, default=0, metavar="N",
                    help="the new role's document count (default: "
                         "1/num_roles of each role's documents)")
    si.add_argument("--assign-users", type=int, default=0, metavar="K",
                    help="users granted the new role (default num_users/100)")
    si.add_argument("--storage", type=float, default=1.5)
    si.add_argument("--topk", type=int, default=10)
    si.add_argument("--seed", type=int, default=0)
    si.set_defaults(fn=cmd_insert_role)

    sx = sub.add_parser("delete-role", help="online role deletion")
    sx.add_argument("--role", type=int, required=True)
    sx.add_argument("--storage", type=float, default=1.5)
    sx.add_argument("--topk", type=int, default=10)
    sx.set_defaults(fn=cmd_delete_role)

    sr = sub.add_parser("rollback", help="restore the state from before the "
                        "last insert-role or delete-role")
    sr.set_defaults(fn=cmd_rollback)

    sv = sub.add_parser("serve", help="closed-loop online serving through "
                        "the micro-batching front-end")
    sv.add_argument("--algorithm", default="RLS",
                    choices=sorted(ALGORITHM_TO_STRATEGY))
    sv.add_argument("--clients", type=int, default=64)
    sv.add_argument("--duration", type=float, default=10.0)
    sv.add_argument("--topk", type=int, default=10)
    sv.add_argument("--efs", type=int, default=40)
    sv.add_argument("--index", default="flat_approx",
                    choices=["flat", "flat_approx", "ivf", "hnsw", "hybrid"])
    sv.add_argument("--dtype", default="int8")
    sv.add_argument("--block-rows", type=int, default=65536)
    sv.add_argument("--max-batch", type=int, default=2048)
    sv.add_argument("--max-wait-ms", type=float, default=3.0)
    sv.set_defaults(fn=cmd_serve)

    sg = sub.add_parser("compute-ground-truth",
                        help="precompute and cache exact ground truth")
    sg.add_argument("--topk", type=int, default=10)
    sg.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "cosine", "l1"])
    sg.add_argument("--block-rows", type=int, default=65536)
    sg.set_defaults(fn=cmd_compute_ground_truth)

    sf = sub.add_parser("fit-params")
    sf.add_argument("--index", default="hnsw", choices=["hnsw", "ivf"])
    sf.add_argument("--efs", type=int, nargs="+",
                    default=[8, 16, 32, 64, 128, 256])
    sf.add_argument("--topk", type=int, default=10)
    sf.add_argument("--num-queries", type=int, default=256)
    sf.add_argument("--nlist", type=int, default=256)
    sf.add_argument("--dtype", default="float32")
    sf.add_argument("--block-rows", type=int, default=16384)
    sf.set_defaults(fn=cmd_fit_params)

    st = sub.add_parser("test")
    st.add_argument("--algorithm", required=True,
                    choices=sorted(ALGORITHM_TO_STRATEGY))
    st.add_argument("--efs", type=int, nargs="+", default=[40])
    st.add_argument("--metric", default="l2",
                    choices=["l2", "ip", "cosine", "l1"],
                    help="distance metric (pgvector <-> / <#> / <=> "
                         "operator family)")
    st.add_argument("--topk", type=int, default=10)
    st.add_argument("--queries-num", type=int, default=1000)
    st.add_argument("--index", default="flat_approx",
                    choices=["flat", "flat_approx", "ivf", "hnsw", "binary"])
    st.add_argument("--dtype", default="bfloat16")
    st.add_argument("--block-rows", type=int, default=65536)
    st.add_argument("--nprobe", type=int, default=16)
    st.add_argument("--storage", type=float, default=1.5)
    st.add_argument("--cache", action="store_true",
                    help="cache-workload mode: comb-keyed LRU result cache, "
                         "no warm-up, hit-rate reporting")
    st.add_argument("--cache-capacity", type=int, default=10000)
    st.set_defaults(fn=cmd_test)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
