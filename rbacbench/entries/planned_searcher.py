"""Entry `planned_searcher`: the program's AnonySys searcher (strategy
`dynamic`), its plan made first and within a budget of host time.

The plan is part of the deployment's set-up, and a run has a time limit.
The configuration's `port` block gives, beside what entry `searcher`
reads (`strategy`, which has to be "dynamic", `arena`, `framework`),
- `plan_seconds`: the host seconds the planner may take over the
  configuration's world. A planner still running then raises
  `PlanTimeout`, so the run fails there, before the arena is built,
  instead of holding the card past the run's limit.

The planner runs through the program's `planner_inputs` and
`plan_dynamic_partitions`, and `build_searcher` takes the plan. The
program gets the harness's arrays through `core.Corpus` and
`rbac.RBACWorld`, and nothing else of the benchmark.
"""

import signal
import threading
import time

import numpy as np

from rbacbench import harness, port


class PlanTimeout(RuntimeError):
    pass


def within(seconds: float, work):
    """work(), or PlanTimeout once it has run `seconds`. In the main
    thread a timer interrupts it; elsewhere, where no signal can reach it,
    it is timed and refused after it returns."""
    def refuse(_signum=None, _frame=None):
        raise PlanTimeout(f"the plan took more than its {seconds:g} s "
                          "budget of host time")

    if threading.current_thread() is not threading.main_thread():
        t0 = time.perf_counter()
        out = work()
        if time.perf_counter() - t0 > seconds:
            refuse()
        return out
    old = signal.signal(signal.SIGALRM, refuse)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        return work()
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def build(config, corpus, world, device) -> port.System:
    from vectorsearch_rbac_tpu_torch.core import Corpus, build_device_arena
    from vectorsearch_rbac_tpu_torch.partition import build_searcher
    from vectorsearch_rbac_tpu_torch.partition.dynamic import (
        plan_dynamic_partitions, planner_inputs)
    from vectorsearch_rbac_tpu_torch.rbac import RBACWorld

    spec = config["port"]
    if spec["strategy"] != "dynamic":
        raise ValueError(f"entry planned_searcher plans strategy 'dynamic', "
                         f"not {spec['strategy']!r}")
    pcorpus = Corpus(vectors=corpus.rows.astype(np.float32),
                     doc_ids=corpus.doc_ids, block_ids=corpus.block_ids)
    pworld = RBACWorld(num_users=world.num_users, num_roles=world.num_roles,
                       num_docs=world.num_docs,
                       user_to_roles=world.user_to_roles,
                       role_to_docs=world.role_to_docs)
    cfg = port.framework_config(spec.get("framework", {}))
    t0 = time.perf_counter()
    inputs = planner_inputs(pcorpus, pworld, cfg)
    plan = within(float(spec["plan_seconds"]),
                  lambda: plan_dynamic_partitions(pworld, inputs))
    harness.say(f"plan {time.perf_counter() - t0:.3f} s: "
                f"{len(plan.assignment)} partitions, load "
                f"{sum(plan.loads.values())} documents")
    arena = build_device_arena(pcorpus, pworld, device=device,
                               metric=config["metric"],
                               **spec.get("arena", {}))
    state = {"searcher": build_searcher("dynamic", pcorpus, pworld, arena,
                                        cfg, plan=plan, inputs=inputs)}
    masks = pworld.user_masks

    def search(queries, user_ids, k):
        return state["searcher"].search_batch(queries, user_ids, masks, k)

    return port.System(search=search, close=state.clear)
