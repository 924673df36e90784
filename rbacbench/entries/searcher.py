"""Entry `searcher`: the program's searcher over its device arena, called
through `search_batch`.

A configuration's `port` block gives
- `strategy`: the name `partition.build_searcher` takes;
- `arena`: keyword arguments of `core.build_device_arena`, but the metric,
  which is the configuration's own `metric`;
- `framework`: fields of `config.FrameworkConfig` (port.framework_config).

The program gets the harness's arrays through `core.Corpus` and
`rbac.RBACWorld`, and nothing else of the benchmark.
"""

import numpy as np

from rbacbench import port


def build(config, corpus, world, device) -> port.System:
    from vectorsearch_rbac_tpu_torch.core import Corpus, build_device_arena
    from vectorsearch_rbac_tpu_torch.partition import build_searcher
    from vectorsearch_rbac_tpu_torch.rbac import RBACWorld

    spec = config["port"]
    pcorpus = Corpus(vectors=corpus.rows.astype(np.float32),
                     doc_ids=corpus.doc_ids, block_ids=corpus.block_ids)
    pworld = RBACWorld(num_users=world.num_users, num_roles=world.num_roles,
                       num_docs=world.num_docs,
                       user_to_roles=world.user_to_roles,
                       role_to_docs=world.role_to_docs)
    cfg = port.framework_config(spec.get("framework", {}))
    arena = build_device_arena(pcorpus, pworld, device=device,
                               metric=config["metric"],
                               **spec.get("arena", {}))
    state = {"searcher": build_searcher(spec["strategy"], pcorpus, pworld,
                                        arena, cfg)}
    masks = pworld.user_masks

    def search(queries, user_ids, k):
        return state["searcher"].search_batch(queries, user_ids, masks, k)

    return port.System(search=search, close=state.clear)
