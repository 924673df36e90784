"""Tree RBAC world pinned to the configuration: worlds/tree.py's generator
drawn from the world block's own `seed` in place of the run's.

A deployment serves one access policy (its role tree, its users' roles,
its documents' roles); the corpus and the traffic still come from the
run's seed. A planner's layout (AnonySys) is a function of the policy, so
with the policy pinned every run serves the same partitions, copies and
device memory, and a change to the program is what moves them."""

from typing import Mapping

from rbacbench.manifest import generator


def make(spec: Mapping, num_docs: int, seed: int):
    """The world the config's "world" block describes over num_docs
    documents, from the block's `seed` (the run's seed is not used)."""
    return generator("worlds", "tree").make(spec, num_docs, int(spec["seed"]))
