"""QD-tree debug tooling: a Graphviz export, a structure dump, a routing
trace of one query and the role -> leaves listing.

Counterpart of vectorsearch_rbac_tpu/partition/qdtree_debug.py; the four
helpers print the reference's strings for equal trees. The partition
check (validate_qdtree_partitions) lives beside the builder in qdtree.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set

import numpy as np

from ..rbac import RBACWorld
from .qdtree import QDNode, QDTree


def export_dot(tree: QDTree, max_label_docs: int = 4) -> str:
    """Graphviz dot text of the tree."""
    lines = ["digraph qdtree {", '  node [shape=box, fontsize=10];']
    counter = [0]

    def walk(node: QDNode) -> int:
        nid = counter[0]
        counter[0] += 1
        if node.leaf_id >= 0:
            docs = sorted(node.docs)[:max_label_docs]
            more = "" if len(node.docs) <= max_label_docs else ", ..."
            lines.append(
                f'  n{nid} [label="leaf {node.leaf_id}\\n'
                f'{len(node.docs)} docs: {docs}{more}", style=filled, '
                f'fillcolor=lightblue];')
            return nid
        kind = node.pred[0]
        label = (f"role {node.pred[1]}?" if kind == "role"
                 else "centroid side")
        lines.append(f'  n{nid} [label="{label}"];')
        li = walk(node.left)
        ri = walk(node.right)
        yes, no = ("yes", "no") if kind == "role" else ("left", "right")
        lines.append(f'  n{nid} -> n{li} [label="{yes}"];')
        lines.append(f'  n{nid} -> n{ri} [label="{no}"];')
        return nid

    walk(tree.root)
    lines.append("}")
    return "\n".join(lines)


def dump_structure(tree: QDTree) -> str:
    """An indented text dump of the tree."""
    out: List[str] = []

    def walk(node: QDNode, depth: int):
        pad = "  " * depth
        if node.leaf_id >= 0:
            out.append(f"{pad}leaf {node.leaf_id}: {len(node.docs)} docs")
            return
        kind = node.pred[0]
        desc = (f"role {node.pred[1]}" if kind == "role" else "centroid")
        out.append(f"{pad}[{desc}]")
        walk(node.left, depth + 1)
        walk(node.right, depth + 1)

    walk(tree.root, 0)
    return "\n".join(out)


def trace_query(
    tree: QDTree,
    world: RBACWorld,
    user_id: int,
    qvec: Optional[np.ndarray] = None,
    prune_by_centroid: bool = True,
) -> Dict[str, object]:
    """One query's routing trace: which predicates fired, which subtrees
    were pruned, which leaves the query lands in and why (centroid nodes
    take the nearer side, as the reference's trace does)."""
    accessible = set(world.user_docs(user_id))
    steps: List[Dict[str, object]] = []
    leaves: List[int] = []

    def walk(node: QDNode, path: str):
        if node.leaf_id >= 0:
            hit = bool(node.docs & accessible)
            steps.append({"path": path, "leaf": node.leaf_id,
                          "reachable": hit,
                          "accessible_docs_in_leaf":
                              len(node.docs & accessible)})
            if hit:
                leaves.append(node.leaf_id)
            return
        kind = node.pred[0]
        if kind == "centroid" and prune_by_centroid and qvec is not None:
            _, lc, rc = node.pred
            dl = float(((qvec - lc) ** 2).sum())
            dr = float(((qvec - rc) ** 2).sum())
            side = "left" if dl <= dr else "right"
            steps.append({"path": path, "pred": "centroid",
                          "d_left": dl, "d_right": dr, "took": side})
            walk(node.left if dl <= dr else node.right, path + "/" + side)
            return
        steps.append({"path": path,
                      "pred": f"role {node.pred[1]}" if kind == "role"
                      else "centroid (unpruned)"})
        walk(node.left, path + "/L")
        walk(node.right, path + "/R")

    walk(tree.root, "")
    return {"user_id": int(user_id), "visited_leaves": leaves,
            "n_accessible_docs": len(accessible), "steps": steps}


def list_role_partitions(tree: QDTree,
                         world: RBACWorld) -> Dict[int, List[int]]:
    """role -> the leaves holding at least one of the role's docs."""
    out: Dict[int, List[int]] = {}
    for r, docs in sorted(world.role_to_docs.items()):
        ds: Set[int] = set(docs)
        out[r] = [lid for lid, ldocs in enumerate(tree.leaf_docs)
                  if ldocs & ds]
    return out
