"""The import guard: no JAX, and no JAX package, in a benchmark process.

A module counts by its top-level name, the part before the first dot,
compared whole: `vectorsearch_rbac_tpu_torch` (the program) is not
`vectorsearch_rbac_tpu` (the JAX package it was ported from).
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vectorsearch_rbac_tpu"})
PROGRAM = "vectorsearch_rbac_tpu_torch"


def top_names(modules: Optional[Iterable[str]] = None) -> set:
    return {name.split(".", 1)[0]
            for name in (sys.modules if modules is None else modules)}


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among the loaded modules, sorted."""
    return sorted(top_names(modules) & FORBIDDEN)


def check(where: str) -> None:
    """Raise SystemExit(3), naming what loaded, if a forbidden module is
    in this process."""
    found = forbidden_loaded()
    if found:
        print(f"import guard ({where}): forbidden modules loaded: "
              f"{', '.join(found)}", file=sys.stderr, flush=True)
        raise SystemExit(3)
