"""The system under test: the PyTorch and CUDA port, built by the entry
that a configuration's `port` block names (`"entry": <name>`):
`rbacbench/entries/<name>.py`, whose `build(config, corpus, world,
device)` returns a `System`. A later entry (a server, another searcher)
adds its own file.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, fields, is_dataclass
from typing import Callable, Mapping


def framework_config(spec: Mapping):
    """A FrameworkConfig with the fields of spec set, nested as there
    (`search`, `index`, `optimizer`); an unknown field raises."""
    from vectorsearch_rbac_tpu_torch.config import FrameworkConfig

    cfg = FrameworkConfig()

    def fill(obj, values: Mapping, path: str) -> None:
        names = {f.name for f in fields(obj)}
        for key, val in values.items():
            if key not in names:
                raise ValueError(f"{path}{key}: no such FrameworkConfig field")
            cur = getattr(obj, key)
            if is_dataclass(cur):
                fill(cur, val, f"{path}{key}.")
            else:
                setattr(obj, key, val)

    fill(cfg, spec, "")
    return cfg


def compile_kernels() -> dict:
    """Build (or load) the program's kernel library, timed: the first run
    in a checkout compiles, later ones load."""
    from vectorsearch_rbac_tpu_torch.ops import _build

    built = _build.library_path().is_file()
    t0 = time.perf_counter()
    _build.lib()
    return {"compile_s": time.perf_counter() - t0, "was_built": built}


@dataclass
class System:
    search: Callable            # (queries, user_ids, k) -> (dists, ids)
    close: Callable[[], None]   # drop every reference to the device state


def build(config: Mapping, corpus, world, device) -> System:
    """The system under test over the harness's corpus and world."""
    from .manifest import generator

    return generator("entries", config["port"]["entry"]).build(
        config, corpus, world, device)
