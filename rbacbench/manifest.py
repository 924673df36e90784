"""Find a cell's files by the names in BENCHMARK.json.

- `rbacbench/workloads/<cell>.json`: the cell's configuration and traffic
  names (equal to the manifest's), its check's limits;
- the configuration's `file` from the manifest (`rbacbench/configs/`);
- `rbacbench/mixes/<traffic>.json`: the traffic's parameters; its `kind`
  names the module `rbacbench/traffic/<kind>.py` that sends it;
- `rbacbench/corpora/<kind>.py` and `rbacbench/worlds/<kind>.py`: the
  generators a configuration's `corpus` and `world` blocks name;
- `rbacbench/entries/<entry>.py`: how the program is built and called,
  named by the configuration's `port.entry` (port.py);
- `rbacbench/distances/<metric>.py` and `rbacbench/controls/<control>.py`:
  the reference's distance and the control's codes, named by the
  configuration's `metric` and `control` (reference.py);
- `rbacbench/endtoend/<metric>.py` and `rbacbench/metrics/<metric>.py`:
  one reader a metric.

A missing entry or file raises `ManifestError` naming it. Later cells,
configurations, traffic kinds and metrics add files and entries; nothing
here changes for them.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class ManifestError(RuntimeError):
    pass


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict        # rbacbench/workloads/<cell>.json
    config: dict          # the configuration's file
    mix: dict             # rbacbench/mixes/<traffic>.json
    end_to_end: List[dict]
    per_layer: List[dict]


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise ManifestError(f"{what}: no file {path}")
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, what: str) -> ModuleType:
    if not path.is_file():
        raise ManifestError(f"{what}: no file {path}")
    name = "rbacbench_" + "_".join(
        path.relative_to(HERE).with_suffix("").parts).replace("-", "_"
                                                               ).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def reader(kind: str, name: str) -> ModuleType:
    """The reader module of an end-to-end ("endtoend") or per-layer
    ("metrics") metric."""
    return load_module(HERE / kind / f"{name}.py", f"{kind} reader {name!r}")


def generator(kind: str, name: str) -> ModuleType:
    """A corpus ("corpora"), world ("worlds"), traffic ("traffic"), entry
    ("entries"), distance ("distances") or control ("controls") module."""
    return load_module(HERE / kind / f"{name}.py", f"{kind} {name!r}")


def _reports(metric: dict, cell: str) -> bool:
    """Whether a cell reports a metric: one with a `workloads` key only in
    the cells it lists (those where its reader finds something to read)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Optional[Path] = None) -> Cell:
    root = ROOT if root is None else root
    bench = _json(root / "BENCHMARK.json", "the manifest")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise ManifestError(f"cell {name!r} is not in BENCHMARK.json")
    cfg_entry = next((c for c in bench["configs"]
                      if c["name"] == entry["config"]), None)
    if cfg_entry is None:
        raise ManifestError(f"configuration {entry['config']!r} of cell "
                            f"{name!r} is not in BENCHMARK.json")
    workload = _json(HERE / "workloads" / f"{name}.json", f"cell {name!r}")
    for key in ("config", "traffic"):
        if workload.get(key) != entry[key]:
            raise ManifestError(f"cell {name!r}: its file's {key} "
                                f"{workload.get(key)!r} is not the "
                                f"manifest's {entry[key]!r}")
    config = _json(root / cfg_entry["file"],
                   f"configuration {entry['config']!r}")
    mix = _json(HERE / "mixes" / f"{entry['traffic']}.json",
                f"traffic {entry['traffic']!r}")
    return Cell(name=name, chips=int(entry["chips"]), workload=workload,
                config=config, mix=mix,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])
