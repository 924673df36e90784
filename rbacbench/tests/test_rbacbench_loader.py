"""The loader finds a cell's files by the names in BENCHMARK.json, and
refuses a missing one by name."""

import json
import shutil
from pathlib import Path

import pytest

from rbacbench import manifest
from rbacbench.manifest import ManifestError, load_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.workload["config"] == c.config["name"] == entry["config"]
    assert c.chips == entry["chips"]
    manifest.generator("corpora", c.config["corpus"]["kind"])
    manifest.generator("worlds", c.config["world"]["kind"])
    manifest.generator("traffic", c.mix["kind"])
    assert hasattr(manifest.generator("entries", c.config["port"]["entry"]),
                   "build")
    assert hasattr(manifest.generator("distances", c.config["metric"]),
                   "exact")
    assert hasattr(manifest.generator("controls", c.config["control"]),
                   "codes")
    for m in c.end_to_end:
        assert hasattr(manifest.reader("endtoend", m["name"]), "read")
    for m in c.per_layer:
        assert hasattr(manifest.reader("metrics", m["name"]), "read")
    assert set(c.workload["limits"]) == {"miss_rate", "rank_excess",
                                         "invalid_rows"}


def test_configs_name_their_files_under_paths():
    for cfg in BENCH["configs"]:
        path = ROOT / cfg["file"]
        assert path.is_file() and cfg["file"].startswith("rbacbench/")
        assert json.loads(path.read_text())["name"] == cfg["name"]


def _root_with(tmp_path, edit):
    bench = json.loads(json.dumps(BENCH))
    edit(bench)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(ROOT / "rbacbench" / "configs",
                    tmp_path / "rbacbench" / "configs")
    return tmp_path


def test_refuses_a_cell_not_in_the_manifest():
    with pytest.raises(ManifestError, match="not in BENCHMARK.json"):
        load_cell("no-such-cell")


def test_refuses_a_cell_without_its_file(tmp_path):
    def add(bench):
        bench["workloads"].append(dict(bench["workloads"][0],
                                       name="orphan-cell"))
    root = _root_with(tmp_path, add)
    with pytest.raises(ManifestError, match="orphan-cell.*no file"):
        load_cell("orphan-cell", root=root)


def test_refuses_a_file_that_names_another_config(tmp_path):
    first = BENCH["workloads"][0]["name"]

    def swap(bench):
        bench["configs"].append(dict(bench["configs"][0], name="other-cfg"))
        bench["workloads"][0]["config"] = "other-cfg"
    root = _root_with(tmp_path, swap)
    with pytest.raises(ManifestError, match="is not the manifest's"):
        load_cell(first, root=root)


def test_refuses_a_missing_config_file(tmp_path):
    first = BENCH["workloads"][0]["name"]

    def move(bench):
        for c in bench["configs"]:
            c["file"] = "rbacbench/configs/missing.json"
    root = _root_with(tmp_path, move)
    with pytest.raises(ManifestError, match="missing.json"):
        load_cell(first, root=root)


@pytest.mark.parametrize("kind", ["endtoend", "metrics"])
def test_refuses_a_metric_without_a_reader(kind):
    with pytest.raises(ManifestError, match="no_such_metric"):
        manifest.reader(kind, "no_such_metric")


@pytest.mark.parametrize("kind", ["traffic", "entries", "distances",
                                  "controls"])
def test_refuses_an_unknown_module(kind):
    with pytest.raises(ManifestError, match="no_such_kind"):
        manifest.generator(kind, "no_such_kind")


def test_metrics_name_only_cells_of_the_manifest():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
