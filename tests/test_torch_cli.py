"""The port's CLI against the reference's on the CPU: the same commands in
two artifact directories (the reference's cli.main, the port's with
--device cpu) give the same worlds for every generator, the same
query_dataset.json bytes, the same plans, the same ground-truth cache and
the same `test` ids and recall under every algorithm; the maintenance
round trip (insert-role, delete-role with its tombstones, rollback) leaves
the same worlds and plans at each step. Each package reads only its own
pickles; the test compares them by content. serve and fit-params run on
the port alone (their numbers are timings); without a card and without
--device cpu a searching subcommand exits non-zero."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import vectorsearch_rbac_tpu.bench as ref_bench
import vectorsearch_rbac_tpu_torch.bench as port_bench
from vectorsearch_rbac_tpu.cli import main as ref_main
from vectorsearch_rbac_tpu_torch.cli import main as port_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST = ["--efs", "40", "--topk", "5", "--dtype", "float32", "--block-rows",
        "512", "--index", "flat"]


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Pair:
    """The reference's CLI and the port's, each in its own directory; the
    test subcommand's run_benchmark writes its per-query records."""

    def __init__(self, tmp_path, monkeypatch):
        self.dirs = {"ref": str(tmp_path / "ref"),
                     "port": str(tmp_path / "port")}
        for pkg, side in ((ref_bench, "ref"), (port_bench, "port")):
            orig = pkg.run_benchmark

            def recording(*a, _orig=orig, _side=side, **kw):
                kw["per_query_path"] = os.path.join(self.dirs[_side],
                                                    "per_query.json")
                return _orig(*a, **kw)

            monkeypatch.setattr(pkg, "run_benchmark", recording)

    def run(self, *argv):
        ref_main(["--artifacts", self.dirs["ref"], *argv])
        port_main(["--artifacts", self.dirs["port"], "--device", "cpu",
                   *argv])

    def load(self, name):
        out = []
        for side in ("ref", "port"):
            path = os.path.join(self.dirs[side], name)
            with open(path, "rb") as f:
                out.append(pickle.load(f) if name.endswith(".pkl")
                           else f.read())
        return out

    def json(self, name):
        return [json.loads(b) for b in self.load(name)]


def assert_same_world(a, b):
    assert (a.num_users, a.num_roles, a.num_docs) == (
        b.num_users, b.num_roles, b.num_docs)
    assert dict(a.user_to_roles) == dict(b.user_to_roles)
    assert dict(a.role_to_docs) == dict(b.role_to_docs)


def assert_same_plan(a, b):
    assert a.assignment == b.assignment
    assert a.trackers == b.trackers


def assert_same_state(pair):
    ref, port = pair.load("state.pkl")
    assert_same_world(ref["world"], port["world"])
    np.testing.assert_array_equal(ref["query_pool"], port["query_pool"])
    assert {k: v for k, v in ref.items() if k not in ("world",
                                                      "query_pool")} == \
        {k: v for k, v in port.items() if k not in ("world", "query_pool")}


def assert_same_test(pair, algo):
    ref, port = pair.json(f"{algo.lower()}_results.json")
    assert ref[-1]["avg_recall"] == port[-1]["avg_recall"] == 1.0, algo
    assert ref[-1]["num_queries"] == port[-1]["num_queries"]
    rq, pq = pair.json("per_query.json")
    assert [r["result_rows"] for r in rq] == [r["result_rows"] for r in pq]
    assert [r["recall"] for r in rq] == [r["recall"] for r in pq]


@pytest.mark.parametrize("generator", ["tree", "sharing_tree", "erbac",
                                       "random", "arxiv_business"])
def test_prepare_and_queries_match_reference(generator, tmp_path,
                                             monkeypatch):
    pair = Pair(tmp_path, monkeypatch)
    # ERBAC and random draw up to 300 documents a role (m_perms)
    pair.run("prepare", "--dataset", "synthetic", "--n", "40000",
             "--generator", generator, "--num-roles", "10", "--num-users",
             "40", "--seed", "2")
    assert_same_state(pair)
    pair.run("generate-queries", "--num-queries", "15", "--topk", "4",
             "--zipf", "2.5", "--repetitions", "2", "--seed", "1")
    ref, port = pair.load("query_dataset.json")
    assert ref == port
    pair.run("generate-queries", "--per-role", "2", "--topk", "3")
    ref, port = pair.load("query_dataset.json")
    assert ref == port


def test_pipeline_matches_reference(tmp_path, monkeypatch):
    pair = Pair(tmp_path, monkeypatch)
    pair.run("prepare", "--dataset", "synthetic", "--n", "2000",
             "--generator", "tree", "--num-roles", "10", "--num-users", "50",
             "--seed", "3")
    pair.run("generate-queries", "--num-queries", "12", "--topk", "5")
    pair.run("plan-dynamic", "--storage", "2.0")
    assert_same_plan(*pair.load("dynamic_plan.pkl"))
    for algo in ("RLS", "ROLE", "USER", "AnonySys", "QDTree"):
        pair.run("test", "--algorithm", algo, *TEST)
        assert_same_test(pair, algo)
    pair.run("compute-ground-truth", "--topk", "4", "--block-rows", "512")
    ref, port = pair.json("ground_truth_cache.json")
    assert ref == port and port["num_queries"] == 12


def test_maintenance_roundtrip_matches_reference(tmp_path, monkeypatch,
                                                 capsys):
    pair = Pair(tmp_path, monkeypatch)
    pair.run("prepare", "--dataset", "synthetic", "--n", "2000",
             "--generator", "tree", "--num-roles", "10", "--num-users", "50",
             "--seed", "5")
    pair.run("generate-queries", "--num-queries", "16", "--topk", "5")
    pair.run("plan-dynamic", "--storage", "2.0")
    world0 = pair.load("state.pkl")[1]["world"]

    def printed():
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
                 if x.startswith("{")]
        assert len(lines) == 2 and lines[0] == lines[1]
        return lines[1]

    capsys.readouterr()
    pair.run("insert-role", "--assign-users", "3", "--seed", "11")
    assert printed()["new_role"] == world0.num_roles
    assert_same_state(pair)
    assert_same_plan(*pair.load("dynamic_plan.pkl"))
    pair.run("insert-role", "--docs", "7", "--seed", "4")
    assert printed()["num_docs"] == 7
    assert_same_state(pair)
    assert_same_plan(*pair.load("dynamic_plan.pkl"))
    pair.run("test", "--algorithm", "AnonySys", *TEST)
    assert_same_test(pair, "AnonySys")

    from vectorsearch_rbac_tpu_torch.partition.dynamic.maintenance import (
        orphaned_docs_after_role_delete)
    world1 = pair.load("state.pkl")[1]["world"]
    victim = next(r for r in range(world0.num_roles)
                  if orphaned_docs_after_role_delete(world1, r))
    capsys.readouterr()
    pair.run("delete-role", "--role", str(victim))
    assert printed()["orphaned_docs"] > 0
    assert_same_state(pair)
    assert_same_plan(*pair.load("dynamic_plan.pkl"))
    for algo in ("AnonySys", "RLS"):
        pair.run("test", "--algorithm", algo, *TEST)
        assert_same_test(pair, algo)
    pair.run("compute-ground-truth", "--topk", "5", "--block-rows", "512")
    ref, port = pair.json("ground_truth_cache.json")
    assert ref == port
    pair.run("rollback")
    assert_same_state(pair)
    port_state = pair.load("state.pkl")[1]
    assert victim in port_state["world"].role_to_docs
    assert_same_world(port_state["world"], world1)
    with pytest.raises(SystemExit):
        port_main(["--artifacts", str(tmp_path / "empty"), "rollback"])


def test_serve_and_fit_params_run_on_the_port(tmp_path):
    art = str(tmp_path)
    base = ["--artifacts", art, "--device", "cpu"]
    port_main(base + ["prepare", "--dataset", "synthetic", "--n", "1500",
                      "--generator", "tree", "--num-roles", "8",
                      "--num-users", "30", "--seed", "8"])
    port_main(base + ["generate-queries", "--num-queries", "24", "--topk",
                      "5"])
    port_main(base + ["serve", "--algorithm", "RLS", "--clients", "4",
                      "--duration", "0.5", "--topk", "5", "--dtype",
                      "float32", "--block-rows", "512", "--index", "flat",
                      "--max-wait-ms", "2"])
    with open(os.path.join(art, "serve_results.json")) as f:
        rep = json.load(f)
    assert rep["requests"] > 0 and rep["qps"] > 0 and rep["avg_batch"] >= 1
    from vectorsearch_rbac_tpu_torch.models.cost import (CostModelParams,
                                                         IVFCoverageParams)
    from vectorsearch_rbac_tpu_torch.utils.persist import load_params
    for index, efs, cls in (("ivf", ["2", "4", "8"], IVFCoverageParams),
                            ("hnsw", ["8", "16", "32"], CostModelParams)):
        port_main(base + ["fit-params", "--index", index, "--efs", *efs,
                          "--topk", "5", "--num-queries", "16", "--nlist",
                          "16", "--block-rows", "512"])
        params = load_params(os.path.join(art, f"parameter_{index}.json"))
        assert isinstance(params, cls)
        with open(os.path.join(art, "model_validation.json")) as f:
            assert np.isfinite(json.load(f)["recall_mae"])
    # the planner and `test` take the fitted parameters of their family;
    # the IVF coverage family is not the planner's (the reference raises
    # an AttributeError reading its beta)
    for index in ("hnsw", "ivf"):
        port_main(base + ["test", "--algorithm", "AnonySys", "--efs", "8",
                          "--topk", "5", "--dtype", "float32",
                          "--block-rows", "512", "--index", index])
        with open(os.path.join(art, "anonysys_results.json")) as f:
            assert json.load(f)[-1]["num_queries"] == 24


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
def test_searching_subcommand_refuses_without_a_card(tmp_path):
    with pytest.raises(SystemExit) as e:
        port_main(["--artifacts", str(tmp_path), "test", "--algorithm",
                   "RLS"])
    assert "--device cpu" in str(e.value.code)
    p = subprocess.run(
        [sys.executable, "-m", "vectorsearch_rbac_tpu_torch.cli",
         "--artifacts", str(tmp_path), "compute-ground-truth"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode != 0 and "no CUDA device" in p.stderr
    p = subprocess.run(
        [sys.executable, "-m", "vectorsearch_rbac_tpu_torch.cli", "--help"],
        capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert p.returncode == 0
    for cmd in ("prepare", "generate-queries", "plan-dynamic", "insert-role",
                "delete-role", "compute-ground-truth", "serve", "rollback",
                "fit-params", "test"):
        assert cmd in p.stdout


_JAX_FREE_SURFACE = """
import sys, tempfile
import vectorsearch_rbac_tpu_torch.bench.anonysys_10m
import vectorsearch_rbac_tpu_torch.bench.cold_start
import vectorsearch_rbac_tpu_torch.bench.result_cache
import vectorsearch_rbac_tpu_torch.bench.serving
import vectorsearch_rbac_tpu_torch.index.base
import vectorsearch_rbac_tpu_torch.models.fitting
import vectorsearch_rbac_tpu_torch.models.validate
import vectorsearch_rbac_tpu_torch.utils.persist
import vectorsearch_rbac_tpu_torch.utils.tracing
from vectorsearch_rbac_tpu_torch.cli import main
from vectorsearch_rbac_tpu_torch.data import HashingEmbedder
d = tempfile.mkdtemp()
b = ["--artifacts", d, "--device", "cpu"]
main(b + ["prepare", "--dataset", "synthetic", "--n", "1000",
          "--num-roles", "6", "--num-users", "20"])
main(b + ["generate-queries", "--num-queries", "6", "--topk", "3"])
main(b + ["plan-dynamic"])
main(b + ["test", "--algorithm", "AnonySys", "--topk", "3", "--dtype",
          "int8", "--block-rows", "512"])
HashingEmbedder().embed(["a b"])
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "jaxlib", "vectorsearch_rbac_tpu")]
assert not bad, bad[:5]
print("JAX_FREE_OK")
"""


def test_surface_never_imports_jax():
    """The CLI, the new runners and modules import and run (prepare to an
    AnonySys test on the int8 arena) in a fresh interpreter without
    loading jax or the reference package."""
    p = subprocess.run([sys.executable, "-c", _JAX_FREE_SURFACE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "JAX_FREE_OK" in p.stdout
