"""The result line's keys, and the run's refusal without a card."""

import json
import subprocess
import sys
from pathlib import Path

import torch

from tiny_cell import run_tiny, tiny_cell

ROOT = Path(__file__).resolve().parents[2]
REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
EXTRA = {"setup", "checks"}


def _keys_ok(line, traced):
    keys = list(line)
    assert keys[:5] == REQUIRED
    assert set(keys) == set(REQUIRED) | EXTRA | ({"breakdown"} if traced
                                                 else set())
    assert keys[-1] == "checks"
    for name, chk in line["checks"].items():
        assert set(chk) == {"value", "limit"}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"}
    json.dumps(line)


def test_untraced_line_carries_the_end_to_end_metrics():
    cell = tiny_cell()
    line = run_tiny(cell)
    _keys_ok(line, traced=False)
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["attempted"] == line["setup"]["calls"] * 512
    assert line["metrics"]["qps"]["value"] > 0


def test_traced_line_carries_breakdown_and_window():
    line = run_tiny(tiny_cell(), traced=True)
    _keys_ok(line, traced=True)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: the device readers find nothing
    assert "scan_roofline_pct" not in line["metrics"]
    assert "quantize_upload_ms" in line["metrics"]


def test_run_exits_without_a_result_on_the_cpu():
    if torch.cuda.is_available():
        return   # the refusal is for a machine without a card
    out = subprocess.run(
        [sys.executable, "rbacbench/run.py", "--workload",
         "sift10m-rls-bulk", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 2 and out.stdout == ""


def test_run_exits_without_the_program(tmp_path):
    # a checkout that holds only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "rbacbench", tmp_path / "rbacbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "rbacbench/run.py", "--workload",
         "sift10m-rls-bulk", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
    assert "vectorsearch_rbac_tpu_torch" in out.stderr
