"""The import guard, and the reference's independence of the program."""

import subprocess
import sys
from pathlib import Path

from rbacbench import guard

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_names_by_whole_top_level_name():
    assert guard.forbidden_loaded(["numpy", "vectorsearch_rbac_tpu_torch",
                                   "vectorsearch_rbac_tpu_torch.core"]) == []
    assert guard.forbidden_loaded(["vectorsearch_rbac_tpu.core", "jax.numpy",
                                   "jaxlib", "flax.linen", "jaxy"]) == [
        "flax", "jax", "jaxlib", "vectorsearch_rbac_tpu"]


def _modules_after(imports: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; {imports}; "
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_reference_and_judge_load_nothing_of_the_program():
    tops = _modules_after("import rbacbench.reference, rbacbench.judge, "
                          "rbacbench.roofline, rbacbench.trace; "
                          "from rbacbench import manifest; "
                          "rbacbench.reference.metric('l2'); "
                          "manifest.generator('controls', 'int4')")
    assert guard.PROGRAM not in tops
    assert not tops & guard.FORBIDDEN


def test_harness_loads_no_jax():
    tops = _modules_after("import rbacbench.harness, rbacbench.port; "
                          "import vectorsearch_rbac_tpu_torch.partition, "
                          "vectorsearch_rbac_tpu_torch.core")
    assert not tops & guard.FORBIDDEN


def test_run_refuses_a_loaded_jax_package(tmp_path):
    # a stand-in module named like the JAX package, loaded before the run
    (tmp_path / "vectorsearch_rbac_tpu.py").write_text("")
    out = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(tmp_path)!r}); "
         "import vectorsearch_rbac_tpu; sys.argv = ['run', '--workload', "
         "'sift10m-rls-bulk', '--seed', '1', '--seconds', '1']; "
         "import runpy; runpy.run_path('rbacbench/run.py', "
         "run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 3
    assert out.stdout == ""
    assert "vectorsearch_rbac_tpu" in out.stderr
