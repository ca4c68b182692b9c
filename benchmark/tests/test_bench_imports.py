"""What a run may import, and what it does without a card."""

import ast
import glob
import os
import shutil
import subprocess
import sys

from harness.core import BENCH_DIR, FORBIDDEN_MODULES, ROOT

CLI = [sys.executable, os.path.join("benchmark", "run.py"), "--workload", "selfplay_cramped",
       "--seed", "4294967301", "--seconds", "1", "--trace", "0"]


def _no_card_env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def _imports(path):
    """The top-level names a source file imports (relative imports: '.')."""
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add("." if node.level else node.module.split(".")[0])
    return names


def test_a_run_without_a_card_exits_non_zero_with_no_result():
    out = subprocess.run(CLI, cwd=ROOT, capture_output=True, text=True, env=_no_card_env(),
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_run_beside_nothing_but_the_benchmark_exits_non_zero(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run(CLI, cwd=tmp_path, capture_output=True, text=True, env=_no_card_env(),
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(BENCH_DIR, "**", "*.py"), recursive=True):
        assert not _imports(path) & set(FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(BENCH_DIR, "reference", "*.py")):
        assert _imports(path) <= {"__future__", ".", "ast", "dataclasses", "numpy", "struct",
                                  "torch", "typing"}, path
    code = ("import sys; sys.path.insert(0, 'benchmark'); import pkgutil, importlib, reference; "
            "[importlib.import_module('reference.' + m.name) "
            " for m in pkgutil.iter_modules(reference.__path__)]; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = set(eval(out.stdout))
    assert "overcooked_ai_tpu_torch" not in loaded and not loaded & set(FORBIDDEN_MODULES)


def test_a_whole_cpu_run_of_every_cell_loads_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', 'benchmark/tests', '.']; "
            "from cpu_run import TINY, cpu_run; from harness import core; "
            "[cpu_run(c) for c in sorted(TINY)]; print(core.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
