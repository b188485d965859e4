"""Nothing of the benchmark imports JAX or the JAX package, by top-level
module names compared whole (the port's name begins with the JAX
package's), and nothing reads the JAX package's benchmarks."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

PORTBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PORTBENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _sources():
    for d, _, files in os.walk(PORTBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    files = list(_sources())
    assert len(files) > 10
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        bad = sorted(set(_imported(tree)) & FORBIDDEN)
        if bad:
            found[os.path.relpath(path, ROOT)] = bad
    assert not found


def test_no_source_names_the_jax_packages_benchmarks():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                words = node.value.replace("\\", "/").split("/")
                assert "benchmarks" not in words[:-1], path


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    base = set(harness.foreign_modules())
    for name in ("repro_torch_x", "reprox", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.foreign_modules()) == base
    monkeypatch.setitem(sys.modules, "repro.core.fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(harness.foreign_modules()) == base | {"repro", "jaxlib"}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from portbench import harness\n"
        "from portbench.tests.cases import TINY\n"
        "harness.run_cell('ycsb-32g-z099.load', 1, 0.1, True, "
        "device='cpu', overrides=TINY)\n"
        "print(json.dumps(harness.foreign_modules()))\n"
        % (ROOT, os.path.join(ROOT, "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("only_paths", [False, True])
def test_the_command_prints_no_result_without_a_card_or_without_src(
        tmp_path, only_paths):
    cwd = ROOT
    if only_paths:
        import shutil
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        shutil.copytree(PORTBENCH, tmp_path / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ycsb-32g-z099.read_only", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env)
    assert out.returncode != 0
    assert "correct" not in out.stdout
