"""Nothing the benchmark runs imports JAX or the JAX package: an AST scan
of every benchmark file, and the run's own check of ``sys.modules``, both by
whole top-level module names (``clipx_torch`` is not ``clipx``)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import ROOT


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_benchmark_file_imports_jax_or_clipx():
    bad = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                bad += [(path, m) for m in _imports(path)
                        if harness.forbidden_modules([m])]
    assert not bad


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(ROOT, "benchmark", "reference")):
        if name.endswith(".py"):
            mods = list(_imports(os.path.join(ROOT, "benchmark",
                                              "reference", name)))
            assert not [m for m in mods if m.split(".")[0] == "clipx_torch"]


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["clipx", "clipx.models.clip", "jax", "jax.numpy", "jaxlib", "flax",
         "clipx_torch", "clipx_torch.serve", "jaxtyping", "flaxen",
         "numpy"]) == ["clipx", "clipx.models.clip", "flax", "jax",
                       "jax.numpy", "jaxlib"]


def test_a_run_loads_no_jax(tiny_root):
    code = ("import sys, time, torch; from benchmark import harness; "
            "harness.run_cell('tiny-query-pq', 1, 0.3, True, "
            "device=torch.device('cpu'), started=time.perf_counter(), "
            f"root={tiny_root!r}); "
            "print(harness.forbidden_modules(list(sys.modules)))")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
