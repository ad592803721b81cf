"""The benchmark measures the port alone: no module it runs imports jax,
jaxlib, flax or the JAX package (top-level module names compared whole:
the port's own name begins with the JAX package's), the reference imports
nothing of the port, a run that finds any of them loaded prints no
result, and a run without a CUDA device, or without the port beside the
benchmark, fails and prints no result."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gfxexp_tpu"}
SOURCES = sorted(p for p in pathlib.Path(BENCH).rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax_in_sources(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(pathlib.Path(BENCH, "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert set(_imports(path)) <= {"__future__", "math", "numpy", "torch",
                                   "reference"}


_BLOCKED_RUN = r"""
import sys
for name in ("jax", "jaxlib", "flax", "gfxexp_tpu"):
    sys.modules[name] = None  # importing any of them now fails
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
import harness
rc, res = harness.run_cell("cornellbox.restir_rearch", 5, 0.2, False, device="cpu",
                           size=(32, 18))
assert rc == 0 and res["correct"], (rc, res)
"""

_LOADED_RUN = r"""
import sys, types
sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2])
sys.modules["jaxlib"] = types.ModuleType("jaxlib")
import harness
rc, res = harness.run_cell("cornellbox.restir_rearch", 5, 0.2, False, device="cpu",
                           size=(32, 18))
sys.exit(rc)
"""


def test_runs_with_jax_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, BENCH, ROOT],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]


def test_loaded_jax_refuses_the_result():
    out = subprocess.run([sys.executable, "-c", _LOADED_RUN, BENCH, ROOT],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 3 and '"correct"' not in out.stdout
    assert "jaxlib" in out.stderr


def _run_py(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cornellbox.restir_rearch",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the card test runs the cell")
    out = _run_py(ROOT)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run_py(tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout
