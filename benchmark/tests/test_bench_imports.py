"""Nothing under benchmark/ imports JAX or the JAX package; the plain
reference imports nothing of the port. Top-level names compare whole:
the port's name begins with the JAX package's."""

from __future__ import annotations

import ast

from benchmark.harness import guard
from benchmark.tests.conftest import BENCH

JAX = {"jax", "jaxlib", "flax", "opentelemetry_demo_tpu"}
PORT = "opentelemetry_demo_tpu_torch"


def imported_tops(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not (set(imported_tops(f)) & JAX), f


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert PORT not in set(imported_tops(f)), f


def test_the_runtime_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules({PORT: 1, PORT + ".ops": 1, "numpy": 1}) == []
    assert guard.forbidden_modules({"jax.numpy": 1, "opentelemetry_demo_tpu.ops": 1}) == [
        "jax", "opentelemetry_demo_tpu"]
