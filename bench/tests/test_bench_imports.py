"""Nothing the benchmark runs imports JAX or the JAX package (whole
top-level names: ``repro_torch`` is not ``repro``), nothing reads the JAX
package's benchmarks, and the reference imports nothing of the program."""
import ast

import pytest

from harness.common import BENCH, FORBIDDEN_MODULES

FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    tops = set(_imports(path))
    assert not tops & set(FORBIDDEN_MODULES), tops
    assert "benchmarks/" not in path.read_text() or path.name == "test_bench_imports.py"
    if "reference" in path.parts:
        assert "repro_torch" not in tops and "harness" not in tops


def test_the_check_compares_whole_names():
    import sys
    from harness.common import forbidden_loaded
    assert "repro_torch" not in forbidden_loaded()
    sys.modules["repro.fake_for_test"] = object()
    try:
        assert forbidden_loaded() == ["repro"]
    finally:
        del sys.modules["repro.fake_for_test"]
