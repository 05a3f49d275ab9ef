"""No file of the benchmark imports JAX or the JAX package, compared by
whole top-level names (`htd_tpu_torch` begins with `htd_tpu` and is not
it), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from bench_h100.harness import BENCH, FORBIDDEN, forbidden_modules

# the one test that holds the reference to the program imports both
BOTH = "test_bench_reference.py"


def imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


FILES = sorted(p for p in BENCH.rglob("*.py") if p.name != BOTH)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(imported(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(imported(path)) & {"htd_tpu_torch", "htd_tpu", "jax", "flax", "jaxlib"}


def test_whole_names():
    assert forbidden_modules(["htd_tpu_torch", "htd_tpu_torch.apis", "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["htd_tpu.models", "flax.core", "jax", "jaxlib.xla"]) == [
        "flax", "htd_tpu", "jax", "jaxlib"]
