"""Nothing under portbench/ imports JAX, flax, optax or the JAX package
(compared by whole top-level name: the measured package's name begins
with the JAX package's), and the reference imports nothing of the
measured package nor of the harness."""
import ast
import sys
from pathlib import Path

import pytest

from harness.cells import BENCH
from harness.runner import FORBIDDEN, forbidden_modules


def _imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not set(_imports(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert not set(_imports(path)) & {"hpvaegan_tpu_torch", "harness"}


def test_forbidden_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "hpvaegan_tpu_torch_lookalike",
                        sys.modules[__name__])
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "hpvaegan_tpu.ops", sys.modules[__name__])
    assert forbidden_modules() == ["hpvaegan_tpu"]
