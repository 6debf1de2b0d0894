"""Nothing under perfbench/ imports JAX, the JAX package or the JAX
package's benchmarks, and the reference imports nothing of the port:
every import's top-level name is compared whole."""

import ast

import pytest

from perfbench import harness, spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
FILES = sorted(p for p in spec.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(spec.HERE)))
def test_no_jax_or_reference_package(path):
    found = top_level_imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if "reference" in path.relative_to(spec.HERE).parts:
        assert "repro_torch" not in found


def test_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "reprox", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "numpy"]) == ["repro"]
    assert harness.forbidden_modules(["jax.numpy", "flax"]) == ["flax",
                                                                "jax"]
