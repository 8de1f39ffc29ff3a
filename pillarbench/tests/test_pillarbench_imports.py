"""No module of the benchmark imports JAX or the JAX package, and none of
the reference imports the program. Top-level names are compared whole,
so ``tpu_pillars_torch`` is not ``tpu_pillars``."""

import ast

import pytest

from pillarbench.cells import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpu_pillars"}
SOURCES = sorted(p for p in HERE.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "tpu_pillars_torch" not in top_level_imports(path)


def test_names_are_compared_whole():
    from pillarbench.run import FORBIDDEN as RUN_FORBIDDEN, loaded_forbidden

    assert "tpu_pillars" in RUN_FORBIDDEN
    import tpu_pillars_torch  # noqa: F401

    assert "tpu_pillars_torch" not in loaded_forbidden()
