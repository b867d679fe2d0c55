"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's)."""

import ast

import pytest

from perfbench import harness

from conftest import ROOT


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "perfbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax(path):
    assert not set(imported_tops(path)) & set(harness.FORBIDDEN)


def test_whole_top_level_names():
    assert harness.forbidden_modules({"torchmdnet_tpu_torch": 1,
                                      "torchmdnet_tpu_torch.ops": 1}) == []
    assert harness.forbidden_modules(
        {"torchmdnet_tpu": 1, "jax.numpy": 1, "jaxlib": 1, "flax": 1,
         "optax": 1, "jaxtyping": 1}) == [
        "flax", "jax.numpy", "jaxlib", "optax", "torchmdnet_tpu"]
