"""The port and its chip script import no JAX, flax or optax (AST scan)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "bayesic_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = {"jax", "jaxlib", "flax", "optax", "bayesic_tpu"}


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_files_found():
    assert len(FILES) > 15


@pytest.mark.parametrize("path", FILES,
                         ids=[str(f.relative_to(ROOT)) for f in FILES])
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = sorted(set(_imported_roots(tree)) & BANNED)
    assert not bad, f"{path} imports {bad}"
