"""What the benchmark may import and read: no module under edgebench/ imports
jax, jaxlib, flax or the JAX package (top-level names compared whole, so
repro_torch passes); the reference imports nothing of the port; nothing
reads the JAX package's benchmarks/ folder."""
import ast
from pathlib import Path

import pytest

EDGE = Path(__file__).resolve().parents[1]
FILES = sorted(EDGE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(EDGE)))
def test_no_jax_import(path):
    assert not set(top_names(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for path in sorted((EDGE / "reference").rglob("*.py")):
        names = set(top_names(path))
        assert "repro_torch" not in names, path
        assert names <= {"__future__", "math", "typing", "torch", "edgebench"}, (path, names)


def test_whole_name_comparison():
    assert "repro_torch.serving".split(".")[0] not in FORBIDDEN
    assert "repro.core".split(".")[0] in FORBIDDEN


def test_nothing_reads_the_jax_benchmark():
    for path in FILES:
        if path.name == Path(__file__).name:
            continue
        assert "benchmarks/" not in path.read_text(), path
