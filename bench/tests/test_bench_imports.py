"""Nothing under bench/ imports JAX or the JAX package (top-level names
compared whole), bench/reference/ imports nothing of the port, and no
file names the JAX package's folder of benchmarks."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(BENCH.rglob("*.py"))
JAX_BENCHMARKS = "bench" + "marks/"     # spelled apart: not a hit itself


def tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            out.add(node.args[0].value.split(".", 1)[0])
    return out


def test_files_found():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in tops(path)
    assert not [t for t in tops(path) if t not in (
        "__future__", "numpy", "torch", "math")]


def test_whole_names_compared():
    # the port's name begins with the JAX package's: it is allowed
    assert "repro_torch" in tops(BENCH / "harness.py")
    assert "repro_torch".split(".", 1)[0] not in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_reads_the_jax_benchmarks(path):
    assert JAX_BENCHMARKS not in path.read_text()
