"""What the benchmark may import: nothing of JAX or the JAX package, and
its reference nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "light_unet_tpu"}


def imported_tops(path: Path) -> set:
    """Top-level names of every module ``path`` imports (absolute imports)."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "light_unet_tpu_torch" not in tops
    text = path.read_text()
    for node in ast.walk(ast.parse(text)):  # of the benchmark, only the reference itself
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("cellbench"):
            assert node.module.startswith("cellbench.reference"), node.module


def test_top_level_names_compared_whole():
    assert "light_unet_tpu_torch".split(".")[0] not in FORBIDDEN


def test_a_run_loads_no_jax():
    """Importing the harness, every driver and the program's modules they
    use leaves no forbidden top-level name in ``sys.modules``."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from cellbench import harness, run, control\n"
        "for d in ('serve_raw', 'infer_stage'): harness.load_module('drivers', d)\n"
        "import light_unet_tpu_torch.core.inferencer\n"
        "import light_unet_tpu_torch.ops.fused\n"
        "print(harness.forbidden_modules())\n" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
