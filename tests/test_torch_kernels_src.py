"""PyTorch port: static checks of the CUDA kernels and their wrappers.

The kernels cannot run here (no card, no nvcc), so these checks guard the
rules that keep them honest: every ``csrc/*.cu`` exports a C entry that
``ops/_build.py`` binds with the right number of arguments, every wrapper
counts its launches and checks the returned CUDA error, and no wrapper
catches an exception around a launch (no silent fallback)."""

import ast
import inspect
import re
from pathlib import Path

import pytest

from light_unet_tpu_torch.ops import _build, block_kernel, norm_kernel

CSRC = Path(_build.CSRC)
SOURCES = sorted(CSRC.glob("*.cu"))
WRAPPERS = {
    "instance_norm": (norm_kernel, "fused_instance_norm_leaky_relu", "instance_norm_leaky"),
    "residual_block": (block_kernel, "fused_residual_block", "residual_block"),
}


def _c_entries(src: str) -> dict:
    """``extern "C" int name(args)`` -> number of parameters."""
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src):
        out[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    return out


def test_every_source_is_built_and_wrapped():
    assert [p.stem for p in SOURCES] == sorted(_build.ENTRIES) == sorted(WRAPPERS)


@pytest.mark.parametrize("src", SOURCES, ids=lambda p: p.name)
def test_c_entries_match_the_bindings(src):
    entries = _c_entries(src.read_text())
    bound = _build.ENTRIES[src.stem]
    assert bound, src.name
    for name, argtypes in bound.items():
        assert name in entries, f"{src.name} has no C entry {name}"
        assert entries[name] == len(argtypes), (name, entries[name], len(argtypes))


@pytest.mark.parametrize("src", SOURCES, ids=lambda p: p.name)
def test_source_notes(src):
    """Each source names the TPU kernel it replaces and what bounds it."""
    text = src.read_text()
    assert "Replaces the Pallas TPU kernel light_unet_tpu/ops/" in text
    assert "Bound on the card" in text
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


def _function_node(module, name):
    tree = ast.parse(inspect.getsource(module))
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _function_source(module, name):
    return ast.get_source_segment(inspect.getsource(module), _function_node(module, name))


@pytest.mark.parametrize("lib", sorted(WRAPPERS))
def test_wrapper_counts_launches_and_checks_errors(lib):
    module, wrapper, entry = WRAPPERS[lib]
    assert isinstance(module.launches, int)
    body = _function_source(module, wrapper)
    assert f'_build.load("{lib}")' in body
    assert f"lib.{entry}(" in body
    # the error check follows the launch, and the count follows the check
    assert body.index(f"lib.{entry}(") < body.index("_build.check(") < body.index("launches += 1")
    assert body.count("launches += 1") == 1


@pytest.mark.parametrize("lib", sorted(WRAPPERS))
def test_wrapper_has_no_fallback(lib):
    """No try/except around a build or launch: a CUDA tensor launches the
    kernel or raises; only a CPU tensor takes the plain version."""
    module, wrapper, _ = WRAPPERS[lib]
    node = _function_node(module, wrapper)
    assert not [n for n in ast.walk(node) if isinstance(n, ast.Try)]
    assert not [n for n in ast.walk(_function_node(_build, "load")) if isinstance(n, ast.Try)]
    body = _function_source(module, wrapper)
    plain = body.index('if x.device.type == "cpu":')
    assert plain < body.index("_build.load(")
