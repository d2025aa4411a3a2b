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

from light_unet_tpu_torch.ops import _build, block_kernel, ccl_kernel, depthwise_kernel, norm_kernel

CSRC = Path(_build.CSRC)
SOURCES = sorted(CSRC.glob("*.cu"))
WRAPPERS = {
    "ccl": (ccl_kernel, "connected_labels", "ccl_label"),
    "depthwise_conv": (depthwise_kernel, "depthwise_conv3d", "depthwise_conv3d"),
    "instance_norm": (norm_kernel, "fused_instance_norm_leaky_relu", "instance_norm_leaky"),
    "residual_block": (block_kernel, "fused_residual_block", "residual_block"),
}
# what each source replaces: a Pallas TPU kernel, or (the CCL kernel) the
# lax sweeps of a device loop that has no Pallas kernel, or (the depthwise
# conv) nothing: the JAX package leaves that conv to XLA
REPLACES = {"ccl": "Replaces the lax sweeps of light_unet_tpu/ops/ccl.py:label_propagate",
            "depthwise_conv": "Replaces no TPU kernel: the JAX package leaves this conv to XLA"}


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
    """Each source names the TPU kernel (or the JAX device loop) it replaces
    and what bounds it."""
    text = src.read_text()
    assert REPLACES.get(src.stem, "Replaces the Pallas TPU kernel light_unet_tpu/ops/") in text
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


BLOCK_SRC = CSRC / "residual_block.cu"


def test_block_kernel_uses_tensor_cores_in_bf16():
    """The bf16 pointwise products name their tensor-core instruction, read A
    through ldmatrix, and the wrapper packs the weights as mma fragments."""
    text = BLOCK_SRC.read_text()
    assert re.search(r"\bw?gmma\b|mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16\.bf16\.f32",
                     text)
    assert "ldmatrix.sync.aligned" in text
    assert "_as_mma_fragments" in _function_source(block_kernel, "kernel_weights")


def test_block_kernel_has_no_separate_norm_apply_pass():
    """norm1 is applied while conv2 stages its halo: no in-place apply launch."""
    text = BLOCK_SRC.read_text()
    assert "launch_in_apply" not in text and "in_apply_kernel" not in text
    assert "conv2_mma" in text and "APPLY" in text


def test_block_kernel_statistics_have_no_shared_atomics():
    """Norm statistics reduce in registers and shuffles; the only atomics are
    the float64 adds to the [B, C, 2] statistics in device memory."""
    text = BLOCK_SRC.read_text()
    assert not re.search(r"atomicAdd\(\s*&?\s*s_", text)
    assert "__shfl_xor_sync" in text
    code = [ln for ln in text.splitlines() if "atomicAdd(" in ln and not ln.strip().startswith("//")]
    assert code and all(", (double)" in ln for ln in code), code


@pytest.mark.parametrize("phrase", [
    "Bound on the card", "mma.sync.m16n8k16", "ldmatrix", "cp.async",
    "double-buffered", "norm1 fused into conv2", "one float64 atomicAdd per CTA and channel",
    "CUDA-core path", "low bits depend on the CTAs' order",
])
def test_block_kernel_source_note(phrase):
    note = BLOCK_SRC.read_text().split("#include")[0]
    assert phrase in " ".join(note.replace("//", " ").split())


NORM_SRC = CSRC / "instance_norm.cu"


def _code_lines(text):
    return [ln for ln in text.splitlines() if not ln.strip().startswith("//")]


def test_norm_kernel_has_no_data_atomics_or_memset():
    """K2's statistics meet in a fixed order: the only atomics are the
    unsigned arrival and generation words, and no call clears a buffer."""
    text = NORM_SRC.read_text()
    code = [ln for ln in _code_lines(text) if "atomic" in ln]
    assert code and all(re.search(r"atomic(Add|Exch)\(sync(\s*\+\s*1)?, [01]u\)", ln)
                        for ln in code), code
    assert "double" not in " ".join(code)
    assert "cudaMemset" not in text and "cudaMemset" not in (CSRC / "common.cuh").read_text()


def test_norm_kernel_launches_once_cooperatively():
    """One launch per call, cooperative (all CTAs resident or the launch is
    refused), and the C entry returns the launch's error."""
    text = NORM_SRC.read_text()
    assert "<<<" not in text
    assert text.count("cudaLaunchCooperativeKernel(") == 1
    assert "return cudaLaunchCooperativeKernel(" in text
    assert "cp.async" in text and "__shfl_xor_sync" in text


def test_two_pass_norm_code_is_gone():
    text = (CSRC / "common.cuh").read_text()
    for name in ("in_stats_kernel", "in_apply_kernel", "launch_in_stats", "launch_in_apply",
                 "row_threads", "row_grid", "kRowsPerBlock"):
        assert name not in text, name
        assert name not in NORM_SRC.read_text(), name


def test_norm_wrapper_caches_its_host_work():
    """No per-call float32 copies of scale and bias, no per-call scratch: the
    plan and workspace are cached, and only y is allocated."""
    body = _function_source(norm_kernel, "fused_instance_norm_leaky_relu")
    assert "as_f32(scale, x.device), as_f32(bias, x.device)" in body
    assert "_workspace(lib, x, stream)" in body
    assert "torch.empty(" not in body and "torch.zeros(" not in body
    assert body.count("empty_like(") == 1
    assert set(_build.ENTRIES["instance_norm"]) == {"instance_norm_leaky", "instance_norm_plan"}


@pytest.mark.parametrize("phrase", [
    "Bound on the card", "read from device memory once", "cp.async", "cudaLaunchCooperativeKernel",
    "bit-identical from run to run", "no atomics touch the data", "zeroed once",
    "streaming variant",
])
def test_norm_kernel_source_note(phrase):
    note = NORM_SRC.read_text().split("#include")[0]
    assert phrase.lower() in " ".join(note.replace("//", " ").split()).lower()


def test_block_wrapper_caches_weights():
    body = _function_source(block_kernel, "fused_residual_block")
    assert "kernel_weights(blk, dtype, dev)" in body
    assert "_as_kernel_weights" not in body
