"""PyTorch port: the plain versions of the two kernels (fused InstanceNorm +
LeakyReLU, fused residual block) and the whole model, held against the JAX
package on the CPU.  The JAX block kernel runs in interpret mode, as in
``tests/unit/test_pallas_block.py``; the port's wrappers take their plain
versions because the tensors lie on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import ModelConfig
from light_unet_tpu.models.fused_forward import make_fused_apply as jax_make_fused_apply
from light_unet_tpu.models.unet3d import ResidualBlock as JaxResidualBlock
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.ops.pallas_block import fused_residual_block as jax_fused_residual_block
from light_unet_tpu.ops.pallas_kernels import reference_instance_norm_leaky_relu as jax_in_ref
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.unet3d import ResidualBlock, build_model
from light_unet_tpu_torch.ops import block_kernel, norm_kernel
from light_unet_tpu_torch.tools.weights import from_jax_params
from tests.torch_parity import jit_apply, random_params

VARIANTS = {
    "depthwise_separable": {},
    "grouped": {"use_depthwise_separable": False, "use_grouped_conv": True},
    "plain": {"use_depthwise_separable": False, "use_grouped_conv": False},
}


@pytest.mark.parametrize("slope", [0.01, 1.0])
@pytest.mark.parametrize("d,c", [(8, 16), (6, 32), (4, 64), (3, 128)])
def test_norm_plain_matches_jax(rng, d, c, slope):
    x = (rng.standard_normal((2, d, d, d, c)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    want = np.asarray(jax_in_ref(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                 negative_slope=slope))
    launches = norm_kernel.launches
    got = norm_kernel.fused_instance_norm_leaky_relu(
        torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b), negative_slope=slope)
    assert norm_kernel.launches == launches  # CPU tensors never reach the kernel
    assert np.abs(got.numpy() - want).max() <= 1e-4


def _block_pair(rng, shape, c, dtype):
    """A JAX ResidualBlock with seeded params, its output, and the port's
    block loaded with the same weights."""
    x = rng.standard_normal(shape).astype(np.float32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    mod = JaxResidualBlock(c, use_depthwise_separable=True, use_grouped=False, groups=4,
                           dropout_p=0.0, dtype=jdt, precision=None)
    params = random_params(mod, shape, seed=7, train=False)["params"]
    ref = np.asarray(mod.apply({"params": params}, jnp.asarray(x).astype(jdt), train=False),
                     np.float32)
    blk = ResidualBlock(shape[-1], c, dropout_p=0.0, compute_dtype=dtype).eval()
    blk.load_state_dict(from_jax_params(params), strict=True)
    return x, params, ref, blk


@pytest.mark.parametrize(
    "shape,c",
    [
        ((1, 12, 12, 12, 32), 32),   # identity shortcut
        ((1, 12, 12, 12, 32), 64),   # projection shortcut
        ((2, 8, 12, 48, 1), 16),     # cin = 1 (init_conv), batch 2
        ((1, 6, 6, 6, 128), 128),    # bottleneck
    ],
)
def test_block_plain_matches_jax_f32(rng, shape, c):
    x, params, ref, blk = _block_pair(rng, shape, c, torch.float32)
    interp = np.asarray(jax_fused_residual_block(jnp.asarray(x), params, dtype=jnp.float32,
                                                 interpret=True), np.float32)
    calls = block_kernel.plain_calls
    got = block_kernel.fused_residual_block(torch.from_numpy(x), blk).numpy()
    assert block_kernel.plain_calls == calls + 1
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() / scale < 5e-5
    assert np.abs(got - interp).max() / scale < 5e-5


def test_block_plain_matches_jax_bf16(rng):
    shape, c = (1, 12, 12, 12, 64), 64
    x, params, ref, blk = _block_pair(rng, shape, c, torch.bfloat16)
    got = block_kernel.fused_residual_block(torch.from_numpy(x), blk)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got.float().numpy() - ref).max() / scale < 2e-2


def _models(rng, variant, seed=3):
    mc = ModelConfig(**VARIANTS[variant])
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    params = random_params(jmodel, (1, 16, 16, 16, 1), seed, train=False)
    model = build_model(mc, torch.float32, inference=True).eval()
    model.load_state_dict(from_jax_params(params), strict=True)
    x = rng.standard_normal((1, 16, 16, 16, 1)).astype(np.float32)
    return mc, jmodel, params, model, x


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_model_matches_jax_apply(rng, variant):
    _, jmodel, params, model, x = _models(rng, variant)
    want = np.asarray(jit_apply(jmodel)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4


def test_fused_apply_matches_jax_fused_apply(rng):
    mc, jmodel, params, model, x = _models(rng, "depthwise_separable", seed=5)
    want = np.asarray(jax_make_fused_apply(mc, compute_dtype=jnp.float32, precision="highest",
                                           interpret=True)(params, jnp.asarray(x)))
    got = make_fused_apply(model)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-4

