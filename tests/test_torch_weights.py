"""PyTorch port: weight layouts and checkpoint reading, held against the
JAX package (``tools/port_torch.py:flax_to_torch``, ``core/checkpoint.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import ModelConfig
from light_unet_tpu.core.checkpoint import save_checkpoint
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.tools.port_torch import flax_to_torch
from light_unet_tpu_torch.core.checkpoint import load_checkpoint
from light_unet_tpu_torch.models.unet3d import build_model, count_parameters
from light_unet_tpu_torch.tools.weights import from_jax_params, load_reference_pth
from tests.torch_parity import jit_apply, random_params

VARIANTS = {
    "depthwise_separable": {},
    "grouped": {"use_depthwise_separable": False, "use_grouped_conv": True},
    "plain": {"use_depthwise_separable": False, "use_grouped_conv": False},
}


def _jax_params(mc, seed=0, patch=(16, 16, 16)):
    model = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    return model, random_params(model, (1, *patch, 1), seed, train=False)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_from_jax_params_matches_flax_to_torch(variant):
    mc = ModelConfig(**VARIANTS[variant])
    _, params = _jax_params(mc)
    got = {k: v.numpy() for k, v in from_jax_params(params).items()}
    want = flax_to_torch(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = build_model(mc, torch.float32, inference=True)
    model.load_state_dict(from_jax_params(params), strict=True)


def test_parameter_count():
    model = build_model(ModelConfig(), torch.float32, inference=True)
    assert count_parameters(model) == {"total": 217228, "trainable": 217228}


def test_lu3dtpu1_checkpoint_forward(tmp_path, rng):
    """A checkpoint written by the JAX package, read by the port, runs the
    same forward."""
    mc = ModelConfig()
    jmodel, params = _jax_params(mc, seed=3)
    path = tmp_path / "best_model.pth"
    save_checkpoint(path, {"params": params}, {"best_epoch": 7, "best_metric": 0.5})
    state, meta = load_checkpoint(path)
    assert meta["best_epoch"] == 7
    model = build_model(mc, torch.float32, inference=True).eval()
    model.load_state_dict(state, strict=True)
    x = rng.standard_normal((1, 16, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jit_apply(jmodel)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5


def test_reference_pth_grouped_names(tmp_path):
    """A reference ``.pth`` (grouped convs wrapped as ``conv1.conv.weight``)
    loads into the port's grouped model with strict=True."""
    mc = ModelConfig(use_depthwise_separable=False, use_grouped_conv=True)
    _, params = _jax_params(mc)
    state = {k: torch.from_numpy(v) for k, v in flax_to_torch(params).items()}
    wrapped = {k.replace(".conv1.weight", ".conv1.conv.weight") if "down" in k else k: v
               for k, v in state.items()}
    assert wrapped.keys() != state.keys()
    torch.save({"model_state_dict": wrapped, "epoch": 3}, tmp_path / "ref.pth")
    got, meta = load_checkpoint(tmp_path / "ref.pth")
    assert meta["epoch"] == 3 and meta["source_format"] == "torch"
    build_model(mc, torch.float32, inference=True).load_state_dict(got, strict=True)
    direct, _ = load_reference_pth(tmp_path / "ref.pth")
    for k in state:
        torch.testing.assert_close(direct[k], state[k], rtol=0, atol=0)
