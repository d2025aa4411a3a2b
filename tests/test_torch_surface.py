"""PyTorch port: the public surface the JAX package's ``__init__``s re-export,
the loss functions ``bce_loss``, ``combined_loss`` and ``dice_loss``, the
weight layout back to flax (``tools/weights.py:to_jax_params``) and a
``best_model.pth`` written by the port read by the JAX package."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import ModelConfig
from light_unet_tpu.core.checkpoint import load_checkpoint as jax_load_checkpoint
from light_unet_tpu.models import losses as jax_losses
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.tools.port_torch import flax_to_torch, torch_to_flax
from light_unet_tpu_torch.core.checkpoint import save_checkpoint
from light_unet_tpu_torch.models import losses
from light_unet_tpu_torch.models.unet3d import build_model, init_weights
from light_unet_tpu_torch.tools.weights import from_jax_params, to_jax_params
from tests.torch_parity import jit_apply, random_params

# names a JAX package re-exports that have no counterpart in the port (each
# said so in the port package's docstring)
NO_COUNTERPART = {"models": {"init_params"},
                  "parallel": {"batch_sharding", "replicated_sharding"}}
PACKAGES = ["", "models", "datasets", "core", "parallel"]


def _exported(module) -> set:
    return {n for n in vars(module) if not n.startswith("_")
            and not isinstance(getattr(module, n), type(importlib))}


@pytest.mark.parametrize("package", PACKAGES)
def test_port_packages_export_the_jax_names(package):
    jax_mod = importlib.import_module("light_unet_tpu" + (f".{package}" if package else ""))
    port_mod = importlib.import_module("light_unet_tpu_torch" + (f".{package}" if package else ""))
    want = _exported(jax_mod) - NO_COUNTERPART.get(package, set())
    missing = sorted(n for n in want if not hasattr(port_mod, n))
    assert not missing, missing
    for name in NO_COUNTERPART.get(package, ()):
        assert name in port_mod.__doc__


def test_reference_dataset_aliases():
    from light_unet_tpu_torch import datasets, models

    assert datasets.PatchDataset is datasets.PatchSampler
    assert datasets.MixedPatchDataset is datasets.MixedPatchSampler
    assert models.PatchDataset is datasets.PatchSampler
    assert models.CaseDataset is datasets.CaseDataset


def _loss_inputs(seed, shape=(2, 16, 16, 16, 1)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    pred[0, :2] = 0.0  # the clamp's edges
    pred[1, :2] = 1.0
    target = (rng.random(shape) < 0.2).astype(np.float32)
    return pred, target


LOSSES = {
    "bce_loss": ({}, {}),
    "dice_loss": ({}, {"smooth": 1e-3}),
    "combined_loss": ({}, {"ftl_weight": 0.6, "bce_weight": 0.4, "alpha": 0.5, "beta": 0.5,
                           "gamma": 1.0}),
}


@pytest.mark.parametrize("kwargs_index", [0, 1])
@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name, kwargs_index):
    kwargs = LOSSES[name][kwargs_index]
    pred, target = _loss_inputs(seed=len(name) + kwargs_index)
    want = float(getattr(jax_losses, name)(jnp.asarray(pred), jnp.asarray(target), **kwargs))
    got = float(getattr(losses, name)(torch.from_numpy(pred), torch.from_numpy(target), **kwargs))
    assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6), (got, want)


def test_losses_give_the_training_loss():
    """The configured training loss is the function it names."""
    from light_unet_tpu_torch.config import LossConfig

    pred, target = (torch.from_numpy(a) for a in _loss_inputs(seed=9))
    cfg = LossConfig(name="DiceLoss")
    assert torch.equal(losses.get_loss_function(cfg)(pred, target), losses.dice_loss(pred, target))
    cfg = LossConfig(use_combined_loss=True)
    w = cfg.combined_loss_weights
    want = losses.combined_loss(pred, target, ftl_weight=w["focal_tversky"], bce_weight=w["bce"])
    assert torch.allclose(losses.get_loss_function(cfg)(pred, target), want, rtol=1e-6)


VARIANTS = {
    "depthwise_separable": {},
    "grouped": {"use_depthwise_separable": False, "use_grouped_conv": True},
    "plain": {"use_depthwise_separable": False, "use_grouped_conv": False},
}


def _port_state(variant, seed):
    model = build_model(ModelConfig(**VARIANTS[variant]), torch.float32, inference=True)
    return init_weights(model, torch.Generator().manual_seed(seed)).state_dict()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_to_jax_params_round_trips(variant):
    state = _port_state(variant, seed=1)
    back = from_jax_params(to_jax_params(state))
    assert sorted(back) == sorted(state)
    for k in state:
        assert torch.equal(back[k], state[k]), k


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_to_jax_params_matches_torch_to_flax(variant):
    """The port's layout back to flax equals the JAX package's own port of
    the same state dict, leaf for leaf, and its tree is the flax model's."""
    mc = ModelConfig(**VARIANTS[variant])
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    template = random_params(jmodel, (1, 16, 16, 16, 1), 0, train=False)
    state = _port_state(variant, seed=2)
    got = to_jax_params(state)
    want = torch_to_flax(state, template)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))
    # and JAX's inverse of it gives the state dict back
    for k, v in flax_to_torch(got).items():
        np.testing.assert_array_equal(v, state[k].numpy(), err_msg=k)


def test_jax_reads_the_ports_best_model(tmp_path):
    """A ``best_model.pth`` written by the port's checkpoint writer is read
    by the JAX package's ``load_checkpoint``; the JAX forward matches the
    port's within 1e-4 in float32 at full width, 16^3."""
    mc = ModelConfig()
    model = init_weights(build_model(mc, torch.float32, inference=True),
                         torch.Generator().manual_seed(5)).eval()
    path = tmp_path / "models/best_model.pth"
    save_checkpoint(path, model.state_dict(), {}, {"best_epoch": 4, "best_metric": 0.25})
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    template = random_params(jmodel, (1, 16, 16, 16, 1), 0, train=False)
    arrays, meta = jax_load_checkpoint(path, template)
    assert meta["best_epoch"] == 4 and meta["source_format"] == "torch"
    x = np.random.default_rng(6).standard_normal((2, 16, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jit_apply(jmodel)(arrays, jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4
