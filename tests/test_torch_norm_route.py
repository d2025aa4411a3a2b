"""PyTorch port on the CPU: which InstanceNorms take the fused norm kernel's
wrapper (``ops/norm_kernel.py:fused_instance_norm_leaky_relu``).  Every
inference norm does, affine or not, with the LeakyReLU folded in or not;
training forwards and forwards that autograd records through
keep the plain chain; a non-affine norm's unit scale and zero bias are made
once per device; and on the CPU, where the wrapper runs the plain chain,
every output is what the plain chain gives, bit for bit."""

import pytest
import torch

from light_unet_tpu_torch.config import ModelConfig
from light_unet_tpu_torch.models import unet3d
from light_unet_tpu_torch.models.unet3d import InstanceNorm, build_model, init_weights
from light_unet_tpu_torch.ops.norm_kernel import IN_EPS, reference_instance_norm_leaky_relu


@pytest.fixture
def calls(monkeypatch):
    """The wrapper's and the plain chain's calls, as the model makes them."""
    seen = {"kernel": [], "plain": [], "slopes": []}
    kernel = unet3d.fused_instance_norm_leaky_relu
    plain = unet3d.reference_instance_norm_leaky_relu

    def kernel_call(x, scale, bias, **kw):
        seen["kernel"].append((scale, bias))
        seen["slopes"].append(kw["negative_slope"])
        return kernel(x, scale, bias, **kw)

    def plain_call(*a, **kw):
        seen["plain"].append(1)
        return plain(*a, **kw)

    monkeypatch.setattr(unet3d, "fused_instance_norm_leaky_relu", kernel_call)
    monkeypatch.setattr(unet3d, "reference_instance_norm_leaky_relu", plain_call)
    return seen


def _norm(affine, fuse_leaky=True, c=6):
    norm = InstanceNorm(c, fuse_leaky=fuse_leaky, affine=affine)
    if affine:
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            norm.weight.copy_(1.0 + 0.1 * torch.randn(c, generator=gen))
            norm.bias.copy_(0.1 * torch.randn(c, generator=gen))
    return norm.eval()


def _x(dtype=torch.float32, c=6):
    gen = torch.Generator().manual_seed(0)
    return (torch.randn((2, 5, 6, 7, c), generator=gen) * 3 + 1).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse_leaky", [True, False], ids=["leaky", "no-leaky"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "non-affine"])
def test_an_inference_norm_calls_the_kernel_wrapper(calls, affine, fuse_leaky, dtype):
    """The wrapper gets the norm's slope: LeakyReLU's 0.01 folded in, else
    1.0 (the identity)."""
    norm = _norm(affine, fuse_leaky)
    x = _x(dtype)
    with torch.no_grad():
        got = norm(x)
    assert len(calls["kernel"]) == 1 and not calls["plain"]
    assert calls["slopes"] == [unet3d.LEAKY_SLOPE if fuse_leaky else 1.0]
    scale, bias = calls["kernel"][0]
    if affine:
        assert scale is norm.weight and bias is norm.bias
    else:
        assert scale.dtype == bias.dtype == torch.float32
        assert torch.equal(scale, torch.ones(6)) and torch.equal(bias, torch.zeros(6))
    want = reference_instance_norm_leaky_relu(x, norm.weight, norm.bias, eps=IN_EPS,
                                              negative_slope=norm.slope)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", ["train", "train-no_grad", "eval-parameters", "eval-input"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "non-affine"])
def test_training_and_recorded_forwards_keep_the_plain_chain(calls, affine, case):
    """Train mode, or autograd recording through the parameters or the input
    (``runs_inference`` false), runs the plain chain; a non-affine norm in
    eval mode with grad on and an input that needs none has nothing to
    record and takes the wrapper."""
    norm = _norm(affine)
    norm.train(case.startswith("train"))
    x = _x().requires_grad_(case == "eval-input")
    with torch.set_grad_enabled(case != "train-no_grad"):
        y = norm(x)
    if case == "eval-parameters" and not affine:
        assert len(calls["kernel"]) == 1 and not calls["plain"]
        return
    assert not calls["kernel"] and len(calls["plain"]) == 1
    assert torch.isfinite(y).all()


def test_unit_scale_and_bias_are_made_once_per_device(calls, monkeypatch):
    norm = _norm(affine=False)
    made = []
    ones = torch.ones
    monkeypatch.setattr(torch, "ones", lambda *a, **k: made.append(1) or ones(*a, **k))
    with torch.no_grad():
        for _ in range(3):
            norm(_x())
    assert len(made) == 1 and list(norm._unit) == [torch.device("cpu")]
    (s0, b0), *rest = calls["kernel"]
    assert len(rest) == 2 and all(s is s0 and b is b0 for s, b in rest)
    assert norm.unit_affine(torch.device("cpu"))[0] is s0


def _chain_forward(self, x):
    return reference_instance_norm_leaky_relu(x, self.weight, self.bias, eps=IN_EPS,
                                              negative_slope=self.slope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model_cfg", [
    ModelConfig(),
    ModelConfig(name="SwinUNETR", feature_size=12),
], ids=["unet", "swin_unetr"])
def test_the_cpu_output_is_the_plain_chains(monkeypatch, model_cfg, dtype):
    """A whole model in eval mode, no grad: every norm now goes through the
    wrapper, and the output equals the plain chain's bit for bit."""
    model_cfg.validate()
    model = init_weights(build_model(model_cfg, dtype, inference=True),
                         torch.Generator().manual_seed(4)).eval()
    x = torch.rand((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(5))
    seen = []
    kernel = unet3d.fused_instance_norm_leaky_relu
    monkeypatch.setattr(unet3d, "fused_instance_norm_leaky_relu",
                        lambda *a, **k: seen.append(1) or kernel(*a, **k))
    with torch.no_grad():
        got = model(x)
        norms = len(seen)
        monkeypatch.setattr(InstanceNorm, "forward", _chain_forward)
        want = model(x)
    assert norms == (23 if model_cfg.name != "SwinUNETR" else 26) and len(seen) == norms
    assert torch.equal(got, want)
