"""PyTorch port: the depthwise 3x3x3 kernel's wrapper on the CPU
(``ops/depthwise_kernel.py``): which path each call takes, the argument
checks that run without a card, its plain version against the JAX
package's depthwise conv, and static checks of the kernel source.  The
kernel itself runs only on the card (``tests/test_torch_depthwise_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax import lax

from light_unet_tpu_torch.config import ModelConfig
from light_unet_tpu_torch.models.unet3d import DepthwiseConv3d, build_model, init_weights
from light_unet_tpu_torch.ops import _build
from light_unet_tpu_torch.ops import depthwise_kernel as dk
from light_unet_tpu_torch.utils import tracing
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

SRC = _build.CSRC / "depthwise_conv.cu"
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> float:
    """Largest |got - want| in bfloat16 units in the last place of the larger value."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.finfo(np.float32).tiny)
    return float((np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)).max())


def jax_depthwise(x: np.ndarray, w: np.ndarray, jdt) -> np.ndarray:
    """The JAX package's depthwise conv (``nn.Conv`` with ``feature_group_count``
    = C, SAME padding): ``lax.conv_general_dilated`` in ``jdt``, kernel DHWIO."""
    k = np.transpose(w, (2, 3, 4, 1, 0))  # [C, 1, 3, 3, 3] -> [3, 3, 3, 1, C]
    y = lax.conv_general_dilated(jnp.asarray(x, jdt), jnp.asarray(k, jdt), (1, 1, 1), "SAME",
                                 dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
                                 feature_group_count=x.shape[-1],
                                 precision=lax.Precision.HIGHEST)
    return np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("c", [1, 16, 32])
@pytest.mark.parametrize("shape", [(2, 5, 7, 9), (1, 6, 6, 6), (1, 3, 11, 4)], ids=str)
def test_plain_version_matches_jax(rng, shape, c, dtype):
    tdt, jdt = DTYPES[dtype]
    x = rng.standard_normal(shape + (c,)).astype(np.float32)
    w = rng.uniform(-27 ** -0.5, 27 ** -0.5, (c, 1, 3, 3, 3)).astype(np.float32)
    xt = torch.from_numpy(x).to(tdt)
    calls, launches = dk.plain_calls, dk.launches
    got = dk.depthwise_conv3d(xt, torch.from_numpy(w))
    assert (dk.plain_calls, dk.launches) == (calls + 1, launches)
    assert got.dtype == tdt and got.shape == xt.shape
    want = jax_depthwise(xt.float().numpy(), w, jdt)  # the same rounded input
    if tdt == torch.float32:
        assert np.abs(got.numpy() - want).max() <= 2e-6
    else:  # both sum in float32 and round once to bfloat16
        assert bf16_ulps(got.float().numpy(), want) <= 1.0


def test_plain_version_is_the_models_former_conv(rng):
    """The plain version is ``F.conv3d(groups=C)`` with the weight rounded to
    the input's dtype, exactly the call ``Conv3d.forward`` makes."""
    x = torch.from_numpy(rng.standard_normal((2, 6, 5, 7, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((16, 1, 3, 3, 3)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        xd = x.to(dt)
        want = F.conv3d(xd.permute(0, 4, 1, 2, 3), w.to(dt), None, 1, 1, 1, 16)
        torch.testing.assert_close(dk.reference_depthwise_conv3d(xd, w),
                                   want.permute(0, 2, 3, 4, 1), rtol=0, atol=0)


def _model(dtype=torch.float32, **kw):
    model = build_model(ModelConfig(**kw), dtype, inference=True)
    return init_weights(model, torch.Generator().manual_seed(3)).eval()


def test_inference_forward_takes_the_wrapper_16_times():
    """Each depthwise conv of the shipped widths (16 a forward, C = 1 to
    128) goes through the wrapper under ``no_grad`` and ``inference_mode``;
    on the CPU that is the plain version, with the module's numbers."""
    model = _model()
    assert len([m for m in model.modules() if isinstance(m, DepthwiseConv3d)]) == 16
    x = torch.rand((1, 16, 16, 16, 1), generator=torch.Generator().manual_seed(0))
    before = tracing.snapshot()
    with torch.no_grad():
        a = model(x)
    with torch.inference_mode():
        b = model(x)
    after = tracing.snapshot()
    assert after["depthwise_kernel.plain_calls"] - before["depthwise_kernel.plain_calls"] == 32
    assert after["depthwise_kernel.launches"] == before["depthwise_kernel.launches"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_training_keeps_conv3d_forward_and_backward():
    """While autograd records, the depthwise convs are ``Conv3d`` (cuDNN on a
    card): the wrapper is never called, and the forward equals the one
    without autograd bit for bit."""
    model = _model()
    x = torch.rand((2, 16, 16, 16, 1), generator=torch.Generator().manual_seed(1))
    calls, launches = dk.plain_calls, dk.launches
    out = model(x)
    out.mean().backward()
    assert (dk.plain_calls, dk.launches) == (calls, launches)
    dw = [m for m in model.modules() if isinstance(m, DepthwiseConv3d)]
    assert all(m.weight.grad is not None and m.weight.grad.abs().sum() > 0 for m in dw)
    with torch.no_grad():
        torch.testing.assert_close(model(x), out.detach(), rtol=0, atol=0)
    assert dk.plain_calls == calls + 16


def test_a_recording_input_alone_takes_conv3d():
    """An input that requires grad records even with frozen weights."""
    m = DepthwiseConv3d(16).eval()
    m.weight.requires_grad_(False)
    x = torch.randn(1, 4, 4, 4, 16, requires_grad=True)
    calls = dk.plain_calls
    m(x).sum().backward()
    assert dk.plain_calls == calls and x.grad is not None
    with torch.no_grad():
        m(x)
    assert dk.plain_calls == calls + 1


# (model config, depthwise convs and norms of an inference forward)
RULE_MODELS = {"unet": (dict(), 16, 23),
               "swin_unetr": (dict(name="SwinUNETR", feature_size=12), 0, 26)}


@pytest.mark.parametrize("model", sorted(RULE_MODELS))
@pytest.mark.parametrize("train,grad", [(False, False), (False, True), (True, False),
                                        (True, True)], ids=["eval-no_grad", "eval-grad",
                                                            "train-no_grad", "train-grad"])
def test_one_rule_decides_both_inference_kernels(monkeypatch, train, grad, model):
    """``runs_inference`` (eval mode, autograd recording nothing) sends the
    depthwise convs to the wrapper and the norms to the norm kernel, in the
    U-Net and in SwinUNETR's decoder; any other forward keeps both plain
    modules."""
    from light_unet_tpu_torch.models import unet3d

    over, want_dw, want_norms = RULE_MODELS[model]
    norms = []
    kernel = unet3d.fused_instance_norm_leaky_relu
    monkeypatch.setattr(unet3d, "fused_instance_norm_leaky_relu",
                        lambda *a, **k: norms.append(1) or kernel(*a, **k))
    model_cfg = ModelConfig(**over)
    model_cfg.validate()
    net = init_weights(build_model(model_cfg, torch.float32, inference=True),
                       torch.Generator().manual_seed(3))
    if model == "swin_unetr":
        # the encoder writes its attention masks in place, which autograd
        # refuses (the port serves SwinUNETR only); the decoder still records
        net.swinViT.requires_grad_(False)
    net.train(train)
    x = torch.rand((1, 32, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    calls = dk.plain_calls
    with torch.set_grad_enabled(grad):
        net(x)
    inference = not train and not grad
    assert dk.plain_calls - calls == (want_dw if inference else 0)
    assert len(norms) == (want_norms if inference else 0)


def test_grouped_and_plain_convs_do_not_take_the_wrapper():
    calls = dk.plain_calls
    for kw in ({"use_depthwise_separable": False, "use_grouped_conv": True},
               {"use_depthwise_separable": False, "use_grouped_conv": False}):
        model = _model(**kw)
        assert not [m for m in model.modules() if isinstance(m, DepthwiseConv3d)]
        with torch.no_grad():
            model(torch.rand((1, 16, 16, 16, 1)))
    assert dk.plain_calls == calls


def test_bf16_model_rounds_at_the_modules_points():
    """A bf16 model's depthwise output is the plain version on the input cast
    to bf16 (the module casts, the wrapper rounds the weight)."""
    m = DepthwiseConv3d(16, compute_dtype=torch.bfloat16).eval()
    x = torch.randn(2, 5, 6, 7, 16)
    with torch.no_grad():
        got = m(x)
    want = dk.reference_depthwise_conv3d(x.to(torch.bfloat16), m.weight)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, rtol=0, atol=0)


BAD_ARGS = {
    "float16": (lambda: torch.zeros(1, 4, 4, 4, 8, dtype=torch.float16), (8, 1, 3, 3, 3)),
    "float64": (lambda: torch.zeros(1, 4, 4, 4, 8, dtype=torch.float64), (8, 1, 3, 3, 3)),
    "4-D": (lambda: torch.zeros(4, 4, 4, 8), (8, 1, 3, 3, 3)),
    "empty": (lambda: torch.zeros(0, 4, 4, 4, 8), (8, 1, 3, 3, 3)),
    "channels": (lambda: torch.zeros(1, 4, 4, 4, 8), (16, 1, 3, 3, 3)),
    "grouped weight": (lambda: torch.zeros(1, 4, 4, 4, 8), (8, 2, 3, 3, 3)),
    "5x5x5 weight": (lambda: torch.zeros(1, 4, 4, 4, 8), (8, 1, 5, 5, 5)),
    "channels first": (lambda: torch.zeros(1, 8, 4, 4, 4).permute(0, 2, 3, 4, 1),
                       (8, 1, 3, 3, 3)),
    "strided": (lambda: torch.zeros(1, 4, 4, 8, 8)[:, :, :, ::2], (8, 1, 3, 3, 3)),
    "too large": (lambda: torch.empty(1, 1, 2**16, 2**15, 1, device="meta"), (1, 1, 3, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_unsupported_arguments_raise_without_a_card(case):
    make_x, wshape = BAD_ARGS[case]
    x = make_x()
    with pytest.raises(ValueError, match="too large" if case == "too large" else "depthwise"):
        dk.check_args(x, torch.zeros(wshape, device=x.device))


def test_weight_on_another_device_raises():
    with pytest.raises(ValueError, match="weight on meta"):
        dk.check_args(torch.zeros(1, 4, 4, 4, 8), torch.zeros(8, 1, 3, 3, 3, device="meta"))


@pytest.mark.parametrize("shape", [(1, 4, 4, 4, 8), (192, 48, 48, 48, 16), (2, 5, 7, 9, 1)],
                         ids=str)
def test_supported_arguments_pass_the_checks(shape):
    x = torch.empty(shape, device="meta", dtype=torch.bfloat16)
    dk.check_args(x, torch.empty((shape[-1], 1, 3, 3, 3), device="meta"))


def test_a_device_other_than_the_cpu_or_a_card_raises():
    x = torch.empty((1, 4, 4, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        dk.depthwise_conv3d(x, torch.empty((8, 1, 3, 3, 3), device="meta"))


def test_kernel_source_plan_and_rules():
    """The source allocates nothing, sums with no atomics, stages with
    16-byte copies, and plans from the shape alone (no knob)."""
    text = SRC.read_text()
    for banned in ("cudaMalloc", "atomicAdd", "getenv", "cudaMemset"):
        assert banned not in text, banned
    assert "cp.async.cg.shared.global [%0], [%1], 16" in text
    # one launch site a variant (3x3x3, and 5x5x5 with a bias): one launch a call
    assert text.count("<<<") == 2
    entries = _build.ENTRIES["depthwise_conv"]
    assert list(entries) == ["depthwise_conv3d", "depthwise_conv3d_k5"]


def _sum_in_order(x: np.ndarray, w: np.ndarray, order) -> np.ndarray:
    """The conv's 27 products summed in float32 in ``order`` (taps kd*9 +
    kh*3 + kw), each step rounded once as a fused multiply-add rounds."""
    xp = np.pad(x.astype(np.float64), ((0, 0), (1, 1), (1, 1), (1, 1), (0, 0)))
    _, d, h, wd, _ = x.shape
    acc = np.zeros(x.shape, np.float32)
    for t in order:
        kd, kh, kw = t // 9, t // 3 % 3, t % 3
        term = xp[:, kd:kd + d, kh:kh + h, kw:kw + wd] * w[:, 0, kd, kh, kw].astype(np.float64)
        acc = (acc.astype(np.float64) + term).astype(np.float32)
    return acc


def test_gap_ulps_allows_sum_orders_and_not_one_ulp_more(rng):
    """Two float32 orders of the sum, each rounded once to bf16, stay within
    one bf16 unit beyond the order term, though they differ by many units
    where a sum cancels (16 outputs are made to); a gap of 2 units on one
    element is seen."""
    xn = rng.standard_normal((4, 8, 9, 10, 16)).astype(np.float32)
    wn = rng.uniform(-0.2, 0.2, (16, 1, 3, 3, 3)).astype(np.float32)
    for k in range(16):  # make some sums cancel: move the centre voxel onto the root
        b_, d, h, wi, c = k % 4, 1 + 3 * (k % 2), 1 + 3 * (k // 2 % 2), 1 + 4 * (k // 4 % 2), k
        patch = xn[b_, d - 1:d + 2, h - 1:h + 2, wi - 1:wi + 2, c].astype(np.float64)
        exact = float((patch * wn[c, 0].astype(np.float64)).sum())
        xn[b_, d, h, wi, c] = np.float32(float(xn[b_, d, h, wi, c]) - exact / float(wn[c, 0, 1, 1, 1]))
    x, w = torch.from_numpy(xn), torch.from_numpy(wn)
    a = torch.from_numpy(_sum_in_order(x.numpy(), w.numpy(), range(27))).to(torch.bfloat16)
    b = torch.from_numpy(_sum_in_order(x.numpy(), w.numpy(), range(26, -1, -1))).to(torch.bfloat16)
    g, r = a.float(), b.float()
    raw = ((g - r).abs() / torch.exp2(torch.floor(torch.log2(
        torch.maximum(g.abs(), r.abs()).clamp(min=1e-30))) - 7)).max().item()
    assert raw > 1.0  # the orders alone exceed one unit somewhere
    assert dk.gap_ulps(a, b, x, w) <= 1.0
    assert dk.gap_ulps(a, a, x, w) == 0.0
    big = a.float().abs().argmax()
    bumped = a.clone().view(-1)
    bumped[big] = (bumped[big].float() * (1 + 2 * 2.0 ** -7)).to(torch.bfloat16)
    assert dk.gap_ulps(bumped.view(a.shape), a, x, w) >= 1.5
