"""PyTorch port on the card: the depthwise 3x3x3 kernel
(``csrc/depthwise_conv.cu``) against its plain version at every shape of
the served forward and off it, its determinism, the served forward graphed
against eager, and which routes launch it.  Skips without a GPU.  A GPU
machine need not have JAX, which ``tests/conftest.py`` imports, so run it
there without the conftest:

    python -m pytest --noconftest tests/test_torch_depthwise_cuda.py -q
"""

from functools import partial

import pytest
import torch

from light_unet_tpu_torch.config import ModelConfig
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.unet3d import build_model, init_weights
from light_unet_tpu_torch.ops import block_kernel
from light_unet_tpu_torch.ops import depthwise_kernel as dk

torch.backends.cudnn.allow_tf32 = False  # the float32 plain version in full float32
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


# (side, C) of the 16 depthwise convs of a 48^3 forward at the shipped widths
SERVED = [(48, 1), (48, 16), (48, 32), (24, 16), (24, 32), (24, 64), (12, 32), (12, 64),
          (12, 128), (6, 64), (6, 128)]
SERVED_CASES = [(8, s, c) for s, c in SERVED] + [(192, 48, 16), (192, 6, 128)]
# off the served forward: ragged sides, C = 1 with W off the vector width,
# C off a multiple of 16 (the scalar path), B = 1, one-voxel volumes
ODD_CASES = [(1, 5, 7, 9, 16), (2, 3, 11, 13, 32), (1, 7, 5, 3, 1), (2, 9, 6, 21, 1),
             (1, 4, 9, 10, 3), (3, 6, 6, 6, 24), (1, 5, 17, 33, 48), (2, 2, 2, 2, 8),
             (1, 1, 1, 1, 16), (1, 33, 35, 37, 64), (2, 20, 24, 16, 1), (1, 1, 40, 40, 128)]


def _inputs(gen, shape, dtype):
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    w = (torch.rand((c, 1, 3, 3, 3), generator=gen, device="cuda") * 2 - 1) / 27 ** 0.5
    return x, w


def check_close(got, want, x, w):
    """Both versions sum the 27 products in float32, in different orders, and
    round once.  float32: within ``order_bound`` (2 * 26 float32 roundings of
    the sum of |x w|).  bf16: within one bf16 unit in the last place of the
    larger value beyond that bound (``gap_ulps``): the rounded results of two
    float32 sums differ only where the sums straddle a rounding boundary,
    and by more than the order term only where a sum cancels."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.bfloat16:
        assert dk.gap_ulps(got, want, x, w) <= 1.0
    else:
        assert bool(((got - want).abs() <= dk.order_bound(x, w)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("b,side,c", SERVED_CASES, ids=str)
def test_kernel_matches_plain_at_served_shapes(gen, b, side, c, dtype):
    x, w = _inputs(gen, (b, side, side, side, c), dtype)
    n = dk.launches
    got = dk.depthwise_conv3d(x, w)
    assert dk.launches == n + 1
    torch.cuda.synchronize()
    check_close(got, dk.reference_depthwise_conv3d(x, w), x, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", ODD_CASES, ids=str)
def test_kernel_matches_plain_off_the_served_shapes(gen, shape, dtype):
    x, w = _inputs(gen, shape, dtype)
    got = dk.depthwise_conv3d(x, w)
    torch.cuda.synchronize()
    check_close(got, dk.reference_depthwise_conv3d(x, w), x, w)


@pytest.mark.parametrize("shape", [(192, 48, 48, 48, 16), (192, 48, 48, 48, 1),
                                   (8, 24, 24, 24, 64), (3, 6, 6, 6, 24)], ids=str)
def test_kernel_is_deterministic(gen, shape):
    x, w = _inputs(gen, shape, torch.bfloat16)
    assert torch.equal(dk.depthwise_conv3d(x, w), dk.depthwise_conv3d(x, w))


def test_kernel_takes_an_unaligned_input_and_raises_on_a_strided_one(gen):
    src, w = _inputs(gen, (2, 6, 7, 8, 16), torch.bfloat16)
    off = torch.empty(src.numel() + 1, dtype=src.dtype, device="cuda")[1:].view(src.shape)
    off.copy_(src)
    assert off.data_ptr() % 16  # 2 bytes past an aligned base
    check_close(dk.depthwise_conv3d(off, w), dk.reference_depthwise_conv3d(src, w), src, w)
    with pytest.raises(ValueError, match="contiguous"):
        dk.depthwise_conv3d(src.permute(0, 3, 2, 1, 4), w)


def _model(dtype=torch.bfloat16, seed=7):
    model = build_model(ModelConfig(), dtype, inference=True)
    return init_weights(model, torch.Generator().manual_seed(seed)).cuda().eval()


def test_served_forward_graphed_equals_eager_bit_for_bit(gen):
    """The plain route's chunk forward of 48^3 patches: eager, captured,
    replayed: the same bits, and each replay counts the 16 launches."""
    from light_unet_tpu_torch.ops.sliding_window import chunk_forward
    from light_unet_tpu_torch.utils.graphs import GraphRunner

    fwd = partial(chunk_forward, _model())
    c = torch.rand((8, 48, 48, 48), generator=gen, device="cuda")
    with torch.no_grad():
        n = dk.launches
        eager = fwd(c)
        assert dk.launches == n + 16
        runner = GraphRunner("window", "cuda")
        first = runner(("chunk",), fwd, c)[0].clone()
        n = dk.launches
        replayed = runner(("chunk",), fwd, c)[0].clone()
        assert dk.launches == n + 16
        again = fwd(c)
    assert torch.equal(first, eager) and torch.equal(replayed, eager) and torch.equal(again, eager)


def test_training_keeps_cudnn_and_the_fused_block_route_launches_no_depthwise_kernel(gen):
    """While autograd records, forward and backward go through cuDNN (no
    launch); under ``no_grad`` the plain model launches 16 a forward; the
    ``fused_block`` route runs K1 and launches none."""
    model = _model()
    x = torch.rand((2, 48, 48, 48, 1), generator=gen, device="cuda")
    n = dk.launches
    model(x).float().mean().backward()
    assert dk.launches == n
    assert all(p.grad is not None for p in model.parameters())
    with torch.no_grad():
        model(x)
        assert dk.launches == n + 16
        blocks = block_kernel.launches
        make_fused_apply(model)(x)
    assert dk.launches == n + 16 and block_kernel.launches == blocks + 8


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)], ids=str)
def test_inference_forward_matches_the_cudnn_forward(gen, dtype, bar):
    """The model's forward on the kernel against the same forward with every
    depthwise conv on cuDNN (autograd recording, the training path)."""
    model = _model(dtype)
    x = torch.rand((4, 48, 48, 48, 1), generator=gen, device="cuda")
    with torch.no_grad():
        got = model(x)
    want = model(x).detach()
    assert (got - want).abs().max().item() <= bar
