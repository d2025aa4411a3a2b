"""PyTorch port on the card: MedNeXt-L k5 (``models/mednext.py``) and its 5^3
depthwise kernel (``csrc/depthwise_conv.cu``, ``dw5_*``): the kernel against
its plain version at each of the model's five block shapes at B 16 (bf16 and
float32, with and without a bias), the 3^3 kernel's bits unchanged, the
forward graphed (``utils/graphs.py``) against eager at B 2 and B 16 (a
volume's one chunk of 128^3 windows), its launches (54 of the 5^3 kernel,
62 of K2, none of the 3^3 kernel), and bfloat16 against the float32
reference (``cellbench/reference/mednext.py``, TF32 off) with the reference
in fp8 outside the same tolerance.  Skips without a GPU.  A GPU machine need
not have JAX, which ``tests/conftest.py`` imports, so run it there without
the conftest:

    python -m pytest --noconftest tests/test_torch_mednext_cuda.py -q
"""

import hashlib

import pytest
import torch

from cellbench.reference import mednext as R
from cellbench.reference.unet import fake_quant
from light_unet_tpu_torch.config import ModelConfig
from light_unet_tpu_torch.models import mednext as M
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.ops import depthwise_kernel as dk
from light_unet_tpu_torch.ops import norm_kernel
from light_unet_tpu_torch.utils.graphs import GraphRunner

torch.backends.cudnn.allow_tf32 = False  # float32 references in full float32
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.cuda

PATCH = 128
# (side, C) of the block depthwise convs of a 128^3 window at MedNeXt-L's widths
BLOCK_SHAPES = [(128, 32), (64, 64), (32, 128), (16, 256), (8, 512)]
# bfloat16 against the float32 reference on 2 windows of 128^3: the CPU's
# tolerance at tiny widths (tests/test_torch_mednext.py), which the
# reference in fp8 e4m3 must exceed
BF16_MAX, BF16_MEAN = 0.03, 0.004
# sha256 of the 3^3 kernel's bf16 outputs on seeded inputs (shape, seed),
# as the kernel before the 5^3 variant gave them on an H100
DW3_DIGESTS = {
    ((8, 48, 48, 48, 16), 0): "dde8ba087644ea1bbd67fb630f26c830b3c9601fa26bbffd48472581608c22a5",
    ((8, 24, 24, 24, 64), 1): "2232058a2035519e97818bf0538257bd1796b9b30807d5db9c59a54ee07f73d8"}


@pytest.fixture(scope="module")
def cfg():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mc = ModelConfig(name="MedNeXt")
    mc.validate()
    return mc


@pytest.fixture
def gen(cfg):
    return torch.Generator(device="cuda").manual_seed(0)


def seeded_state(model, seed=0):
    """Seeded weights in upstream's names, made on the card: uniform in
    +-1/sqrt(fan_in) (a 1^3 transposed conv's fan-in is its input channels),
    norm scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1), ``dummy_tensor`` 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = t.shape
        if name == "dummy_tensor":
            out[name] = torch.ones(shape, device="cuda")
        elif len(shape) >= 2:
            transposed_1x1 = name.startswith(("up_", "out_0")) and shape[2:].numel() == 1
            bound = (shape[0] if transposed_1x1 else shape[1:].numel()) ** -0.5
            out[name] = torch.rand(shape, generator=g, device="cuda") * (2 * bound) - bound
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * torch.randn(shape, generator=g, device="cuda")
        else:
            out[name] = 0.1 * torch.randn(shape, generator=g, device="cuda")
    return out


@pytest.fixture(scope="module")
def port(cfg):
    model = build_model(cfg, torch.bfloat16, inference=True).cuda().eval()
    model.load_state_dict(seeded_state(model), strict=True)
    return model


def windows(batch, seed=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((batch, PATCH, PATCH, PATCH, 1), generator=g, device="cuda")


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("side,c", BLOCK_SHAPES, ids=str)
def test_k5_kernel_matches_plain_at_the_block_shapes(gen, side, c, dtype, bias):
    """Both sum the 125 products (and the bias) in float32, in different
    orders, and round once: float32 within ``order_bound``, bf16 within one
    unit beyond it (``gap_ulps``)."""
    x = torch.randn((16, side, side, side, c), generator=gen, device="cuda").to(dtype)
    w = (torch.rand((c, 1, 5, 5, 5), generator=gen, device="cuda") * 2 - 1) / 125 ** 0.5
    b = 0.1 * torch.randn((c,), generator=gen, device="cuda") if bias else None
    n = dk.counts5["launches"]
    got = dk.depthwise_conv3d_k5(x, w, b)
    assert dk.counts5["launches"] == n + 1
    torch.cuda.synchronize()
    want = dk.reference_depthwise_conv3d_k5(x, w, b)
    assert got.shape == want.shape and got.dtype == want.dtype
    if dtype == torch.bfloat16:
        assert dk.gap_ulps(got, want, x, w, b) <= 1.0
    else:
        assert bool(((got - want).abs() <= dk.order_bound(x, w, b)).all())
    assert torch.equal(dk.depthwise_conv3d_k5(x, w, b), got)  # the same bits again


@pytest.mark.parametrize("shape", [(1, 5, 7, 9, 8), (2, 3, 11, 13, 24), (1, 1, 1, 1, 16),
                                   (3, 9, 6, 21, 40)], ids=str)
def test_k5_kernel_off_the_block_shapes(gen, shape):
    """Ragged sides, fewer planes than the halo, C of 8, 24 and 40 (the 8- and
    16-channel tiles)."""
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    c = shape[-1]
    w = (torch.rand((c, 1, 5, 5, 5), generator=gen, device="cuda") * 2 - 1) / 125 ** 0.5
    b = 0.1 * torch.randn((c,), generator=gen, device="cuda")
    got = dk.depthwise_conv3d_k5(x, w, b)
    torch.cuda.synchronize()
    assert dk.gap_ulps(got, dk.reference_depthwise_conv3d_k5(x, w, b), x, w, b) <= 1.0


def dw3_digest(shape, seed) -> str:
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    w = (torch.rand((shape[-1], 1, 3, 3, 3), generator=g, device="cuda") * 2 - 1) / 27 ** 0.5
    y = dk.depthwise_conv3d(x, w)
    torch.cuda.synchronize()
    return hashlib.sha256(y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("case", list(DW3_DIGESTS), ids=str)
def test_the_3x3x3_kernel_keeps_its_bits(cfg, case):
    assert dw3_digest(*case) == DW3_DIGESTS[case]


@pytest.mark.parametrize("batch", [2, 16])
@torch.no_grad()
def test_forward_graphed_equals_eager_and_launches(port, batch):
    """Eager, captured, replayed: the same bits; each forward and each replay
    launches the 5^3 kernel once a block (54), K2 once a norm (54 blocks +
    8 resampling blocks) and no 3^3 kernel."""
    x = windows(batch)
    n5, n2, n3 = dk.counts5["launches"], norm_kernel.launches, dk.launches
    eager = port(x)
    assert (dk.counts5["launches"] - n5, norm_kernel.launches - n2, dk.launches - n3) == (
        54, 62, 0)
    runner = GraphRunner("window", "cuda")
    first = runner(("fwd", batch), port, x)[0].clone()
    n5, n2, calls = dk.counts5["launches"], norm_kernel.launches, M.counts["dw5_calls"]
    replayed = runner(("fwd", batch), port, x)[0].clone()
    assert (dk.counts5["launches"] - n5, norm_kernel.launches - n2,
            M.counts["dw5_calls"] - calls) == (54, 62, 54)
    assert torch.equal(first, eager) and torch.equal(replayed, eager)
    assert eager.dtype == torch.float32 and eager.shape == (batch, PATCH, PATCH, PATCH, 1)


@torch.no_grad()
def test_bfloat16_against_the_float32_reference_and_fp8_outside(cfg, port):
    settings = {k: getattr(cfg, k) for k in ("n_channels", "exp_r", "block_counts",
                                             "kernel_size", "output_channels")}
    state = port.state_dict()
    x = windows(2, seed=3)
    got = port(x)[..., 0]
    ref = R.MedNeXt(settings).cuda().eval()
    ref.load_state_dict(state, strict=True)
    want = ref(x[..., 0][:, None])[:, 0]
    gap = (got - want).abs()
    del ref
    low = R.MedNeXt(settings, fake_quant()).cuda().eval()
    low.load_state_dict(state, strict=True)
    control = (low(x[..., 0][:, None])[:, 0] - want).abs()
    print(f"bf16 against float32: max {gap.max().item():.5f}, mean {gap.mean().item():.6f}; "
          f"fp8: max {control.max().item():.5f}, mean {control.mean().item():.6f}")
    assert gap.max().item() <= BF16_MAX and gap.mean().item() <= BF16_MEAN
    assert control.max().item() > BF16_MAX and control.mean().item() > BF16_MEAN
