"""PyTorch port on the card: each CUDA kernel against its plain version at
small shapes.  Skips without a GPU.  A GPU machine need not have JAX, which
``tests/conftest.py`` imports, so run it there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from light_unet_tpu_torch.config import ModelConfig
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.unet3d import ResidualBlock, build_model, init_weights
from light_unet_tpu_torch.ops import block_kernel, norm_kernel
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(2, 8, 8, 8, 16), (3, 6, 6, 6, 128), (2, 5, 7, 9, 3)])
def test_norm_kernel_matches_plain(gen, shape, dtype, bar):
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    s = 0.5 + 0.05 * torch.randn(shape[-1], generator=gen, device="cuda")
    b = 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
    n = norm_kernel.launches
    got = norm_kernel.fused_instance_norm_leaky_relu(x, s, b)
    assert norm_kernel.launches == n + 1
    want = norm_kernel.reference_instance_norm_leaky_relu(x, s, b)
    assert (got.float() - want.float()).abs().max().item() <= bar


def _norm_inputs(gen, shape, dtype):
    x = (torch.randn(shape, generator=gen, device="cuda") * 3 + 1).to(dtype)
    s = 0.5 + 0.05 * torch.randn(shape[-1], generator=gen, device="cuda")
    b = 0.1 * torch.randn(shape[-1], generator=gen, device="cuda")
    return x, s, b


# shapes of K2 beyond the serving ones: S not a multiple of the chunk (k > 1,
# a short last chunk), C in {1, 3, 5, 16, 128} held whole and in chunks,
# B = 1, B over one round (48^3 x 16 bf16 takes 8 samples a round), float32
# at 48^3, and a float32 96^3 sample too large to hold on chip (streams)
NORM_CASES = [
    (2, 33, 35, 37, 16), (1, 33, 35, 37, 3), (2, 29, 31, 30, 1), (2, 20, 21, 22, 5),
    (1, 24, 24, 24, 128), (3, 6, 6, 6, 1), (2, 7, 5, 3, 5), (20, 48, 48, 48, 16),
    (2, 48, 48, 48, 16), (1, 96, 96, 96, 16),
]


@pytest.mark.parametrize("slope", [0.01, 1.0])
@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", NORM_CASES, ids=str)
def test_norm_kernel_shapes(gen, shape, dtype, bar, slope):
    x, s, b = _norm_inputs(gen, shape, dtype)
    got = norm_kernel.fused_instance_norm_leaky_relu(x, s, b, negative_slope=slope)
    want = norm_kernel.reference_instance_norm_leaky_relu(x, s, b, negative_slope=slope)
    assert got.shape == x.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(20, 48, 48, 48, 16), (192, 6, 6, 6, 128), (2, 20, 21, 22, 5)],
                         ids=str)
def test_norm_kernel_is_deterministic_and_leaves_counters_ready(gen, shape, dtype):
    """Two calls on one input give the same bits, and each call leaves every
    sample's arrival counter at 0, so the next call needs no memset."""
    x, s, b = _norm_inputs(gen, shape, dtype)
    first = norm_kernel.fused_instance_norm_leaky_relu(x, s, b)
    second = norm_kernel.fused_instance_norm_leaky_relu(x, s, b)
    assert torch.equal(first, second)
    for (dev, _, bb, ss, cc, dt), (plan, _, sync) in norm_kernel._workspaces.items():
        if (bb, ss, cc, dt) == (shape[0], shape[1] * shape[2] * shape[3], shape[4], dtype):
            assert int(sync[:, 0].abs().sum()) == 0
            assert plan[0] == 1 or int(sync[:, 1].min()) >= 2  # one generation per call
    x2, s2, b2 = _norm_inputs(gen, shape, dtype)  # a new input right after: still right
    got = norm_kernel.fused_instance_norm_leaky_relu(x2, s2, b2)
    want = norm_kernel.reference_instance_norm_leaky_relu(x2, s2, b2)
    bar = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= bar


def test_norm_kernel_takes_unaligned_and_strided_input(gen):
    x, s, b = _norm_inputs(gen, (2, 9, 9, 9, 17), torch.bfloat16)
    flat = torch.cat([x.new_zeros(1), x[..., 1:].flatten()])
    views = [x[..., 1:],                         # C = 16 view, not contiguous
             flat[1:].view(2, 9, 9, 9, 16)]      # contiguous, base 2 bytes off 16
    for xv in views:
        got = norm_kernel.fused_instance_norm_leaky_relu(xv, s[1:], b[1:])
        want = norm_kernel.reference_instance_norm_leaky_relu(xv, s[1:], b[1:])
        assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(192, 48, 48, 48, 16), (192, 24, 24, 24, 32),
                                   (192, 12, 12, 12, 64), (192, 6, 6, 6, 128)] + NORM_CASES,
                         ids=str)
def test_norm_plan_matches_mirror(gen, shape, dtype):
    from torch_norm_plan import H100, norm_plan  # tests/ is on the path (pytest prepend mode)

    plan = norm_kernel.kernel_plan(shape, dtype)
    props = torch.cuda.get_device_properties(0)
    b, d, h, w, c = shape
    want = norm_plan(
        torch.tensor([], dtype=dtype).element_size(), b, d * h * w, c, sms=plan["sms"],
        smem_per_sm=getattr(props, "shared_memory_per_multiprocessor", H100["smem_per_sm"]),
        smem_per_block=getattr(props, "shared_memory_per_block_optin", H100["smem_per_block"]),
        ctas_per_sm=plan["ctas_per_sm"])
    assert plan == want


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-4), (torch.bfloat16, 5e-2)])
def test_fused_model_matches_plain_model(gen, dtype, bar):
    model = init_weights(build_model(ModelConfig(), dtype, inference=True),
                         torch.Generator().manual_seed(0)).cuda().eval()
    x = torch.rand((2, 16, 16, 24, 1), generator=gen, device="cuda")
    n = block_kernel.launches
    with torch.no_grad():
        got = make_fused_apply(model)(x)
        want = model(x)
    assert block_kernel.launches == n + 8
    assert (got - want).abs().max().item() <= bar


# (input shape, C) for the block kernel: the 8 serving blocks of a 48^3
# patch at B = 2, then shapes off the serving path
BLOCK_CASES = [
    ((2, 48, 48, 48, 1), 16), ((2, 24, 24, 24, 16), 32), ((2, 12, 12, 12, 32), 64),
    ((2, 6, 6, 6, 64), 128), ((2, 6, 6, 6, 128), 128), ((2, 12, 12, 12, 128), 64),
    ((2, 24, 24, 24, 64), 32), ((2, 48, 48, 48, 32), 16),
    ((2, 5, 7, 9, 16), 32),      # ragged, mma path
    ((2, 5, 7, 9, 3), 5),        # ragged, channels off the mma tile
    ((1, 6, 10, 12, 1), 16),     # Cin = 1, B = 1
    ((1, 9, 6, 13, 32), 32),     # identity block, mma path, B = 1
    ((2, 4, 4, 4, 24), 24),      # identity block off the mma tile
    ((1, 3, 8, 16, 48), 16),     # Cin off the mma tile, C on it
]


def _block(cin, c, dtype, seed=0):
    blk = ResidualBlock(cin, c, dropout_p=0.0, compute_dtype=dtype)
    return init_weights(blk, torch.Generator().manual_seed(seed)).cuda().eval()


def test_block_cases_cover_both_paths():
    paths = {block_kernel.mma_paths(shape[-1], c, torch.bfloat16) for shape, c in BLOCK_CASES}
    assert {(True, True), (False, True), (False, False)} <= paths


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 5e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,c", BLOCK_CASES, ids=lambda v: str(v))
def test_block_kernel_matches_plain(gen, shape, c, dtype, bar):
    """Max error relative to max(|ref|, 1): f32 sums in another order, and in
    bf16 one rounding flip of an intermediate moves the output by an ulp."""
    blk = _block(shape[-1], c, dtype)
    x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    n = block_kernel.launches
    got = block_kernel.fused_residual_block(x, blk)
    assert block_kernel.launches == n + 1
    want = block_kernel.reference_residual_block(x, blk)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    scale = max(want.float().abs().max().item(), 1.0)
    assert (got.float() - want.float()).abs().max().item() / scale <= bar


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_kernel_follows_weight_update(gen, dtype):
    blk = _block(32, 64, dtype)
    x = torch.randn((2, 8, 8, 8, 32), generator=gen, device="cuda").to(dtype)
    block_kernel.fused_residual_block(x, blk)
    with torch.no_grad():
        blk.conv2.pointwise.weight.mul_(-1.5)
        blk.shortcut[0].weight.add_(0.1)
    got = block_kernel.fused_residual_block(x, blk)
    want = block_kernel.reference_residual_block(x, blk)
    scale = max(want.float().abs().max().item(), 1.0)
    bar = 5e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() / scale <= bar


def test_block_plan_fits(gen):
    for shape, c in BLOCK_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            plan = block_kernel.kernel_plan(shape, c, dtype)
            assert all(p[0] > 0 and p[3] > 0 for p in plan.values()), (shape, c, plan)
