"""PyTorch port on the card: each CUDA kernel against its plain version at
small shapes, and the body mask and the fused per-volume pipeline against
the same code on the CPU.  Skips without a GPU.  A GPU machine need not have JAX, which
``tests/conftest.py`` imports, so run it there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from light_unet_tpu_torch.config import Config, ModelConfig
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.unet3d import ResidualBlock, build_model, init_weights
from light_unet_tpu_torch.ops import block_kernel, ccl, norm_kernel
from light_unet_tpu_torch.ops.fused import FusedVolumePipeline, normalize_and_body_mask
from light_unet_tpu_torch.ops.sliding_window import HostPrefetch
from light_unet_tpu_torch.ops.sparse_fetch import SparsePack
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


def _phantom(shape=(40, 36, 50), seed=0):
    """A raw SUV-like volume: a body ellipsoid over air, hot spheres."""
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    c = [s / 2 for s in shape]
    body = sum((g - m) ** 2 / (0.42 * s) ** 2 for g, m, s in zip((zz, yy, xx), c, shape)) <= 1.0
    img = body * (1.5 + 0.5 * rng.random(shape)) + 0.02 * rng.random(shape)
    for _ in range(3):
        p = [int(rng.integers(int(s * 0.35), int(s * 0.65))) for s in shape]
        img[(zz - p[0]) ** 2 + (yy - p[1]) ** 2 + (xx - p[2]) ** 2 <= 9] = 8.0
    return img.astype(np.float32)


@pytest.mark.parametrize("z_bucket", [1, 16])
def test_body_mask_on_the_card_equals_the_cpu(gen, z_bucket):
    """normalize_and_body_mask on cuda and on cpu: masks, counts and bboxes
    equal, normalized volumes within 1e-6."""
    cfg = Config()
    img = _phantom()
    got = normalize_and_body_mask(img, cfg.data.intensity, cfg.data.body_mask, z_bucket, "cuda")
    want = normalize_and_body_mask(img, cfg.data.intensity, cfg.data.body_mask, z_bucket, "cpu")
    assert np.abs(got[0] - want[0]).max() <= 1e-6
    assert np.array_equal(got[1], want[1]) and got[1].sum() > 0
    assert got[2] == want[2] and got[3] == want[3]


def test_largest_component_on_the_card_equals_the_cpu(gen):
    mask = (torch.rand((30, 33, 37), generator=gen, device="cuda") < 0.35).float()
    got = ccl.keep_largest_component(mask)
    assert torch.equal(got.cpu(), ccl.keep_largest_component(mask.cpu()))
    assert torch.equal(ccl.label_propagate(mask).cpu(), ccl.label_propagate(mask.cpu()))


def _fused_pipeline(device, **tpu):
    cfg = Config.from_dict({"data": {"patch_size": [16, 16, 16]},
                            "model": {"encoder_channels": [4, 8, 16, 32]},
                            "tpu": dict({"z_bucket": 16}, **tpu)})
    model = init_weights(build_model(cfg.model, torch.float32, inference=True),
                         torch.Generator().manual_seed(3)).to(device).eval()
    return FusedVolumePipeline(model, cfg, patch_batch=8, device=device)


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("fetch", ["float32", "uint16"])
def test_fused_pipeline_on_the_card_equals_the_cpu(gen, sparse, fetch):
    """uint16 upload, dense or sparse fetch behind the host prefetch: the
    card's map equals the CPU's within 1e-5 (plus one level when quantized),
    zero on the same voxels; a sparse dispatch prefetches only its count."""
    img = _phantom()
    card = _fused_pipeline("cuda", sparse_fetch=sparse, fetch_dtype=fetch)
    dispatched = card.dispatch(img)
    assert isinstance(dispatched[0], HostPrefetch)
    assert dispatched[0].host.is_pinned()
    if sparse:
        assert isinstance(dispatched[0].out, SparsePack) and dispatched[0].host.numel() == 1
    got = card.fetch(dispatched)
    want = _fused_pipeline("cpu", sparse_fetch=sparse, fetch_dtype=fetch)(img)
    bar = 1e-5 + (1.0 / 65535 if fetch == "uint16" else 0.0)
    assert got.shape == img.shape and np.abs(got - want).max() <= bar
    assert np.array_equal(got == 0, want == 0) and 0 < (got == 0).mean() < 1
    card.host_prefetch = False
    assert np.array_equal(card(img), got)


# --- the train stage: guarded AdamW, the validation sweep, the corpus gather,
# the sliding window's host prefetch ------------------------------------------


def test_guarded_adamw_on_the_card_equals_the_cpu(gen):
    """One finite and one skipped (nan) step, float32: the card's parameters,
    moments and count equal the CPU's within 1e-6 relative (the two devices'
    ``pow`` and ``sqrt`` may differ in the last bit)."""
    from light_unet_tpu_torch.core.trainer import GuardedAdamW

    shapes = [(16, 1, 3, 3, 3), (32, 16, 1, 1, 1), (16,)]
    init = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    opts = {}
    for dev in ("cuda", "cpu"):
        params = [torch.nn.Parameter(t.to(dev).clone()) for t in init]
        opt = GuardedAdamW(params, 1e-3, 1e-5)
        assert float(opt.step([g.to(dev) for g in grads], torch.tensor(0.5, device=dev))) == 1.0
        bad = [g.to(dev).clone() for g in grads]
        bad[1][0, 0] = float("nan")
        assert float(opt.step(bad, torch.tensor(0.5, device=dev))) == 0.0
        opts[dev] = opt
    for name in ("flat", "mu", "nu"):
        a, b = getattr(opts["cuda"], name).cpu(), getattr(opts["cpu"], name)
        assert (a - b).abs().max() <= 1e-6 * b.abs().max(), name
    assert int(opts["cuda"].count) == int(opts["cpu"].count) == 1


@pytest.mark.parametrize("quantized", [False, True])
def test_validation_sweep_on_the_card_equals_the_cpu(gen, quantized):
    """The per-threshold counts and sums of a seeded, bucket-padded map are
    equal on the card and on the CPU (all integer)."""
    from light_unet_tpu_torch.ops.sliding_window import quantize_out
    from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep

    rng = np.random.default_rng(0)
    shape = (30, 28, 34)
    target = np.zeros(shape, np.float32)
    for _ in range(4):
        c = rng.integers(4, np.array(shape) - 4)
        target[c[0] - 2:c[0] + 2, c[1] - 2:c[1] + 2, c[2] - 2:c[2] + 2] = 1
    prob = np.clip(target * 0.7 + rng.random(shape, dtype=np.float32) * 0.35, 0, 1)
    padded = torch.nn.functional.pad(torch.from_numpy(prob.astype(np.float32)), (0, 14))
    if quantized:
        padded = quantize_out(padded)
    res = {}
    for dev in ("cuda", "cpu"):
        sweep = DeviceValidationSweep([0.1, 0.3, 0.5, 0.7], n_gt_cap=16, device=dev)
        assert sweep.add_case("c", target)
        res[dev] = sweep.case_metrics("c", padded.to(dev), (4.0, 4.0, 4.0))
    assert res["cuda"] is not None and res["cuda"] == res["cpu"]


def test_gather_patches_on_the_card_equals_the_cpu(gen):
    from light_unet_tpu_torch.datasets.device_corpus import gather_patches

    images = torch.randint(-32768, 32767, (3, 40, 41, 48), generator=gen, device="cuda",
                           dtype=torch.int16)
    labels = (torch.rand((3, 40, 41, 48), generator=gen, device="cuda") < 0.3).to(torch.uint8)
    corners = torch.tensor([[0, 0, 0, 0], [2, 24, 25, 32], [1, 7, 0, 19]], dtype=torch.int32)
    got = gather_patches(images, labels, corners.cuda(), (16, 16, 16))
    want = gather_patches(images.cpu(), labels.cpu(), corners, (16, 16, 16))
    assert got[0].shape == (3, 16, 16, 16, 1)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("fetch", ["float32", "uint16"])
def test_sliding_window_host_prefetch_on_the_card(gen, fetch):
    """The map copies into pinned memory at dispatch; it equals the map
    fetched without the prefetch."""
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer

    cfg = Config.from_dict({"model": {"encoder_channels": [4, 8, 16, 32]}})
    model = init_weights(build_model(cfg.model, torch.float32, inference=True),
                         torch.Generator().manual_seed(3)).cuda().eval()
    vol = np.random.default_rng(1).random((20, 18, 30), dtype=np.float32)
    maps = []
    for prefetch in (True, False):
        sw = SlidingWindowInferencer(model, (16, 16, 16), patch_batch=8, z_bucket=16,
                                     transfer_dtype="uint16", fetch_dtype=fetch,
                                     host_prefetch=prefetch, device="cuda")
        out = sw.dispatch(sw.prepare(vol))
        assert isinstance(out[0], HostPrefetch) == prefetch
        if prefetch:
            assert out[0].host.is_pinned()
        maps.append(sw.fetch(out))
    assert np.array_equal(maps[0], maps[1])
