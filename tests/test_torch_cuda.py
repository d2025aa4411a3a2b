"""PyTorch port on the card: each CUDA kernel against its plain version at
small shapes, the body mask and the fused per-volume pipeline against the
same code on the CPU, and the CUDA graphs of the training dispatch units and
the window's chunk forward against their eager paths.  Skips without a GPU.  A GPU machine need not have JAX, which
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
@pytest.mark.parametrize("shape", [(20, 48, 48, 48, 16), (192, 6, 6, 6, 128), (2, 20, 21, 22, 5),
                                   (2, 96, 96, 96, 48)], ids=str)
def test_norm_kernel_is_deterministic_and_leaves_counters_ready(gen, shape, dtype):
    """Two calls on one input give the same bits, and each call leaves every
    sample's arrival counters (of the partials and, streaming, of the
    coefficients) at 0, so the next call needs no memset."""
    x, s, b = _norm_inputs(gen, shape, dtype)
    first = norm_kernel.fused_instance_norm_leaky_relu(x, s, b)
    second = norm_kernel.fused_instance_norm_leaky_relu(x, s, b)
    assert torch.equal(first, second)
    for (dev, _, bb, ss, cc, dt), (plan, _, sync) in norm_kernel._workspaces.items():
        if (bb, ss, cc, dt) == (shape[0], shape[1] * shape[2] * shape[3], shape[4], dtype):
            assert int(sync[:, 0].abs().sum()) == 0 and int(sync[:, 2].abs().sum()) == 0
            assert plan[0] == 1 or int(sync[:, 1].min()) >= 2  # one generation per call
            assert not plan[7] or int(sync[:, 3].min()) >= 2
    x2, s2, b2 = _norm_inputs(gen, shape, dtype)  # a new input right after: still right
    got = norm_kernel.fused_instance_norm_leaky_relu(x2, s2, b2)
    want = norm_kernel.reference_instance_norm_leaky_relu(x2, s2, b2)
    bar = 1e-4 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= bar


@pytest.mark.parametrize("shape,affine,slope,streams", [
    ((20, 96, 96, 96, 48), False, 0.01, 1), ((20, 96, 96, 96, 48), False, 1.0, 1),
    ((192, 48, 48, 48, 16), True, 0.01, 0)], ids=str)
def test_norm_kernel_at_the_models_large_shapes(gen, shape, affine, slope, streams):
    """SwinUNETR's 96^3 x 48 chunk of 20 windows (non-affine, 85 MB a
    sample: the streaming variant) and the U-Net's 192 x 48^3 x 16 (affine,
    held on chip): within the bf16 bar of the plain chain."""
    x, s, b = _norm_inputs(gen, shape, torch.bfloat16)
    if not affine:
        s, b = torch.ones_like(s), torch.zeros_like(b)
    assert norm_kernel.kernel_plan(shape, torch.bfloat16)["streams"] == streams
    got = norm_kernel.fused_instance_norm_leaky_relu(x, s, b, negative_slope=slope)
    want = norm_kernel.reference_instance_norm_leaky_relu(
        x, s if affine else None, b if affine else None, negative_slope=slope)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


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


def _fused_pipeline(device, graphs=True, **tpu):
    cfg = Config.from_dict({"data": {"patch_size": [16, 16, 16]},
                            "model": {"encoder_channels": [4, 8, 16, 32]},
                            "tpu": dict({"z_bucket": 16}, **tpu)})
    model = init_weights(build_model(cfg.model, torch.float32, inference=True),
                         torch.Generator().manual_seed(3)).to(device).eval()
    return FusedVolumePipeline(model, cfg, patch_batch=8, graphs=graphs, device=device)


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


def test_float32_inferencer_on_the_card_equals_the_cpu(gen, tmp_path, monkeypatch):
    """With TF32 on globally (cuDNN's default), a float32 ``Inferencer`` on
    the card serves the CPU's map within 1e-4: its launches run without
    TF32, and the flags are on again afterwards."""
    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.utils import nifti

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    data = tmp_path / "processed"
    (data / "images").mkdir(parents=True)
    vol = np.random.default_rng(2).random((24, 24, 40), dtype=np.float32)
    nifti.save(nifti.Nifti1Image(vol, np.diag([4.0, 4.0, 4.0, 1.0])), data / "images/0001_0000.nii.gz")
    cfg = {"data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
           "tpu": {"compute_dtype": "float32", "fetch_dtype": "float32", "patch_batch": 8,
                   "z_bucket": 16}}
    model = init_weights(build_model(Config.from_dict(cfg).model, torch.float32, inference=True),
                         torch.Generator().manual_seed(4))
    ckpt = tmp_path / "model.pth"
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, ckpt)
    maps = {}
    for device in ("cuda", "cpu"):
        inf = Inferencer(cfg, ckpt, workdir=str(tmp_path / device), device=device)
        assert inf.infer_case("0001", data)
        maps[device] = nifti.load(tmp_path / device / "inference/prob_maps/0001_prob.nii.gz"
                                  ).get_fdata(np.float32)
    assert maps["cpu"].shape == vol.shape and np.ptp(maps["cpu"]) > 0
    assert np.abs(maps["cuda"] - maps["cpu"]).max() <= 1e-4
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_host_library_builds_clean_and_decodes_a_volume_from_the_card(gen, tmp_path, monkeypatch):
    """On the card's host: ``csrc/fastio.cpp`` builds from an empty build
    directory, and ``fastio.load_f32`` of a volume computed on the card and
    written as ``.nii.gz`` equals the plain codec bit for bit."""
    from light_unet_tpu_torch.ops import _build
    from light_unet_tpu_torch.utils import fastio, nifti

    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_kernels_build")
    monkeypatch.setattr(fastio, "_lib", None)
    vol = (torch.randn((40, 36, 50), generator=gen, device="cuda") * 3).cpu().numpy()
    path = tmp_path / "card.nii.gz"
    nifti.save(nifti.Nifti1Image(vol, np.diag([4.0, 4.0, 4.0, 1.0])), path)
    got, hdr = fastio.load_f32(path)
    assert (tmp_path / "_kernels_build" / _build.host_hash("fastio") / "libfastio.so").exists()
    img = nifti.load(path)
    want = img.get_fdata(np.float32)
    assert got.shape == want.shape and np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert hdr.raw == img.header.raw


# --- CUDA graphs (``utils/graphs.py``): the training dispatch units and the
# sliding window's chunk forward, each replayed against its eager path --------

def _graph_tree(tmp):
    """Three seeded 20x24x28 phantoms (a body block, a hot cube as the
    lesion), written with the port's own NIfTI codec: 0001-0002 train, 0003
    validates."""
    from light_unet_tpu_torch.utils import nifti

    rng = np.random.default_rng(5)
    data = tmp / "proc"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in ("0001", "0002", "0003"):
        img = (0.2 * rng.random((20, 24, 28))).astype(np.float32)
        img[3:17, 4:20, 4:24] += 0.3
        lab = np.zeros(img.shape, np.uint8)
        z, y, x = rng.integers(5, 12), rng.integers(6, 14), rng.integers(6, 18)
        lab[z:z + 4, y:y + 4, x:x + 4] = 1
        img[lab > 0] = 0.9
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab, aff), data / f"labels/{cid}.nii.gz")
    splits = tmp / "splits"
    splits.mkdir()
    for name, ids in (("train", ["0001", "0002"]), ("val", ["0003"]), ("test", [])):
        (splits / f"{name}_list.txt").write_text("".join(f"{i}\n" for i in ids))
    return data, splits


def _graph_trainer(tmp, name, graphs):
    """A float32 trainer at 16^3 (K = 4, separable augmentation and dropout
    on) whose corpus holds one planted row more: labels of 2, which the
    wrapped loss turns into a non-finite step (skipped by GuardedAdamW)."""
    from light_unet_tpu_torch.core.trainer import Trainer

    data, splits = (tmp / "proc", tmp / "splits") if (tmp / "proc").exists() else _graph_tree(tmp)
    cfg = {"data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
           "model": {"encoder_channels": [16, 32, 64, 128]},
           "tpu": {"compute_dtype": "float32", "patch_batch": 8, "z_bucket": 16,
                   "steps_per_dispatch": 4, "separable_augment": True},
           "training": {"batch_size": 2, "learning_rate": 1e-3, "use_warmup": False},
           "output": {"save_every_n_epochs": 1},
           "data_dir": str(data), "splits_dir": str(splits)}
    tr = Trainer(Config.from_dict(cfg), workdir=str(tmp / name), device="cuda", graphs=graphs)
    assert (tr.graphs is not None) == graphs and tr.corpus is not None
    c = tr.corpus
    c.images = torch.cat([c.images, c.images[:1]])
    c.labels = torch.cat([c.labels, torch.full_like(c.labels[:1], 2)])
    base = tr.loss_fn

    def loss_fn(probs, labels):
        # a constant NaN added: the gradients stay finite, the loss does not
        nan = torch.where((labels > 1).any(), float("nan"), 0.0)
        return base(probs, labels) + nan

    tr.loss_fn = loss_fn
    tr.model.train()
    tr._set_lr(1e-3)
    return tr


def _graph_units(tr):
    """15 steps as five dispatch units: chains of 4 (the second with the
    planted row in its second step), a tail chain of 2, a single step, a
    chain of 4."""
    draw = tr.train_loader.sample_corners
    units = [np.stack([draw() for _ in range(k)]) for k in (4, 4, 2)] + [draw()]
    units.append(np.stack([draw() for _ in range(4)]))
    units[1][1, 0, 0] = tr.corpus.images.shape[0] - 1
    return units


def _run_units(tr, units):
    losses = tr._flatten_losses([tr._step_on_batch(u) for u in units])
    oks = torch.cat([o.reshape(-1) for o in tr._epoch_oks]).cpu().tolist()
    tr._epoch_oks = []
    return losses, oks


def _state(tr):
    return {k: getattr(tr.opt, k).detach().cpu().clone() for k in ("flat", "mu", "nu", "count")}


def test_graphed_training_equals_the_eager_step(gen, tmp_path, monkeypatch):
    """15 float32 steps (TF32 off) with a tail chain, a single step and a
    planted non-finite batch: graphed and eager give the same losses (1e-5
    relative), parameters and moments (1e-5 abs), skip flags and step
    count, and leave the generator at the same offset.  Graph keys are the
    JAX package's variants; the baked storage stays put.  cuDNN runs its
    deterministic algorithms: its default backward algorithms sum in an
    order that varies from run to run, eager or graphed, and Adam's
    normalized step turns such last-bit differences into parameter
    differences of up to a few learning rates."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = {}
    for graphs in (True, False):
        tr = _graph_trainer(tmp_path, f"g{graphs}", graphs)
        units = _graph_units(tr)
        ptrs = [t.data_ptr() for t in (tr.opt.flat, tr.opt.mu, tr.opt.nu, tr.opt.count,
                                       tr.opt.lr, tr.corpus.images, tr.corpus.labels)]
        losses, oks = _run_units(tr, units)
        assert ptrs == [t.data_ptr() for t in (tr.opt.flat, tr.opt.mu, tr.opt.nu, tr.opt.count,
                                               tr.opt.lr, tr.corpus.images, tr.corpus.labels)]
        runs[graphs] = (losses, oks, _state(tr), tr.gen.get_state(), tr)
    (lg, og, sg, gg, tg), (le, oe, se, ge, _) = runs[True], runs[False]
    assert sorted(k[:-1] for k in tg.graphs.graphs) == [("chain", 2), ("chain", 4), ("step",)]
    assert tg.graphs.replays == 2 and len(lg) == 15
    assert og == oe and og.count(0.0) == 1 and og[5] == 0.0
    assert not np.isfinite(lg[5]) and not np.isfinite(le[5])
    fin = [i for i in range(15) if i != 5]
    assert max(abs(lg[i] - le[i]) / abs(le[i]) for i in fin) <= 1e-5
    for k in ("flat", "mu", "nu"):
        assert (sg[k] - se[k]).abs().max() <= 1e-5, k
    assert int(sg["count"]) == int(se["count"]) == 14
    assert torch.equal(gg, ge)


def test_resumed_graphed_run_equals_the_uninterrupted_one(gen, tmp_path, monkeypatch):
    """A graphed trainer saves after its first units, goes on, then resumes
    from that checkpoint in place (its graphs already captured) and runs the
    same units again; a fresh graphed trainer resumes too: both end where
    the uninterrupted run ended (1e-5), generator state equal (cuDNN's
    deterministic algorithms, as above)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr = _graph_trainer(tmp_path, "resume", True)
    units = _graph_units(tr)
    _run_units(tr, units[:3])
    tr.save_checkpoint_file(0)
    ckpt = tr.checkpoint_dir / "checkpoint_epoch_001.ckpt"
    want_losses, _ = _run_units(tr, units[3:])
    want, want_gen = _state(tr), tr.gen.get_state()
    static = {k: [x.data_ptr() for x in c.inputs] for k, c in tr.graphs.graphs.items()}
    again = [tr]
    fresh = _graph_trainer(tmp_path, "resume_fresh", True)
    again.append(fresh)
    for t in again:
        assert t.resume(ckpt)
        losses, _ = _run_units(t, units[3:])
        if t is tr:  # the static buffers the graphs read kept their storage
            assert static == {k: [x.data_ptr() for x in c.inputs]
                              for k, c in tr.graphs.graphs.items()}
        got = _state(t)
        assert np.allclose(losses, want_losses, rtol=1e-5, atol=0)
        for k in ("flat", "mu", "nu"):
            assert (got[k] - want[k]).abs().max() <= 1e-5, k
        assert int(got["count"]) == int(want["count"])
        assert torch.equal(t.gen.get_state(), want_gen)


@pytest.fixture
def no_plain_norm_on_cuda(monkeypatch):
    """The plain chain raises on a CUDA tensor (the CPU keeps it)."""
    from light_unet_tpu_torch.models import unet3d

    plain = unet3d.reference_instance_norm_leaky_relu

    def cpu_only(x, *a, **k):
        if x.is_cuda:
            raise AssertionError("the plain norm chain ran on a CUDA tensor")
        return plain(x, *a, **k)

    monkeypatch.setattr(unet3d, "reference_instance_norm_leaky_relu", cpu_only)


def test_an_eval_forward_takes_the_norm_kernel(gen, no_plain_norm_on_cuda):
    """A bf16 eval forward without grad launches the norm kernel once a norm
    (23) and never runs the plain chain; two models of the same weights give
    the same map bit for bit."""
    x = torch.rand((2, 48, 48, 48, 1), generator=gen, device="cuda")
    outs = []
    for _ in range(2):
        model, _ = _route_fn("plain", torch.bfloat16)
        n = norm_kernel.launches
        with torch.no_grad():
            outs.append(model(x))
        assert norm_kernel.launches - n == 23
    assert torch.equal(outs[0], outs[1])


def test_a_forward_autograd_records_launches_no_norm_kernel(gen):
    """Train mode, or eval with grad on (the parameters need it): the plain
    chain, no norm-kernel launch, and a backward that reaches the norms."""
    model, _ = _route_fn("plain", torch.bfloat16)
    x = torch.rand((2, 16, 16, 16, 1), generator=gen, device="cuda")
    for train in (False, True):
        model.train(train)
        n = norm_kernel.launches
        model(x).float().mean().backward()
        assert norm_kernel.launches == n
        assert model.init_conv.norm1.weight.grad is not None
        model.zero_grad(set_to_none=True)


def _route_fn(route, dtype):
    model = init_weights(build_model(ModelConfig(), dtype, inference=True),
                         torch.Generator().manual_seed(7)).cuda().eval()
    return model, (make_fused_apply(model) if route == "fused_block" else model)


@pytest.mark.parametrize("dtype,bar", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("route", ["fused_block", "plain"])
def test_chunk_forward_graph_follows_a_weight_change(gen, route, dtype, bar):
    """A chunk forward captured, replayed, then replayed again after an
    in-place weight update agrees with the eager forward on the new weights
    (float32 <= 1e-6 abs, bf16 <= 2e-2 relative to max(|ref|, 1)); the map
    did change."""
    from functools import partial

    from light_unet_tpu_torch.ops.sliding_window import chunk_forward
    from light_unet_tpu_torch.utils.graphs import GraphRunner

    model, apply_fn = _route_fn(route, dtype)
    runner = GraphRunner("window", "cuda")
    fwd = partial(chunk_forward, apply_fn)
    c1, c2 = (torch.rand((8, 16, 16, 16), generator=gen, device="cuda") for _ in range(2))
    key = ("chunk", tuple(c1.shape))
    with torch.no_grad():
        first = runner(key, fwd, c1)[0].clone()
        assert (first - fwd(c1)).abs().max() <= bar
        before = runner(key, fwd, c2)[0].clone()
        for p in model.parameters():
            p.mul_(1.25)
        got = runner(key, fwd, c2)[0].clone()
        want = fwd(c2)
    assert runner.replays == 2 and len(runner.graphs) == 1
    err = (got - want).abs().max().item()
    assert err <= bar * (1.0 if dtype == torch.float32 else max(want.abs().max().item(), 1.0))
    assert (got - before).abs().max() > 10 * max(err, 1e-6)


@pytest.mark.parametrize("route", ["fused_block", "plain"])
def test_chunk_forward_replays_count_kernel_launches(gen, route):
    """Each replay adds the launches one eager forward makes to the kernel's
    counter; the capture adds none."""
    from functools import partial

    from light_unet_tpu_torch.ops.sliding_window import chunk_forward
    from light_unet_tpu_torch.utils.graphs import GraphRunner

    _, apply_fn = _route_fn(route, torch.bfloat16)
    mod = block_kernel if route == "fused_block" else norm_kernel
    fwd = partial(chunk_forward, apply_fn)
    c = torch.rand((8, 16, 16, 16), generator=gen, device="cuda")
    with torch.no_grad():
        n = mod.launches
        fwd(c)
        per_forward = mod.launches - n
        assert per_forward == (8 if route == "fused_block" else 23)
        runner = GraphRunner("window", "cuda")
        n = mod.launches
        runner(("chunk",), fwd, c)  # warm-up + capture
        assert mod.launches == n + per_forward
        for i in range(3):
            runner(("chunk",), fwd, c)
            assert mod.launches == n + (i + 2) * per_forward


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graphed_window_equals_the_eager_window(gen, dtype):
    """``SlidingWindowInferencer`` with graphs (a chunk of 8 and a tail) and
    with ``graphs=False``: the same map bit for bit."""
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer

    _, apply_fn = _route_fn("fused_block", dtype)
    vol = np.random.default_rng(3).random((40, 30, 44), dtype=np.float32)
    maps = []
    for graphs in (True, False):
        sw = SlidingWindowInferencer(apply_fn, (16, 16, 16), patch_batch=16, z_bucket=16,
                                     graphs=graphs, device="cuda")
        assert (sw.graphs is not None) == graphs
        maps.append(sw.fetch(sw.dispatch(sw.prepare(vol))))
        maps.append(sw.fetch(sw.dispatch(sw.prepare(vol))))
    assert all(np.array_equal(maps[0], m) for m in maps[1:])


# ------------------------------------------------- the CCL kernel and the units


def _adversarial(shape=(20, 48, 40)):
    # tests/ is on the path under pytest (no package): a card machine may
    # have a ``tests`` package of its own
    from torch_ccl_masks import adversarial_masks, serpentine

    masks = {k: torch.from_numpy(v) for k, v in adversarial_masks().items()}
    masks["serpentine_big"] = torch.from_numpy(serpentine(*shape))
    return masks


def test_ccl_kernel_equals_the_plain_sweeps(gen):
    """Every adversarial mask (a serpentine of dozens of rounds, one blob,
    one-voxel components, empty, full) and random masks of three densities:
    the kernel's int32 labels equal the plain version's; one launch a call."""
    from light_unet_tpu_torch.ops import ccl_kernel

    masks = _adversarial()
    for p in (0.2, 0.45, 0.7):
        masks[f"random_{p}"] = (torch.rand((33, 35, 37), generator=gen, device="cuda")
                                < p).to(torch.uint8).cpu()
    for name, m in masks.items():
        n = ccl_kernel.launches
        got = ccl_kernel.connected_labels(m.cuda())
        assert ccl_kernel.launches == n + 1 and got.dtype == torch.int32
        assert torch.equal(got.cpu(), ccl_kernel.sweep_labels(m)), name


def test_ccl_kernel_replays_in_a_graph(gen):
    from light_unet_tpu_torch.ops import ccl_kernel
    from light_unet_tpu_torch.utils.graphs import GraphRunner

    runner = GraphRunner("ccl", "cuda")
    from torch_ccl_masks import serpentine

    masks = [torch.from_numpy(serpentine(4, 48, 16))] * 2
    masks += [(torch.rand((4, 48, 16), generator=gen, device="cuda") < p).to(torch.uint8).cpu()
              for p in (0.3, 0.6)]
    n = ccl_kernel.launches
    for m in masks:
        got = runner(("ccl",), ccl_kernel.connected_labels, m.cuda())[0]
        assert torch.equal(got.cpu(), ccl_kernel.sweep_labels(m))
    assert runner.replays == 3 and ccl_kernel.launches == n + 4


def _units_eager_and_graphed(make, run):
    """``run(engine)`` twice per engine, graphed then eager: the outputs."""
    out = {}
    for graphs in (True, False):
        engine = make(graphs)
        out[graphs] = [run(engine) for _ in range(2)]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["fused_block", "plain"])
def test_window_unit_graphed_equals_eager_with_no_host_sync(gen, route, dtype):
    """Every flag on (uint16 in and out, sparse fetch, a packed body mask):
    two volumes of one bucket, graphed and eager, bit-identical, and the
    graphed dispatch makes no host sync."""
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer, on_device

    _, apply_fn = _route_fn(route, dtype)
    rng = np.random.default_rng(5)
    vols = [rng.random(s, dtype=np.float32) for s in ((40, 30, 44), (40, 30, 42))]
    body = [(rng.random(v.shape) > 0.3).astype(np.float32) for v in vols]
    maps = {}
    for graphs in (True, False):
        sw = SlidingWindowInferencer(apply_fn, (16, 16, 16), patch_batch=16, z_bucket=16,
                                     transfer_dtype="uint16", fetch_dtype="uint16",
                                     sparse_fetch=True, graphs=graphs, device="cuda")
        preps = [sw.prepare(v, b) for v, b in zip(vols, body)]
        sw.dispatch(preps[0])  # the warm-up and capture
        torch.cuda.synchronize()
        got = []
        for prep in preps:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = sw.dispatch(prep)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            got.append((on_device(out[0]).clone(), sw.fetch(out)))
        maps[graphs] = got
        assert (sw.graphs is not None) == graphs and (not graphs or sw.graphs.replays == 2)
    for (d1, h1), (d2, h2) in zip(maps[True], maps[False]):
        assert torch.equal(d1, d2) and np.array_equal(h1, h2)


def test_fused_preprocess_table_and_sweep_units_graphed_equal_eager(gen):
    """The fused program, the preprocess pass, the candidate table and the
    validation sweep: graphed and eager bit-identical on two volumes of one
    bucket; none makes a host sync between the upload and the fetch."""
    import functools

    from light_unet_tpu_torch.core.inferencer import table_unit
    from light_unet_tpu_torch.ops import fused
    from light_unet_tpu_torch.ops.sliding_window import on_device
    from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
    from light_unet_tpu_torch.utils.graphs import run_unit, runner_for, unit_key

    def no_sync(fn, *a):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*a)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    imgs = [_phantom((40, 36, 44)), _phantom((40, 36, 40))]
    results = {}
    for graphs in (True, False):
        pipe = _fused_pipeline("cuda", transfer_dtype="uint16", fetch_dtype="uint16",
                               sparse_fetch=True, graphs=graphs)
        preps = [pipe.prepare(i) for i in imgs]
        pipe.dispatch(preps[0])
        n = norm_kernel.launches
        maps = [on_device(no_sync(pipe.dispatch, p)[0]).clone() for p in preps]
        assert norm_kernel.launches > n  # the plain route's norms run the kernel
        cfg = pipe.cfg
        pp = [fused.prepare_preprocess(i, cfg.data.intensity, 16, "cuda") for i in imgs]
        pre_runner = runner_for(torch.device("cuda"), graphs, "preprocess")
        fused.dispatch_preprocess(pp[0], cfg.data.intensity, cfg.data.body_mask, pre_runner)
        pre = [no_sync(fused.dispatch_preprocess, p, cfg.data.intensity, cfg.data.body_mask,
                       pre_runner) for p in pp]
        runner = runner_for(torch.device("cuda"), graphs, "table")
        fn = functools.partial(table_unit, max_components=64)
        thr = torch.full((), 0.3, device="cuda")
        key = unit_key("table", max_components=64)
        run_unit(runner, key, fn, maps[0], thr)
        tables = [no_sync(run_unit, runner, key, fn, m, thr) for m in maps]
        vs = DeviceValidationSweep([0.1, 0.3, 0.5], graphs=graphs, device="cuda")
        gt = (maps[0] > 20000).to(torch.uint8)
        vs.tables(maps[0], gt)
        sweeps = [no_sync(vs.tables, m, gt) for m in maps]
        results[graphs] = [maps, pre, tables, sweeps]
    for a, b in zip(results[True], results[False]):
        for x, y in zip(a, b):
            x, y = (x if isinstance(x, tuple) else (x,)), (y if isinstance(y, tuple) else (y,))
            assert all(torch.equal(u, v) for u, v in zip(x, y))


def test_two_buckets_replayed_in_reverse_order_are_bit_identical(gen, tmp_path, monkeypatch):
    """One ``Inferencer`` serves two volumes of two z buckets (two keys in
    its window runner's pool and in its table runner's), then serves them
    again in the reverse order: every map, candidate table and bbox file is
    bit-identical to the first pass and to an eager ``Inferencer``'s."""
    import json

    from light_unet_tpu_torch.core import inferencer as inferencer_mod
    from light_unet_tpu_torch.utils import nifti

    data = tmp_path / "processed"
    for sub in ("images", "body_masks"):
        (data / sub).mkdir(parents=True)
    cases = {"0001": (24, 24, 40), "0002": (28, 24, 20)}  # padded z 48 and 32
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid, shape in cases.items():
        vol = _phantom(shape)
        vol = vol / vol.max()
        nifti.save(nifti.Nifti1Image(vol.astype(np.float32), aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image((vol > 0.05).astype(np.uint8), aff),
                   data / f"body_masks/{cid}.nii.gz")
    cfg = {"data": {"patch_size": [16, 16, 16]},
           "tpu": {"compute_dtype": "bfloat16", "fused_block": True, "patch_batch": 8,
                   "z_bucket": 16, "transfer_dtype": "uint16", "fetch_dtype": "uint16",
                   "sparse_fetch": True}}
    model = init_weights(build_model(Config.from_dict(cfg).model, torch.bfloat16, inference=True),
                         torch.Generator().manual_seed(6))
    ckpt = tmp_path / "model.pth"
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, ckpt)
    real = inferencer_mod.run_unit

    def serve(inf, name, order):
        tables, pending = {}, list(order)

        def record(*a):
            out = real(*a)
            tables[pending.pop(0)] = [t.clone() for t in out]
            return out

        monkeypatch.setattr(inferencer_mod, "run_unit", record)
        split = tmp_path / f"{name}.txt"
        split.write_text("\n".join(order) + "\n")
        result = inf.infer_split(split, data)
        monkeypatch.setattr(inferencer_mod, "run_unit", real)
        assert result["successful"] == len(order) and not result["failed"]
        out = {}
        for cid in order:
            out[cid] = (nifti.load(inf.prob_maps_dir / f"{cid}_prob.nii.gz").get_fdata(np.float32),
                        json.loads((inf.bboxes_dir / f"{cid}_bboxes.json").read_text()),
                        tables[cid])
        return out

    graphed = inferencer_mod.Inferencer(cfg, ckpt, workdir=str(tmp_path / "g"), device="cuda")
    first = serve(graphed, "forward", ["0001", "0002"])
    again = serve(graphed, "reverse", ["0002", "0001"])
    assert len(graphed.sw.graphs.graphs) == 2 and len(graphed.table_graphs.graphs) == 2
    eager = inferencer_mod.Inferencer(cfg, ckpt, workdir=str(tmp_path / "e"), device="cuda",
                                      graphs=False)
    reference = serve(eager, "eager", ["0001", "0002"])
    for other in (again, reference):
        for cid, shape in cases.items():
            assert first[cid][0].shape == shape and np.ptp(first[cid][0]) > 0
            np.testing.assert_array_equal(other[cid][0], first[cid][0])
            assert other[cid][1] == first[cid][1]
            assert all(torch.equal(a, b) for a, b in zip(other[cid][2], first[cid][2]))
