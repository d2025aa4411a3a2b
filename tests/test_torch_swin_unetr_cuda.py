"""PyTorch port on the card: SwinUNETR (``models/swin_unetr.py``) at its
published widths on 96^3 windows: the forward graphed (``utils/graphs.py``)
against eager at B 2 and B 20 (a volume's one chunk), bfloat16 against the
float32 reference (``cellbench/reference/swin_unetr.py``, TF32 off) with the
reference in fp8 outside the same tolerance, the norm kernel on every
decoder norm, and the attention counters of one forward, eager and
replayed.  Skips without a GPU.  A GPU machine need not have JAX, which
``tests/conftest.py`` imports, so run it there without the conftest:

    python -m pytest --noconftest tests/test_torch_swin_unetr_cuda.py -q
"""

import pytest
import torch

from cellbench.reference import swin_unetr as R
from light_unet_tpu_torch.config import ModelConfig
from light_unet_tpu_torch.models import swin_unetr as S
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.utils.graphs import GraphRunner, run_unit, unit_key

pytestmark = pytest.mark.cuda

PATCH = 96
# bfloat16 against the float32 reference on 2 windows of 96^3: the CPU's
# tolerance at feature size 12 (tests/test_torch_swin_unetr.py), which the
# reference in fp8 e4m3 must exceed
BF16_MAX, BF16_MEAN = 0.05, 0.006
# one forward at 96^3, B 2: stages of 48^3, 24^3, 12^3, 6^3 tokens in windows
# of 7^3 (padded to 49^3, 28^3, 14^3) and 6^3; the odd block of the first
# three stages shifted
TOKENS = 2 * 2 * (49 ** 3 + 28 ** 3 + 14 ** 3 + 6 ** 3)
PAD = 2 * 2 * ((49 ** 3 - 48 ** 3) + (28 ** 3 - 24 ** 3) + (14 ** 3 - 12 ** 3))


@pytest.fixture(scope="module")
def cfg():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    mc = ModelConfig(name="SwinUNETR")
    mc.validate()
    return mc


def seeded_state(model, seed=0):
    """Seeded weights in MONAI's names, made on the card: uniform in
    +-1/sqrt(fan_in) for matrices, bias tables 2 N(0, 1), norm scales
    1 + 0.1 N(0, 1), biases 0.1 N(0, 1)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = t.shape
        if name.endswith("relative_position_index"):
            out[name] = t.clone()
        elif name.endswith("relative_position_bias_table"):
            out[name] = 2.0 * torch.randn(shape, generator=gen, device="cuda")
        elif len(shape) >= 2:
            bound = (shape[0] if "transp_conv" in name else shape[1:].numel()) ** -0.5
            out[name] = torch.rand(shape, generator=gen, device="cuda") * (2 * bound) - bound
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * torch.randn(shape, generator=gen, device="cuda")
        else:
            out[name] = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    return out


@pytest.fixture(scope="module")
def port(cfg):
    model = build_model(cfg, torch.bfloat16, inference=True).cuda().eval()
    model.load_state_dict(seeded_state(model), strict=True)
    return model


def windows(batch, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((batch, PATCH, PATCH, PATCH, 1), generator=gen, device="cuda")


@pytest.mark.parametrize("batch", [2, 20])
@torch.no_grad()
def test_graphed_equals_eager(port, batch):
    x = windows(batch)
    runner = GraphRunner("swin_test", "cuda")
    key = unit_key("swin_forward", port)
    first = run_unit(runner, key, port, x)[0]       # warm-up, eager on the side stream
    replay = run_unit(runner, key, port, x)[0]      # the graph
    eager = port(x)
    torch.cuda.synchronize()
    assert replay.shape == (batch, PATCH, PATCH, PATCH, 1) and replay.dtype == torch.float32
    assert torch.isfinite(replay).all()
    assert torch.equal(replay, eager) and torch.equal(first, eager)
    print(f"B {batch}: peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del runner


@torch.no_grad()
def test_bfloat16_against_the_float32_reference(cfg, port):
    R.no_tf32()
    settings = {k: getattr(cfg, k) for k in ("feature_size", "depths", "num_heads",
                                             "window_size", "mlp_ratio", "output_channels")}
    state = port.state_dict()
    x = windows(2, seed=2)
    got = port(x)[..., 0]
    gaps = {}
    for name, quant in (("float32", R.identity), ("fp8", fp8)):
        ref = R.SwinUNETR(settings, quant).cuda().eval()
        ref.load_state_dict(state, strict=True)
        want = torch.cat([ref(x[i:i + 1].permute(0, 4, 1, 2, 3))[:, 0] for i in range(2)])
        if name == "float32":
            base = want
            gap = (got - want).abs()
        else:
            gap = (want - base).abs()
        gaps[name] = (gap.max().item(), gap.mean().item())
        del ref
    print(f"bf16 vs float32 reference (max, mean): {gaps['float32']}; fp8: {gaps['fp8']}")
    assert gaps["float32"][0] <= BF16_MAX and gaps["float32"][1] <= BF16_MEAN
    assert gaps["fp8"][0] > BF16_MAX and gaps["fp8"][1] > BF16_MEAN


def fp8(t):
    amax = t.detach().abs().max().clamp(min=1e-30)
    scale = torch.finfo(torch.float8_e4m3fn).max / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


@torch.no_grad()
def test_the_norm_kernel_route_agrees(cfg, port, monkeypatch):
    """The model launches the norm kernel once a norm (10 UnetResBlocks: 2
    norms each, 6 shortcuts) and never runs the plain chain on the card; a
    second model of the same weights gives the same map bit for bit."""
    again = build_model(cfg, torch.bfloat16, inference=True).cuda().eval()
    again.load_state_dict(port.state_dict(), strict=True)
    from light_unet_tpu_torch.models import unet3d
    from light_unet_tpu_torch.ops import norm_kernel

    def cpu_only(x, *a, **k):
        raise AssertionError("the plain norm chain ran on a CUDA tensor")

    monkeypatch.setattr(unet3d, "reference_instance_norm_leaky_relu", cpu_only)
    x = windows(2, seed=3)
    launches, outs = [], []
    for model in (again, port):
        before = norm_kernel.launches
        outs.append(model(x))
        launches.append(norm_kernel.launches - before)
    assert launches == [26, 26] and torch.equal(outs[0], outs[1])


@torch.no_grad()
def test_counters_of_one_forward_eager_and_replayed(port):
    x = windows(2, seed=4)
    want = {"forwards": 1, "attn.calls": 8, "attn.shifted_calls": 3, "attn.tokens": TOKENS,
            "attn.pad_tokens": PAD}
    before = dict(S.counts)
    port(x)
    assert {k: S.counts[k] - before[k] for k in S.counts} == want
    runner = GraphRunner("swin_counters", "cuda")
    key = unit_key("swin_forward", port)
    run_unit(runner, key, port, x)  # the warm-up counts; the capture does not
    before = dict(S.counts)
    for _ in range(3):
        run_unit(runner, key, port, x)
    torch.cuda.synchronize()
    assert {k: S.counts[k] - before[k] for k in S.counts} == {k: 3 * v for k, v in want.items()}
    del runner
