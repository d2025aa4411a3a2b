"""PyTorch port: MedNeXt (``models/mednext.py``) against the plain float32
reference of upstream's equations (``cellbench/reference/mednext.py``) on
seeded weights at tiny widths (``n_channels`` 4, one block a stage, kernel 3
and 5) on 32^3 and 32x32x64 inputs: every stage down to 2^3 voxels, the
transposed convs' 2n - 1 and their pads.  Also the 5^3 depthwise wrapper's
plain version and checks, the configuration's checks, upstream's state-dict
names, the operation count, the counters and spans, and the model on the
serving path (``FusedVolumePipeline``, ``Inferencer.infer_split``, the
bench)."""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from cellbench.reference import mednext as R
from cellbench.reference import preprocess as ref_pre
from cellbench.reference.unet import fake_quant
from cellbench.reference.window import window_map
from light_unet_tpu_torch import bench, cli
from light_unet_tpu_torch.config import Config, ConfigError, ModelConfig
from light_unet_tpu_torch.core.checkpoint import save_checkpoint
from light_unet_tpu_torch.core.inferencer import Inferencer
from light_unet_tpu_torch.models import mednext as M
from light_unet_tpu_torch.models.cost import (
    forward_cost,
    mednext_depthwise_cost,
    mednext_forward_terms,
    parameter_count,
)
from light_unet_tpu_torch.models.unet3d import build_model, init_weights
from light_unet_tpu_torch.ops import depthwise_kernel as dk
from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
from light_unet_tpu_torch.ops.sliding_window import (
    bucketed_shape,
    choose_chunks,
    compute_positions,
)
from light_unet_tpu_torch.utils import graphs, nifti, tracing
from tests.synthetic import make_phantom, write_split_files

REPO = Path(__file__).resolve().parents[1]
MEDNEXT_YAML = REPO / "configs/mednext_l_k5_roi128.yaml"
# MedNeXt-L with a 1-channel head: 62,992,866 at kernel 5; at kernel 3
# 61,779,234, the paper's 61.8 M (Roy et al., Table 1)
PUBLISHED_PARAMS = {5: 62_992_866, 3: 61_779_234}
SHAPES = [((32, 32, 32), 2), ((32, 32, 64), 1)]
SHAPE_IDS = ["32^3_b2", "32x32x64_b1"]
KERNELS = [3, 5]
# float32: the same sums in other orders (matmuls against convolutions,
# channels-last against channels-first), which moved the sigmoid output by
# at most 4.5e-7 here
F32_MAX = 1e-5
# bfloat16 (the port rounds each conv's, matmul's and norm's output): max
# 0.0083, mean 0.00086 here; the reference in fp8 e4m3 (the precision below)
# gives max 0.059-0.121, mean 0.0079-0.0135, outside both
BF16_MAX, BF16_MEAN = 0.03, 0.004


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_cfg(**kw) -> ModelConfig:
    mc = ModelConfig(name="MedNeXt", **{"n_channels": 4, "block_counts": [1] * 9, **kw})
    mc.validate()
    return mc


def ref_settings(mc: ModelConfig) -> dict:
    return {k: getattr(mc, k) for k in ("n_channels", "exp_r", "block_counts", "kernel_size",
                                        "output_channels")}


def seeded_state(net, seed: int) -> dict:
    """Seeded weights in upstream's names: convolutions uniform in
    +-1/sqrt(fan_in) (a 1^3 transposed conv's fan-in is its input channels),
    norm scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1), ``dummy_tensor`` 1."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in net.state_dict().items():
        if name == "dummy_tensor":
            out[name] = torch.ones(t.shape)
        elif t.ndim >= 2:
            transposed_1x1 = name.startswith(("up_", "out_0")) and t.shape[2:].numel() == 1
            bound = (t.shape[0] if transposed_1x1 else t[0].numel()) ** -0.5
            out[name] = torch.rand(t.shape, generator=gen) * (2 * bound) - bound
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * torch.randn(t.shape, generator=gen)
        else:
            out[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return out


@pytest.fixture(scope="module", params=KERNELS, ids=["k3", "k5"])
def nets(request):
    """(kernel, reference, its upstream-named state, port float32, port bfloat16)."""
    mc = model_cfg(kernel_size=request.param)
    ref = R.MedNeXt(ref_settings(mc)).eval()
    state = seeded_state(ref, 0)
    ref.load_state_dict(state, strict=True)
    ports = []
    for dt in (torch.float32, torch.bfloat16):
        port = build_model(mc, dt, inference=True).eval()
        port.load_state_dict(state, strict=True)
        ports.append(port)
    return request.param, ref, state, *ports


def volumes(shape, batch):
    return torch.rand((batch, *shape), generator=torch.Generator().manual_seed(1))


@torch.no_grad()
def both(ref, port, x):
    return ref(x[:, None])[:, 0], port(x[..., None])[..., 0]


@pytest.mark.parametrize("shape,batch", SHAPES, ids=SHAPE_IDS)
def test_float32_matches_the_reference(nets, shape, batch):
    _, ref, _, port32, _ = nets
    want, got = both(ref, port32, volumes(shape, batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= F32_MAX


@pytest.mark.parametrize("shape,batch", SHAPES, ids=SHAPE_IDS)
def test_bfloat16_within_its_tolerance_and_fp8_outside(nets, shape, batch):
    k, ref, state, _, port16 = nets
    x = volumes(shape, batch)
    want, got = both(ref, port16, x)
    gap = (got - want).abs()
    assert gap.max().item() <= BF16_MAX and gap.mean().item() <= BF16_MEAN
    low = R.MedNeXt(ref_settings(model_cfg(kernel_size=k)), fake_quant()).eval()
    low.load_state_dict(state)
    with torch.no_grad():
        control = (low(x[:, None])[:, 0] - want).abs()
    assert control.max().item() > BF16_MAX and control.mean().item() > BF16_MEAN


@pytest.mark.parametrize("k", KERNELS)
def test_parameter_count_at_the_published_widths(k):
    mc = ModelConfig(name="MedNeXt", kernel_size=k)
    mc.validate()
    assert mc.n_channels == 32 and mc.exp_r == mc.block_counts == [3, 4, 8, 8, 8, 8, 8, 4, 3]
    assert parameter_count(mc) == PUBLISHED_PARAMS[k]
    assert sum(s.numel() for _, s in R.parameter_shapes(ref_settings(mc))) == PUBLISHED_PARAMS[k]
    assert round(PUBLISHED_PARAMS[3] / 1e6, 1) == 61.8


def test_the_shipped_yaml_serves_a_volume_in_one_chunk():
    cfg = Config.load(MEDNEXT_YAML)
    assert (cfg.model.name, cfg.model.kernel_size, cfg.model.n_channels) == ("MedNeXt", 5, 32)
    assert cfg.data.patch_size == [128, 128, 128] and cfg.tpu.patch_batch == 16
    assert (cfg.tpu.compute_dtype, cfg.tpu.transfer_dtype, cfg.tpu.sparse_fetch,
            cfg.tpu.fused_block) == ("bfloat16", "uint16", True, False)
    shape = (144, 144, 272)
    assert bucketed_shape(shape, (128, 128, 128), cfg.tpu.z_bucket) == (144, 144, 288)
    n = len(compute_positions(shape, (128, 128, 128), 0.5))
    assert n == 16 and choose_chunks(n, cfg.tpu.patch_batch) == (16, 0, 16)
    with torch.device("meta"):
        model = build_model(cfg.model, torch.bfloat16, inference=True)
    assert sum(p.numel() for p in model.parameters()) == PUBLISHED_PARAMS[5]
    assert model.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("change,match", [
    (dict(data={"patch_size": [128, 128, 120]}), "multiples of 16"),
    (dict(tpu={"fused_block": True}), "fused_block"),
    (dict(model={"exp_r": [3, 4, 8, 8, 8, 8, 8, 4]}), "exp_r"),
    (dict(model={"block_counts": [3, 4, 8, 8, 0, 8, 8, 4, 3]}), "block_counts"),
    (dict(model={"kernel_size": 7}), "kernel_size"),
    (dict(model={"n_channels": 0}), "n_channels"),
    (dict(model={"window_size": 7}), "SwinUNETR key"),
])
def test_config_refuses(change, match):
    raw = {"model": {"name": "MedNeXt", **change.get("model", {})},
           "data": {"patch_size": [128, 128, 128], **change.get("data", {})},
           "tpu": change.get("tpu", {})}
    with pytest.raises(ConfigError, match=match):
        Config.from_dict(raw)


def test_config_fills_upstream_values_and_keeps_the_other_dicts():
    cfg = Config.from_dict({"model": {"name": "MedNeXt"}, "data": {"patch_size": [64, 64, 96]}})
    assert cfg.model.kernel_size == 5 and cfg.model.block_counts == [3, 4, 8, 8, 8, 8, 8, 4, 3]
    assert cfg.to_dict()["model"]["n_channels"] == 32
    assert "kernel_size" not in Config().to_dict()["model"]
    swin = Config.from_dict({"model": {"name": "SwinUNETR"}, "data": {"patch_size": [96] * 3}})
    assert "exp_r" not in swin.to_dict()["model"]
    for name in ("Lightweight3DUNet", "SwinUNETR"):
        with pytest.raises(ConfigError, match="MedNeXt key"):
            Config.from_dict({"model": {"name": name, "kernel_size": 5},
                              "data": {"patch_size": [96] * 3}})


def test_build_model_serves_it_and_does_not_train_it():
    with pytest.raises(ValueError, match="inference only"):
        build_model(model_cfg())


def test_upstream_state_dict_loads_strict(nets):
    k, ref, state, port32, _ = nets
    assert set(port32.state_dict()) == set(ref.state_dict())
    for key in ("stem.weight", "enc_block_0.0.conv1.weight", "enc_block_0.0.norm.bias",
                "enc_block_0.0.conv2.weight", "down_0.res_conv.weight", "down_3.conv3.bias",
                "bottleneck.0.conv1.bias", "up_3.conv1.weight", "up_0.res_conv.bias",
                "dec_block_0.0.conv3.weight", "out_0.conv_out.weight", "dummy_tensor"):
        assert key in state and torch.equal(port32.state_dict()[key], state[key]), key
    assert state["up_0.conv1.weight"].shape == (8, 1, k, k, k)  # depthwise, transposed
    assert state["up_0.res_conv.weight"].shape == (8, 4, 1, 1, 1)  # [in, out]: transposed
    fresh = build_model(model_cfg(kernel_size=k), inference=True)
    # a checkpoint trained with deep supervision carries out_1 .. out_4
    trained = dict(state, **{f"out_{i}.conv_out.{p}": torch.zeros(1)
                             for i in range(1, 5) for p in ("weight", "bias")})
    fresh.load_state_dict(trained, strict=True)
    broken = dict(state)
    broken["enc_block_1.0.conv9.weight"] = broken.pop("enc_block_1.0.conv1.weight")
    with pytest.raises(RuntimeError, match="conv9"):
        fresh.load_state_dict(broken, strict=True)


@pytest.mark.parametrize("shape,batch", SHAPES, ids=SHAPE_IDS)
def test_cost_equals_the_flop_counter(nets, shape, batch):
    k, ref, _, port32, _ = nets
    mc = model_cfg(kernel_size=k)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref(torch.zeros(batch, 1, *shape))
    total = forward_cost(mc, batch, shape)[0]
    assert total == counter.get_total_flops()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        port32(torch.zeros(batch, *shape, 1))
    assert counter.get_total_flops() == total


def test_cost_at_the_published_size():
    """Per 128^3 window: the 54 block depthwise convs 155.7 GFLOP, the 1^3
    matmuls 953.4, the resampling convs 8.4, the head 0.13; a volume's 16
    windows 17.88 TFLOP.  The depthwise convs' bytes: input and output
    once, 2.49 GB a window in bf16, plus their float32 weights and biases."""
    mc = model_cfg(n_channels=32, block_counts=[3, 4, 8, 8, 8, 8, 8, 4, 3])
    rows = mednext_forward_terms(mc, 1, 128)
    kinds = {k: sum(r["flops"] for r in rows if r["kind"] == k)
             for k in ("depthwise", "pointwise", "resample", "head")}
    assert {k: round(v / 1e9, 1) for k, v in kinds.items()} == {
        "depthwise": 155.7, "pointwise": 953.4, "resample": 8.4, "head": 0.1}
    assert sum(1 for r in rows if r["kind"] == "depthwise") == 54
    assert forward_cost(mc, 16, 128)[0] == 17_881_266_323_456
    flops, nbytes = mednext_depthwise_cost(mc, 16, 128)
    params = 4 * 126 * sum(c * n for c, n in zip([32, 64, 128, 256, 512, 256, 128, 64, 32],
                                                 [3, 4, 8, 8, 8, 8, 8, 4, 3]))
    assert flops == 16 * 155_713_536_000 and nbytes == 16 * 2_491_416_576 + params


def test_counters_for_one_forward(nets):
    """One block a stage: 9 blocks, 8 resampling convs; at kernel 5 every
    block conv goes to the 5^3 wrapper (its plain version on the CPU)."""
    k, _, _, port32, _ = nets
    before, plain = dict(M.counts), dk.counts5["plain_calls"]
    with torch.no_grad():
        port32(torch.zeros(2, 32, 32, 32, 1))
    got = {key: M.counts[key] - before[key] for key in M.counts}
    dw5 = 9 if k == 5 else 0
    assert got == {"forwards": 1, "blocks": 9, "dw5_calls": dw5, "resample_convs": 8}
    assert dk.counts5["plain_calls"] - plain == dw5
    snap = tracing.snapshot()
    assert all(snap[f"mednext.{key}"] == v for key, v in M.counts.items())
    assert snap["depthwise_kernel.k5.plain_calls"] == dk.counts5["plain_calls"]


def test_graph_replays_advance_the_counters(monkeypatch):
    """The counters are registered (``mednext.*``, ``depthwise_kernel.k5.*``),
    so a replay adds what its capture recorded, after the launch counters."""
    monkeypatch.setattr(tracing, "_registered", dict(tracing._registered))
    assert tracing.registered_counts()["mednext"] is M.counts
    assert tracing.registered_counts()["depthwise_kernel.k5"] is dk.counts5
    before = graphs._counters()
    M.counts["dw5_calls"] += 54
    dk.counts5["launches"] += 54
    delta = tuple(x - y for x, y in zip(graphs._counters(), before))
    n_launch = len(graphs.LAUNCH_COUNTERS)
    assert delta[:n_launch] == (0,) * n_launch and sorted(delta)[-2:] == [54, 54]
    calls, launches = M.counts["dw5_calls"], dk.counts5["launches"]
    graphs._add_launches(delta)
    assert (M.counts["dw5_calls"], dk.counts5["launches"]) == (calls + 54, launches + 54)


def test_spans_of_a_forward(nets):
    _, _, _, port32, _ = nets
    tracing.take()
    tracing.enable(True)
    try:
        with torch.no_grad():
            port32(torch.zeros(1, 32, 32, 32, 1))
    finally:
        tracing.enable(False)
    names = {s["name"] for s in tracing.take()}
    want = {"mednext.stem", "mednext.bottleneck", "mednext.out"} | {
        f"mednext.{part}{i}" for i in range(4) for part in ("enc", "down", "up", "dec")}
    assert names == want


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_k5_plain_version_is_f_conv3d(bias, dtype):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 7, 9, 11, 8, generator=gen).to(dtype)
    w = torch.randn(8, 1, 5, 5, 5, generator=gen)
    b = torch.randn(8, generator=gen) if bias else None
    got = dk.depthwise_conv3d_k5(x, w, b)  # a CPU tensor: the plain version
    # F.conv3d in float32 of the operands rounded to the dtype, rounded once
    b32 = None if b is None else b.to(dtype).float()
    want = F.conv3d(x.float().permute(0, 4, 1, 2, 3), w.to(dtype).float(), b32, padding=2,
                    groups=8).permute(0, 2, 3, 4, 1).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    direct = F.conv3d(x.permute(0, 4, 1, 2, 3), w.to(dtype), None if b is None else b.to(dtype),
                      padding=2, groups=8).permute(0, 2, 3, 4, 1)
    assert dk.gap_ulps(got, direct, x, w, b) <= 1.0


def test_order_bound_counts_the_taps():
    """26 roundings at 3^3 (the U-Net's kernel, unchanged), 124 at 5^3 and
    125 with a bias."""
    x = torch.ones(1, 5, 5, 5, 8)
    w3, w5, b = torch.ones(8, 1, 3, 3, 3), torch.ones(8, 1, 5, 5, 5), torch.ones(8)
    unit = 2.0 ** -24
    assert dk.order_bound(x, w3)[0, 2, 2, 2, 0].item() == pytest.approx(27 * 2 * 26 * unit)
    assert dk.order_bound(x, w5)[0, 2, 2, 2, 0].item() == pytest.approx(125 * 2 * 124 * unit)
    assert dk.order_bound(x, w5, b)[0, 2, 2, 2, 0].item() == pytest.approx(126 * 2 * 125 * unit)


@pytest.mark.parametrize("x,w,b,match", [
    ((2, 4, 4, 4, 12), (12, 1, 5, 5, 5), (12,), "multiple of 8"),
    ((2, 4, 4, 4, 16), (16, 1, 3, 3, 3), (16,), r"\[16, 1, 5, 5, 5\]"),
    ((2, 4, 4, 4, 16), (16, 1, 5, 5, 5), (8,), r"\[16\] bias"),
])
def test_k5_kernel_checks_its_arguments(x, w, b, match):
    with pytest.raises(ValueError, match=match):
        dk.check_args_k5(torch.empty(x, device="meta", dtype=torch.bfloat16),
                         torch.empty(w, device="meta"), torch.empty(b, device="meta"))
    strided = torch.empty((2, 4, 4, 16, 4), device="meta").permute(0, 1, 2, 4, 3)
    with pytest.raises(ValueError, match="contiguous"):
        dk.check_args_k5(strided, torch.empty((16, 1, 5, 5, 5), device="meta"), None)


def test_block_conv_takes_the_wrapper_only_in_inference():
    """Eval mode without autograd: the 5^3 wrapper; training mode or a
    forward that gradients flow through: ``F.conv3d`` (same result)."""
    conv = M.BlockConv(8, 5).eval()
    x = torch.randn(1, 6, 6, 6, 8, generator=torch.Generator().manual_seed(2))
    n = dk.counts5["plain_calls"]
    with torch.no_grad():
        got = conv(x)
    assert dk.counts5["plain_calls"] == n + 1
    want = conv(x)  # autograd records through the weight
    assert dk.counts5["plain_calls"] == n + 1 and want.requires_grad
    assert torch.allclose(got, want.detach(), atol=1e-6)


def serving_config(**tpu) -> Config:
    return Config.from_dict({
        "model": {"name": "MedNeXt", "n_channels": 4, "block_counts": [1] * 9},
        "data": {"patch_size": [32, 32, 32],
                 "body_mask": {"apply_to_inference": False}},
        "tpu": {"compute_dtype": "float32", "transfer_dtype": "float32",
                "fetch_dtype": "float32", "sparse_fetch": False, "z_bucket": 16,
                "patch_batch": 4, **tpu}})


SERVED_SHAPE = (40, 36, 48)  # 8 windows of 32^3: two chunks of 4


@pytest.fixture(scope="module")
def raw_volume():
    image, _ = make_phantom(np.random.default_rng(7), shape=SERVED_SHAPE, n_lesions=2)
    return image


@pytest.fixture(scope="module")
def served():
    """(reference, state, port float32) at the serving config's widths."""
    mc = serving_config().model
    ref = R.MedNeXt(ref_settings(mc)).eval()
    state = seeded_state(ref, 3)
    ref.load_state_dict(state)
    port = build_model(mc, torch.float32, inference=True).eval()
    port.load_state_dict(state, strict=True)
    return ref, state, port


def test_fused_pipeline_matches_the_reference_window_map(served, raw_volume):
    ref, _, port = served
    cfg = serving_config()
    got = FusedVolumePipeline(port, cfg, patch_batch=cfg.tpu.patch_batch, device="cpu")(
        raw_volume)
    lo, hi = ref_pre.clip_values(raw_volume)
    want = window_map(ref, ref_pre.normalize(raw_volume, lo, hi), (32, 32, 32), "cpu", batch=4)
    assert got.shape == SERVED_SHAPE and np.abs(got - want).max() <= F32_MAX


def test_infer_split_matches_the_reference_window_map(served, raw_volume, tmp_path):
    ref, state, _ = served
    data = tmp_path / "processed"
    (data / "images").mkdir(parents=True)
    image = np.clip(raw_volume / 9.0, 0.0, 1.0).astype(np.float32)
    nifti.save(nifti.Nifti1Image(image, np.diag([4.0, 4.0, 4.0, 1.0])),
               data / "images/0001_0000.nii.gz")
    write_split_files(tmp_path / "splits", ["0001"], ["0001"])
    ckpt = tmp_path / "best_model.pth"
    save_checkpoint(ckpt, state, {}, {"best_epoch": 1})
    inf = Inferencer(serving_config(), ckpt, workdir=str(tmp_path / "work"), device="cpu")
    result = inf.infer_split(tmp_path / "splits/val_list.txt", data)
    assert result["successful"] == 1 and not result["failed"]
    got = nifti.load(tmp_path / "work/inference/prob_maps/0001_prob.nii.gz").get_fdata()
    want = window_map(ref, image, (32, 32, 32), "cpu", batch=4)
    assert np.abs(got - want).max() <= F32_MAX


def test_bench_runs_the_mednext_config(tmp_path, monkeypatch):
    """``bench_gpu`` serves the model of the config it is given, and the
    CLI's ``--mode bench`` hands it ``--config``'s."""
    ids = bench.raw_volumes(tmp_path, 2, SERVED_SHAPE)
    out = bench.bench_gpu(tmp_path, ids, device="cpu", reps=1, max_reps=1,
                          config=serving_config())
    assert out["n_volumes"] == 2 and out["volumes_per_sec"] > 0
    seen = {}
    monkeypatch.setattr(bench, "run_bench", lambda device, config=None: seen.update(
        device=device, config=config))
    monkeypatch.chdir(tmp_path)
    assert cli.run(["--mode", "bench", "--device", "cpu", "--config", str(MEDNEXT_YAML)]) == 0
    assert seen["config"].model.name == "MedNeXt"


def test_seeded_init_gives_finite_maps():
    """``init_weights`` (the bench's seeded model) draws every MedNeXt
    parameter."""
    model = init_weights(build_model(model_cfg(), inference=True), torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = model.eval()(torch.rand(1, 32, 32, 32, 1))
    assert torch.isfinite(y).all() and 0 < y.min() and y.max() < 1
