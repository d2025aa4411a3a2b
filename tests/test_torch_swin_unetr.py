"""PyTorch port: SwinUNETR (``models/swin_unetr.py``) against the plain
float32 reference of MONAI's equations (``cellbench/reference/swin_unetr.py``)
on seeded weights at feature size 12, on 32^3 and 32x32x64 inputs: a padded
shifted window (16^3 tokens in 21^3), a window equal to its stage (4^3, the
``index[:n, :n]`` case) or smaller on one axis only (4x4x7 over 4x4x8), and
2^3 stages.  Also its parts (the region mask, the relative index, the merge
order, window partition), the configuration's checks, MONAI's state-dict
names, the operation count, the counters and spans, and the model on the
serving path (``FusedVolumePipeline``, ``Inferencer.infer_split``, the
bench).  The repairs of the shared modules keep the lightweight U-Net's
parameters and graph keys."""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from cellbench.reference import preprocess as ref_pre
from cellbench.reference import swin_unetr as R
from cellbench.reference.window import window_map
from light_unet_tpu_torch import bench, cli
from light_unet_tpu_torch.config import Config, ConfigError, ModelConfig
from light_unet_tpu_torch.core.checkpoint import save_checkpoint
from light_unet_tpu_torch.core.inferencer import Inferencer
from light_unet_tpu_torch.models import swin_unetr as S
from light_unet_tpu_torch.models.cost import forward_cost, parameter_count, swin_forward_terms
from light_unet_tpu_torch.models.unet3d import (
    ConvTranspose3d,
    InstanceNorm,
    build_model,
    init_weights,
)
from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
from light_unet_tpu_torch.ops.sliding_window import (
    bucketed_shape,
    choose_chunks,
    compute_positions,
)
from light_unet_tpu_torch.utils import graphs, nifti, tracing
from light_unet_tpu_torch.utils.graphs import unit_key
from tests.synthetic import make_phantom, write_split_files

REPO = Path(__file__).resolve().parents[1]
SWIN_YAML = REPO / "configs/swinunetr_fs48_roi96.yaml"
PUBLISHED_PARAMS = 62_186_659  # MONAI's 62,187,296 with BTCV's 14-class head, less 13 x 49
SHAPES = [((32, 32, 32), 2), ((32, 32, 64), 1)]
SHAPE_IDS = ["32^3_b2", "32x32x64_b1"]
# float32: both compute the same sums in other orders (a fused softmax against
# the materialised one, channels-last against channels-first convolutions),
# which moved the sigmoid output by at most 1.2e-6 here
F32_MAX = 1e-5
# bfloat16 (the port rounds each matmul's, convolution's and norm's output):
# max 0.010, mean 0.0013 here; the reference in fp8 e4m3 (the precision
# below) gives max 0.12-0.13, mean 0.018, outside both
BF16_MAX, BF16_MEAN = 0.05, 0.006


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def model_cfg(**kw) -> ModelConfig:
    mc = ModelConfig(name="SwinUNETR", **{"feature_size": 12, **kw})
    mc.validate()
    return mc


def ref_settings(mc: ModelConfig) -> dict:
    return {k: getattr(mc, k) for k in ("feature_size", "depths", "num_heads", "window_size",
                                        "mlp_ratio", "output_channels")}


def seeded_state(net: nn.Module, seed: int) -> dict:
    """Seeded weights in MONAI's names: convolutions and linears uniform in
    +-1/sqrt(fan_in), bias tables 2 N(0, 1), norm scales 1 + 0.1 N(0, 1),
    biases 0.1 N(0, 1); the index buffers as built."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in net.state_dict().items():
        if name.endswith("relative_position_index"):
            out[name] = t.clone()
        elif name.endswith("relative_position_bias_table"):
            out[name] = 2.0 * torch.randn(t.shape, generator=gen)
        elif t.ndim >= 2:
            bound = (t.shape[0] if "transp_conv" in name else t[0].numel()) ** -0.5
            out[name] = torch.rand(t.shape, generator=gen) * (2 * bound) - bound
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * torch.randn(t.shape, generator=gen)
        else:
            out[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return out


def fp8(t):
    amax = t.detach().abs().max().clamp(min=1e-30)
    scale = torch.finfo(torch.float8_e4m3fn).max / amax
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


@pytest.fixture(scope="module")
def nets():
    """(reference, its MONAI-named state, port float32, port bfloat16)."""
    mc = model_cfg()
    ref = R.SwinUNETR(ref_settings(mc)).eval()
    state = seeded_state(ref, 0)
    ref.load_state_dict(state, strict=True)
    ports = []
    for dt in (torch.float32, torch.bfloat16):
        port = build_model(mc, dt, inference=True).eval()
        port.load_state_dict(state, strict=True)
        ports.append(port)
    return ref, state, *ports


def volumes(shape, batch):
    return torch.rand((batch, *shape), generator=torch.Generator().manual_seed(1))


@torch.no_grad()
def both(ref, port, x):
    return ref(x[:, None])[:, 0], port(x[..., None])[..., 0]


@pytest.mark.parametrize("shape,batch", SHAPES, ids=SHAPE_IDS)
def test_float32_matches_the_reference(nets, shape, batch):
    ref, _, port32, _ = nets
    want, got = both(ref, port32, volumes(shape, batch))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max().item() <= F32_MAX


@pytest.mark.parametrize("shape,batch", SHAPES, ids=SHAPE_IDS)
def test_bfloat16_within_its_tolerance_and_fp8_outside(nets, shape, batch):
    ref, state, _, port16 = nets
    x = volumes(shape, batch)
    want, got = both(ref, port16, x)
    gap = (got - want).abs()
    assert gap.max().item() <= BF16_MAX and gap.mean().item() <= BF16_MEAN
    low = R.SwinUNETR(ref_settings(model_cfg()), fp8).eval()
    low.load_state_dict(state)
    with torch.no_grad():
        control = (low(x[:, None])[:, 0] - want).abs()
    assert control.max().item() > BF16_MAX and control.mean().item() > BF16_MEAN


def test_parameter_count_at_the_published_widths():
    assert parameter_count(model_cfg(feature_size=48)) == PUBLISHED_PARAMS
    cfg = Config.load(SWIN_YAML)
    with torch.device("meta"):
        model = build_model(cfg.model, torch.bfloat16, inference=True)
    assert sum(p.numel() for p in model.parameters()) == PUBLISHED_PARAMS
    assert model.compute_dtype == torch.bfloat16


def test_the_shipped_yaml_serves_a_volume_in_one_chunk():
    cfg = Config.load(SWIN_YAML)
    assert cfg.data.patch_size == [96, 96, 96] and cfg.tpu.patch_batch == 20
    assert (cfg.tpu.compute_dtype, cfg.tpu.transfer_dtype, cfg.tpu.sparse_fetch,
            cfg.tpu.fused_block) == ("bfloat16", "uint16", True, False)
    shape = (144, 144, 272)
    assert bucketed_shape(shape, (96, 96, 96), cfg.tpu.z_bucket) == (144, 144, 288)
    n = len(compute_positions(shape, (96, 96, 96), 0.5))
    assert n == 20 and choose_chunks(n, cfg.tpu.patch_batch) == (20, 0, 20)


@pytest.mark.parametrize("dims,ws,ss", [((21, 21, 21), (7, 7, 7), (3, 3, 3)),
                                        ((14, 14, 14), (7, 7, 7), (3, 3, 3)),
                                        ((4, 4, 14), (4, 4, 7), (0, 0, 3)),
                                        ((2, 4, 6), (2, 2, 3), (1, 1, 1))])
def test_shift_mask_is_monais(dims, ws, ss):
    assert torch.equal(S.shift_mask(dims, ws, ss), R.compute_mask(list(dims), ws, ss, "cpu"))


def test_shift_mask_golden():
    """Axis 2 of 4 voxels in windows of 2, shifted by 1: regions [0, 2), [2],
    [3]; axes of one voxel with shift 0 are one region (MONAI's last slice
    of such an axis is the whole axis)."""
    mask = S.shift_mask((1, 1, 4), (1, 1, 2), (0, 0, 1))
    assert torch.equal(mask, torch.tensor([[[0.0, 0.0], [0.0, 0.0]],
                                           [[0.0, -100.0], [-100.0, 0.0]]]))


def test_relative_position_index_golden():
    idx = S.relative_position_index(7)
    assert torch.equal(idx, R.relative_position_index((7, 7, 7)))
    assert idx.shape == (343, 343) and idx.unique().numel() == 13 ** 3
    # the same token: the table's centre; the first against the last: (-6, -6, -6)
    assert idx[0, 0] == 6 * 169 + 6 * 13 + 6 and idx[0, 342] == 0 and idx[342, 0] == 2196
    assert idx[1, 0] == 6 * 169 + 6 * 13 + 7  # one step along the last axis
    assert torch.equal(S.relative_position_index(2), R.relative_position_index((2, 2, 2)))


def test_window_and_shift_is_get_window_size():
    for dims in ((48, 48, 48), (6, 6, 6), (4, 4, 8), (16, 7, 8)):
        assert S.window_and_shift(dims, 7, 3) == R.get_window_size(dims, (7, 7, 7), (3, 3, 3))
    assert S.window_and_shift((6, 6, 6), 7, 3) == ((6, 6, 6), (0, 0, 0))


def test_window_partition_and_reverse():
    x = torch.arange(2 * 4 * 6 * 9 * 3, dtype=torch.float32).view(2, 4, 6, 9, 3)
    ws = (2, 3, 3)
    win = S.window_partition(x, ws)
    assert win.shape == (2, 2 * 2 * 3, 18, 3)
    assert torch.equal(win.reshape(-1, 18, 3), R.window_partition(x, ws))
    assert torch.equal(win[0, 1, :, 0], x[0, 0:2, 0:3, 3:6, 0].reshape(-1))
    assert torch.equal(S.window_reverse(win, ws, (4, 6, 9)), x)


def test_merge_order_is_monais():
    assert S.MERGE_ORDER == ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0),
                             (0, 0, 1), (1, 1, 1))
    x = torch.randn(2, 5, 4, 7, 3, generator=torch.Generator().manual_seed(3))  # odd dims pad
    port, ref = S.PatchMerging(3), R.PatchMerging(3)
    for m in (port, ref):
        m.norm, m.reduction = nn.Identity(), nn.Identity()
    got = port(x)
    assert got.shape == (2, 3, 2, 4, 24) and torch.equal(got, ref(x))
    assert torch.equal(got[..., 15:18], got[..., 6:9])  # the 6th slice repeats the 3rd


@pytest.mark.parametrize("change,match", [
    (dict(data={"patch_size": [96, 96, 80]}), "multiples of 32"),
    (dict(tpu={"fused_block": True}), "fused_block"),
    (dict(model={"num_heads": [3, 5, 12, 24]}), "num_heads"),
    (dict(model={"feature_size": 40}), "multiple of 12"),
    (dict(model={"depths": [2, 2, 2]}), "depths"),
    (dict(model={"window_size": 0}), "window_size"),
    (dict(model={"mlp_ratio": 0}), "mlp_ratio"),
])
def test_config_refuses(change, match):
    raw = {"model": {"name": "SwinUNETR", **change.get("model", {})},
           "data": {"patch_size": [96, 96, 96], **change.get("data", {})},
           "tpu": change.get("tpu", {})}
    with pytest.raises(ConfigError, match=match):
        Config.from_dict(raw)


def test_config_fills_monais_values_and_keeps_the_lightweight_dict():
    cfg = Config.from_dict({"model": {"name": "SwinUNETR"}, "data": {"patch_size": [64, 64, 96]}})
    assert cfg.model.feature_size == 48 and cfg.model.num_heads == [3, 6, 12, 24]
    assert cfg.to_dict()["model"]["window_size"] == 7
    assert "feature_size" not in Config().to_dict()["model"]
    with pytest.raises(ConfigError, match="SwinUNETR key"):
        Config.from_dict({"model": {"window_size": 7}})


def test_build_model_serves_it_and_does_not_train_it():
    with pytest.raises(ValueError, match="inference only"):
        build_model(model_cfg())


def test_monai_state_dict_loads_strict(nets):
    ref, state, port32, _ = nets
    assert set(port32.state_dict()) == set(ref.state_dict())
    for key in ("swinViT.layers1.0.blocks.0.attn.qkv.weight",
                "swinViT.layers1.0.blocks.1.attn.relative_position_index",
                "swinViT.layers4.0.downsample.reduction.weight",
                "encoder1.layer.conv1.conv.weight", "encoder1.layer.conv3.conv.weight",
                "encoder10.layer.conv2.conv.weight", "decoder5.transp_conv.conv.weight",
                "decoder1.conv_block.conv3.conv.weight", "out.conv.conv.bias"):
        assert key in state and torch.equal(port32.state_dict()[key], state[key]), key
    fresh = build_model(model_cfg(), inference=True)
    fresh.load_state_dict(state, strict=True)
    broken = dict(state)
    broken["encoder2.layer.conv9.conv.weight"] = broken.pop("encoder2.layer.conv1.conv.weight")
    with pytest.raises(RuntimeError, match="conv9"):
        fresh.load_state_dict(broken, strict=True)


@pytest.mark.parametrize("shape,batch", SHAPES, ids=SHAPE_IDS)
def test_cost_equals_the_flop_counter(nets, shape, batch):
    ref, _, port32, _ = nets
    mc = model_cfg()
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref(torch.zeros(batch, 1, *shape))
    total = forward_cost(mc, batch, shape)[0]
    assert total == counter.get_total_flops()
    attention = sum(r["flops"] for r in swin_forward_terms(mc, batch, shape)
                    if r["kind"] == "attention")
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        port32(torch.zeros(batch, *shape, 1))
    # the CPU's fused attention has no formula in the counter
    assert counter.get_total_flops() in (total, total - attention)


def test_cost_at_the_published_size():
    """Per 96^3 window: convolutions 586.2 GFLOP, attention 22.9, the qkv,
    proj and merge linears 11.6, the MLPs 15.3 (over the unpadded tokens)."""
    rows = swin_forward_terms(model_cfg(feature_size=48), 1, 96)
    kinds = {k: sum(r["flops"] for r in rows if r["kind"] == k)
             for k in ("conv", "attention", "linear", "mlp")}
    assert {k: round(v / 1e9, 1) for k, v in kinds.items()} == {
        "conv": 586.2, "attention": 22.9, "linear": 11.6, "mlp": 15.3}


def test_counters_for_one_forward(nets):
    """32^3 at B 2: stages of 16^3, 8^3, 4^3 and 2^3 tokens; the first two
    padded to 21^3 and 14^3 and shifted in their odd block."""
    _, _, port32, _ = nets
    before = dict(S.counts)
    with torch.no_grad():
        port32(torch.zeros(2, 32, 32, 32, 1))
    got = {k: S.counts[k] - before[k] for k in S.counts}
    tokens = 2 * 2 * (21 ** 3 + 14 ** 3 + 4 ** 3 + 2 ** 3)
    pad = 2 * 2 * ((21 ** 3 - 16 ** 3) + (14 ** 3 - 8 ** 3))
    assert got == {"forwards": 1, "attn.calls": 8, "attn.shifted_calls": 2,
                   "attn.tokens": tokens, "attn.pad_tokens": pad}
    snap = tracing.snapshot()
    assert all(snap[f"swin.{k}"] == v for k, v in S.counts.items())


def test_registered_counts_are_reported_and_replays_advance_them(monkeypatch):
    """A module's counter dict, registered with ``tracing.register_counts``,
    shows in ``snapshot()`` under its prefix and is advanced by what a
    capture recorded, after the kernels' launch counters; a dict registered
    after the capture is left alone.  SwinUNETR's is registered at import."""
    monkeypatch.setattr(tracing, "_registered", dict(tracing._registered))
    assert tracing.registered_counts()["swin"] is S.counts
    mine = tracing.register_counts("test_counts", {"a": 1, "b": 2})
    assert tracing.snapshot()["test_counts.b"] == 2
    before = graphs._counters()
    mine["a"] += 3
    S.counts["attn.calls"] += 5
    delta = tuple(x - y for x, y in zip(graphs._counters(), before))
    n_launch = len(graphs.LAUNCH_COUNTERS)
    assert delta[:n_launch] == (0,) * n_launch and delta[-2:] == (3, 0)
    late = tracing.register_counts("test_late", {"c": 0})
    calls = S.counts["attn.calls"]
    graphs._add_launches(delta)
    assert (mine["a"], mine["b"], late["c"]) == (7, 2, 0)
    assert S.counts["attn.calls"] == calls + 5


def test_spans_of_a_forward(nets):
    _, _, port32, _ = nets
    tracing.take()
    tracing.enable(True)
    try:
        with torch.no_grad():
            port32(torch.zeros(1, 32, 32, 32, 1))
    finally:
        tracing.enable(False)
    names = {s["name"] for s in tracing.take()}
    want = {"swin.embed", "swin.decoder"} | {
        f"swin.stage{i}{part}" for i in range(1, 5) for part in ("", ".attn", ".mlp", ".merge")}
    assert names == want


def test_shared_modules_keep_the_lightweight_model():
    """The norm and transposed-conv repairs leave the U-Net's parameters,
    names and graph keys as they were; a non-affine norm has no parameters
    and computes ``F.instance_norm``."""
    mc = ModelConfig()
    model = build_model(mc, torch.bfloat16, inference=True)
    state = model.state_dict()
    assert sum(p.numel() for p in model.parameters()) == 217_228 and len(state) == 93
    assert "init_conv.norm1.weight" in state and "up1.up.bias" in state
    again = build_model(mc, torch.bfloat16, inference=True)
    again.load_state_dict(state, strict=True)
    key = unit_key("fused", model, chunk=192)
    assert key == ("fused", torch.bfloat16, torch.backends.cudnn.allow_tf32, id(model),
                   ("chunk", 192))
    x = torch.randn(2, 5, 6, 7, 4, generator=torch.Generator().manual_seed(4))
    want = F.instance_norm(x.permute(0, 4, 1, 2, 3), eps=1e-5).permute(0, 2, 3, 4, 1)
    norm = InstanceNorm(4, affine=False).eval()
    assert not list(norm.parameters())
    assert torch.allclose(norm(x), want, atol=1e-5)
    up = ConvTranspose3d(4, 3, 2, stride=2, bias=False)
    assert up.bias is None and up(x).shape == (2, 10, 12, 14, 3)


def serving_config(**tpu) -> Config:
    return Config.from_dict({
        "model": {"name": "SwinUNETR", "feature_size": 12},
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


def test_fused_pipeline_matches_the_reference_window_map(nets, raw_volume):
    ref, _, port32, _ = nets
    cfg = serving_config()
    got = FusedVolumePipeline(port32, cfg, patch_batch=cfg.tpu.patch_batch, device="cpu")(
        raw_volume)
    lo, hi = ref_pre.clip_values(raw_volume)
    want = window_map(ref, ref_pre.normalize(raw_volume, lo, hi), (32, 32, 32), "cpu", batch=4)
    assert got.shape == SERVED_SHAPE and np.abs(got - want).max() <= F32_MAX


def test_infer_split_matches_the_reference_window_map(nets, raw_volume, tmp_path):
    ref, state, _, _ = nets
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


def test_bench_runs_the_swin_config(tmp_path, monkeypatch):
    """``bench_gpu`` serves the model of the config it is given, and the
    CLI's ``--mode bench`` hands it ``--config``'s."""
    ids = bench.raw_volumes(tmp_path, 2, SERVED_SHAPE)
    cfg = serving_config()
    out = bench.bench_gpu(tmp_path, ids, device="cpu", reps=1, max_reps=1, config=cfg)
    assert out["n_volumes"] == 2 and out["volumes_per_sec"] > 0
    seen = {}
    monkeypatch.setattr(bench, "run_bench", lambda device, config=None: seen.update(
        device=device, config=config))
    monkeypatch.chdir(tmp_path)
    assert cli.run(["--mode", "bench", "--device", "cpu", "--config", str(SWIN_YAML)]) == 0
    assert seen["config"].model.name == "SwinUNETR"
    assert cli.run(["--mode", "bench", "--device", "cpu"]) == 0 and seen["config"] is None


@pytest.mark.parametrize("model", ["SwinUNETR", "Lightweight3DUNet", None])
def test_bench_has_a_baseline_only_for_its_model(model, monkeypatch):
    """The CPU baseline times the lightweight U-Net: ``run_bench`` given a
    config of another model prints null for ``vs_baseline`` and the
    baseline's detail, and does not run it."""
    monkeypatch.setattr(bench, "N_VOLUMES", 1)
    monkeypatch.setattr(bench, "VOLUME_SHAPE", (8, 8, 8))
    rate = {"volumes_per_sec": 2.0, "volumes_per_sec_min": 1.5, "volumes_per_sec_max": 2.5}
    monkeypatch.setattr(bench, "bench_gpu", lambda *a, **k: dict(rate))
    ran = []
    monkeypatch.setattr(bench, "bench_torch_cpu_baseline", lambda *a: ran.append(1) or {
        "volumes_per_sec": 0.5})
    config = None if model is None else (
        serving_config() if model == "SwinUNETR" else Config())
    line = bench.run_bench(device="cpu", config=config)
    if model == "SwinUNETR":
        assert line["vs_baseline"] is None and not ran
        assert line["detail"]["torch_cpu_serial_baseline"] is None
    else:
        assert line["vs_baseline"] == 4.0 and ran
        assert line["detail"]["torch_cpu_serial_baseline"] == {"volumes_per_sec": 0.5}


def test_seeded_init_gives_finite_maps():
    """``init_weights`` (the bench's seeded model) draws every SwinUNETR
    parameter."""
    model = init_weights(build_model(model_cfg(), inference=True), torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = model.eval()(torch.rand(1, 32, 32, 32, 1))
    assert torch.isfinite(y).all() and 0 < y.min() and y.max() < 1
