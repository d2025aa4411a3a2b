"""The MedNeXt cell (``mednext.serve_raw``) at a size the CPU runs in seconds
(``n_channels`` 4, one block a stage, 32^3 windows, float32, small volumes):
its weights carry upstream's names and load into the program and the
reference; it runs from its files and is correct, its reference map is the
reference net's windowed map; a fault in the block depthwise conv and the
fp8 control come out not correct against the cell's own limits; the frozen
count equals ``FlopCounterMode`` over the reference and the program's
count; the cell reports the serving cells' per-layer metrics beside its own
two, whose readers read the 5^3 kernels by name and nothing where none
ran."""

import copy
import json
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cellbench import common, control_mednext, cost_mednext, harness, mednext, run
from cellbench.reference.mednext import MedNeXt
from cellbench.reference.window import window_map
from tiny import ROOT

CELL = "mednext.serve_raw"
CONFIG = "mednext_l_k5_roi128"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny():
    config = copy.deepcopy(harness.load_json("configs", CONFIG))
    c = config["config"]
    c["model"].update(n_channels=4, block_counts=[1] * 9)
    c["data"]["patch_size"] = [32, 32, 32]
    c["tpu"].update(compute_dtype="float32", patch_batch=4, z_bucket=16)
    workload = copy.deepcopy(harness.load_json("workloads", CELL))
    workload["params"].update(shape=[40, 36, 48], pool=2)
    return config, workload


def run_tiny(seed=2**31 + 25):
    torch.set_num_threads(2)
    config, workload = tiny()
    specs = run.metric_specs(BENCH, CELL, False)
    return run.run_cell(CELL, workload, config, seed, 1.0, False, torch.device("cpu"), specs,
                        time.perf_counter())


def test_weights_carry_upstreams_names():
    from light_unet_tpu_torch.config import ModelConfig
    from light_unet_tpu_torch.models.unet3d import build_model

    model = tiny()[0]["config"]["model"]
    state = mednext.seeded_state(model, mednext.WEIGHTS_SEED, "cpu")
    assert set(state) == set(MedNeXt(model).state_dict())
    assert {"stem.weight", "enc_block_0.0.conv1.bias", "down_0.res_conv.weight",
            "up_0.conv1.weight", "out_0.conv_out.weight", "dummy_tensor"} <= set(state)
    assert torch.equal(state["dummy_tensor"], torch.ones(1))
    assert state["out_0.conv_out.weight"].abs().max() <= 4 ** -0.5  # fan-in: its 4 inputs
    mc = ModelConfig(**{k: v for k, v in model.items() if k in ModelConfig.__dataclass_fields__})
    mc.validate()
    build_model(mc, inference=True).load_state_dict(state, strict=True)
    again = mednext.seeded_state(model, mednext.WEIGHTS_SEED, "cpu")
    assert all(torch.equal(state[k], again[k]) for k in state)


def test_the_reference_map_is_the_nets_window_map():
    config, _ = tiny()
    settings = config["config"]
    state = mednext.seeded_state(settings["model"], mednext.WEIGHTS_SEED, "cpu")
    net = mednext.reference_net(settings, state, "cpu")
    volume = np.random.default_rng(3).random((40, 36, 48)).astype(np.float32)
    mask = (volume > 0.2).astype(np.float32)
    got = mednext.reference_map(net, settings, volume, "cpu", mask)
    want = window_map(net, volume, (32, 32, 32), "cpu", batch=4) * mask
    assert got.shape == volume.shape and np.abs(got - want).max() <= 1e-6


def test_the_cell_runs_and_is_correct():
    res = run_tiny()
    assert res["correct"] and res["attempted"] >= 1
    assert {"serve_vol_per_s", "setup_s", "peak_device_gib"} >= set(res["metrics"])
    assert res["checks"]["map_gap_mean"]["value"] < 1e-4


def test_a_depthwise_fault_is_not_correct(monkeypatch):
    """The block convs' plain version with its taps mirrored along W (a
    kernel that read the staged row backwards)."""
    from light_unet_tpu_torch.ops import depthwise_kernel as dk

    orig = dk.reference_depthwise_conv3d_k5
    monkeypatch.setattr(dk, "depthwise_conv3d_k5",
                        lambda x, w, b=None: orig(x, w.flip(-1), b))
    from light_unet_tpu_torch.models import mednext as M

    monkeypatch.setattr(M, "depthwise_conv3d_k5", dk.depthwise_conv3d_k5)
    res = run_tiny()
    assert not res["correct"], res["checks"]


def test_the_control_fails_the_cells_limits():
    torch.set_num_threads(2)
    config, workload = tiny()
    with tempfile.TemporaryDirectory() as tmp:
        cell = harness.Cell(CELL, workload, config, 2**31 + 27, 0.0, False, torch.device("cpu"),
                            Path(tmp), time.perf_counter())
        res = control_mednext.serving(cell, cell.settings(), torch.device("cpu"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("patch,batch", [(32, 2), ((32, 32, 64), 1)])
def test_the_frozen_count_is_the_flop_counters_and_the_programs(patch, batch):
    from light_unet_tpu_torch.config import ModelConfig
    from light_unet_tpu_torch.models.cost import forward_cost as program_cost
    from light_unet_tpu_torch.models.cost import mednext_depthwise_cost

    model = dict(tiny()[0]["config"]["model"])
    net = MedNeXt(model).eval()
    dims = (patch,) * 3 if isinstance(patch, int) else patch
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(batch, 1, *dims))
    flops, nbytes = cost_mednext.forward_cost(model, batch, patch, 2, mednext.n_params(model))
    assert flops == counter.get_total_flops()
    mc = ModelConfig(**{k: v for k, v in model.items() if k in ModelConfig.__dataclass_fields__})
    mc.validate()
    assert (flops, nbytes) == program_cost(mc, batch, patch)
    assert cost_mednext.depthwise_cost(model, batch, patch) == mednext_depthwise_cost(
        mc, batch, patch)


def test_the_published_count():
    model = harness.load_json("configs", CONFIG)["config"]["model"]
    assert mednext.n_params(model) == 62_992_866
    flops, _ = cost_mednext.forward_cost(model, 16, 128)
    dw_flops, dw_bytes = cost_mednext.depthwise_cost(model, 16, 128)
    assert (flops, dw_flops, dw_bytes) == (17_881_266_323_456, 2_491_416_576_000,
                                           39_868_180_992)


def test_readers_read_the_depthwise_kernels_by_name():
    trace = harness.Trace(busy_s=2.0, window_s=2.5, units=4, ops=[], gaps=[], kernel_s={
        "void (anonymous namespace)::dw5_vec<__nv_bfloat16, 32>(...)": 0.3,
        "void (anonymous namespace)::dw_vec<__nv_bfloat16, 32, 8>(...)": 0.5,
        "sm90_xmma_gemm_bf16bf16_bf16f32": 1.0})
    work = {"flops": 1.8e13, "bytes": 1.3e11, "dw_flops": 2.49e12, "dw_bytes": 3.99e10,
            "peak_flops": 989e12, "peak_fp32_flops": 67e12, "peak_bytes": 3.35e12}
    out = harness.Outcome(units=4, window_s=2.5, attempted=4, failed=0, setup_s=1.0,
                          peak_bytes=1, trace=trace, work=work)
    read = {m: harness.load_metric(m).read(out) for m in (
        "dw_device_ms.mednext", "dw_roofline_pct.mednext", "window_device_ms.serve",
        "mfu.serve")}
    assert read["dw_device_ms.mednext"] == pytest.approx(75.0)
    assert read["dw_roofline_pct.mednext"] == pytest.approx(100 * 2.49e12 / 67e12 * 4 / 0.3)
    assert read["window_device_ms.serve"] == pytest.approx(500.0)
    assert read["mfu.serve"] == pytest.approx(100 * 1.8e13 * 1.6 / 989e12)
    trace.kernel_s = {"void (anonymous namespace)::dw_vec<__nv_bfloat16, 32, 8>(...)": 0.5}
    assert harness.load_metric("dw_device_ms.mednext").read(out) is None
    assert harness.load_metric("dw_roofline_pct.mednext").read(out) is None


def test_the_cell_reports_the_serving_metrics():
    """The cell's per-layer metrics are the serving cell's (the same
    quantities, moving the same rate) and the depthwise kernels' two; its
    end-to-end metrics are the serving rate, set-up and peak memory."""
    serving = {m["name"] for m in run.metric_specs(BENCH, "fl70.serve_raw", True)}
    assert {m["name"] for m in run.metric_specs(BENCH, CELL, True)} == serving | {
        "dw_device_ms.mednext", "dw_roofline_pct.mednext"}
    assert {m["name"] for m in run.metric_specs(BENCH, CELL, False)} == {
        "serve_vol_per_s", "setup_s", "peak_device_gib"}


def test_the_work_of_a_volume_names_the_float32_peak():
    settings = harness.load_json("configs", CONFIG)["config"]
    work = mednext.volume_work(settings, (144, 144, 272), "cpu")
    assert work["windows"] == 16 and work["flops"] == 17_881_266_323_456
    assert work["peak_fp32_flops"] == 0.0  # no card, no peaks
    assert common.card_peaks("cpu", True) == {"peak_flops": 0.0, "peak_bytes": 0.0}
