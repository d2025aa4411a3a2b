"""The SwinUNETR cell (``swinunetr.serve_raw``) at a size the CPU runs in
seconds (feature size 12, 32^3 windows, float32, small volumes): it runs
from its files and is correct; faults in the attention (no relative bias in
the unshifted blocks, no shift) and the fp8 control come out not correct
against the cell's own limits; the frozen count equals ``FlopCounterMode``
over the reference and the program's count; the cell reports the serving
cells' per-layer metrics beside its own two, whose readers read the
attention kernels by name and nothing where nothing ran."""

import copy
import json
import tempfile
import time
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cellbench import control_swin, cost_swin, harness, run, swin
from cellbench.reference.swin_unetr import SwinUNETR
from tiny import ROOT

CELL = "swinunetr.serve_raw"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny():
    config = copy.deepcopy(harness.load_json("configs", "swinunetr_fs48_roi96"))
    c = config["config"]
    c["model"]["feature_size"] = 12
    c["data"]["patch_size"] = [32, 32, 32]
    c["tpu"].update(compute_dtype="float32", patch_batch=4, z_bucket=16)
    workload = copy.deepcopy(harness.load_json("workloads", CELL))
    workload["params"].update(shape=[40, 36, 48], pool=2)
    return config, workload


def run_tiny(seed=2**31 + 5):
    torch.set_num_threads(2)
    config, workload = tiny()
    specs = run.metric_specs(BENCH, CELL, False)
    return run.run_cell(CELL, workload, config, seed, 1.0, False, torch.device("cpu"), specs,
                        time.perf_counter())


def test_the_cell_runs_and_is_correct():
    res = run_tiny()
    assert res["correct"] and res["attempted"] >= 1
    assert {"serve_vol_per_s", "setup_s", "peak_device_gib"} >= set(res["metrics"])
    assert res["checks"]["map_gap_mean"]["value"] < 1e-4


@pytest.mark.parametrize("fault", ["no_relative_bias", "no_shift"])
def test_attention_faults_are_not_correct(fault, monkeypatch):
    from light_unet_tpu_torch.models import swin_unetr as S

    if fault == "no_relative_bias":
        orig = S.WindowAttention.attention_mask

        def mask(self, n, windows, region=None):
            m = orig(self, n, windows, region)
            return m * 0 if region is None else m
        monkeypatch.setattr(S.WindowAttention, "attention_mask", mask)
    else:
        monkeypatch.setattr(S, "window_and_shift", lambda dims, w, s: (
            tuple(d if d <= w else w for d in dims), (0, 0, 0)))
    res = run_tiny()
    assert not res["correct"], res["checks"]


def test_the_control_fails_the_cells_limits():
    torch.set_num_threads(2)
    config, workload = tiny()
    with tempfile.TemporaryDirectory() as tmp:
        cell = harness.Cell(CELL, workload, config, 2**31 + 7, 0.0, False, torch.device("cpu"),
                            Path(tmp), time.perf_counter())
        res = control_swin.serving(cell, cell.settings(), torch.device("cpu"))
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("patch,batch", [(32, 2), ((32, 32, 64), 1)])
def test_the_frozen_count_is_the_flop_counters_and_the_programs(patch, batch):
    from light_unet_tpu_torch.config import ModelConfig
    from light_unet_tpu_torch.models.cost import forward_cost as program_cost

    model = dict(tiny()[0]["config"]["model"])
    net = SwinUNETR(model).eval()
    dims = (patch,) * 3 if isinstance(patch, int) else patch
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        net(torch.zeros(batch, 1, *dims))
    flops, nbytes = cost_swin.forward_cost(model, batch, patch, 2, swin.n_params(model))
    assert flops == counter.get_total_flops()
    mc = ModelConfig(**{k: v for k, v in model.items() if k in ModelConfig.__dataclass_fields__})
    mc.validate()
    assert (flops, nbytes) == program_cost(mc, batch, patch)


def test_the_published_count():
    model = harness.load_json("configs", "swinunetr_fs48_roi96")["config"]["model"]
    assert swin.n_params(model) == 62_186_659
    flops, _ = cost_swin.forward_cost(model, 20, 96)
    attn_flops, attn_bytes = cost_swin.attention_cost(model, 20, 96)
    assert (flops, attn_flops, attn_bytes) == (12_718_906_298_880, 457_349_337_600,
                                               2_677_378_440)


def test_readers_read_the_attention_kernels_by_name():
    trace = harness.Trace(busy_s=2.0, window_s=2.5, units=4, ops=[], gaps=[], kernel_s={
        "fmha_cutlassF_bf16_aligned_64x64_rf_sm80(AttentionKernel)": 0.04,
        "sm80_xmma_fprop_implicit_gemm_bf16": 1.0})
    work = {"flops": 1e13, "bytes": 3e10, "attn_flops": 4e11, "attn_bytes": 2.6e9,
            "peak_flops": 989e12, "peak_bytes": 3.35e12}
    out = harness.Outcome(units=4, window_s=2.5, attempted=4, failed=0, setup_s=1.0,
                          peak_bytes=1, trace=trace, work=work)
    read = {m: harness.load_metric(m).read(out) for m in (
        "window_device_ms.serve", "attn_device_ms.swin", "attn_roofline_pct.swin", "mfu.serve",
        "forward_roofline_pct.serve", "device_idle_pct.serve")}
    assert read["window_device_ms.serve"] == pytest.approx(500.0)
    assert read["attn_device_ms.swin"] == pytest.approx(10.0)
    assert read["attn_roofline_pct.swin"] == pytest.approx(100 * 2.6e9 / 3.35e12 * 4 / 0.04)
    assert read["mfu.serve"] == pytest.approx(100 * 1e13 * 1.6 / 989e12)
    assert read["forward_roofline_pct.serve"] == pytest.approx(100 * 1e13 / 989e12 * 4 / 2.0)
    assert read["device_idle_pct.serve"] == pytest.approx(20.0)
    trace.kernel_s = {"sm80_xmma_fprop_implicit_gemm_bf16": 1.0}
    assert harness.load_metric("attn_device_ms.swin").read(out) is None
    assert harness.load_metric("attn_roofline_pct.swin").read(out) is None


def test_the_cell_reports_the_serving_metrics():
    """The cell's per-layer metrics are the serving cell's (the same
    quantities, moving the same rate) and the attention's two; its
    end-to-end metrics are the serving rate, set-up and peak memory."""
    serving = {m["name"] for m in run.metric_specs(BENCH, "fl70.serve_raw", True)}
    assert {m["name"] for m in run.metric_specs(BENCH, CELL, True)} == serving | {
        "attn_device_ms.swin", "attn_roofline_pct.swin"}
    assert {m["name"] for m in run.metric_specs(BENCH, CELL, False)} == {
        "serve_vol_per_s", "setup_s", "peak_device_gib"}
