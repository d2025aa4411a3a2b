"""PyTorch port: ``--mode bench`` and the measurement scripts on the CPU.

* ``light_unet_tpu_torch/tools/synthetic.py:build_raw_dataset`` writes the
  files of ``tests/synthetic.py:build_raw_dataset``, byte for byte;
* ``light_unet_tpu_torch/bench.py`` at a tiny size (2 volumes of 24x24x40,
  16^3 patches, widths [4, 8, 16, 32], one pass): one JSON line whose key
  tree is the JAX bench's (``BENCH_r05.json``'s ``parsed``) plus
  ``detail.tpu.device``, and its pipeline's maps equal to the JAX
  package's ``FusedVolumePipeline`` within 1e-4 in float32 (weights carried
  over by ``tools/weights.py``);
* ``models/cost.py``: the per-level rows of ``scripts/roofline.py`` key for
  key, and the whole forward's operations equal to ``FlopCounterMode``'s;
* the four scripts ``scripts/{bench_train_step,bench_fused_block,
  bench_link_opts,roofline}_torch.py``, each end to end at a tiny size with
  ``--device cpu``, print their JSON keys."""

import functools
import importlib.util
import json
import math
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.ops.fused import FusedVolumePipeline as JaxPipeline
from light_unet_tpu_torch import bench
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.models import cost
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.tools import synthetic as port_synthetic
from light_unet_tpu_torch.tools.weights import to_jax_params
from light_unet_tpu_torch.utils import fastio
from tests import synthetic
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
SHAPE = (24, 24, 40)
TINY = {"data": {"patch_size": [16, 16, 16]}, "model": {"encoder_channels": [4, 8, 16, 32]},
        "tpu": {"z_bucket": 16, "compute_dtype": "float32"}}


def tiny_config() -> Config:
    return Config.from_dict(TINY)


def key_tree(d):
    return {k: key_tree(v) for k, v in d.items()} if isinstance(d, dict) else None


@pytest.fixture
def tiny_bench(monkeypatch):
    """The bench's module constants and config shrunk to the tiny size."""
    monkeypatch.setattr(bench, "VOLUME_SHAPE", SHAPE)
    monkeypatch.setattr(bench, "N_VOLUMES", 2)
    monkeypatch.setattr(bench, "PATCH", (16, 16, 16))
    monkeypatch.setattr(bench, "default_config", tiny_config)
    monkeypatch.setattr(bench, "bench_gpu", functools.partial(bench.bench_gpu, reps=1))


def expected_keys() -> dict:
    want = key_tree(json.loads((REPO / "BENCH_r05.json").read_text())["parsed"])
    want["detail"]["tpu"]["device"] = None
    return want


def check_line(line: dict) -> None:
    assert key_tree(line) == expected_keys()
    tpu = line["detail"]["tpu"]
    assert line["metric"] == "volumes_per_sec_e2e_preprocess_plus_sliding_window_144x144x272"
    assert tpu["backend"] == "cpu" and tpu["device"] == "cpu" and tpu["n_volumes"] == 2
    assert tpu["n_reps"] == len(tpu["volumes_per_sec_reps"]) >= 1
    assert all(math.isfinite(v) and v > 0 for v in tpu["volumes_per_sec_reps"])
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["detail"]["torch_cpu_serial_baseline"]["n_patches"] == 16


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("hard", [False, True])
def test_build_raw_dataset_writes_the_tests_files(seed, hard, tmp_path):
    ids = ["0001", "0002", "0003"]
    got = port_synthetic.build_raw_dataset(tmp_path / "port", ids, shape=(16, 18, 20),
                                           seed=seed, hard=hard)
    assert got == synthetic.build_raw_dataset(tmp_path / "jax", ids, shape=(16, 18, 20),
                                              seed=seed, hard=hard) == ids
    for cid in ids:
        for rel in (f"images/{cid}_0000.nii.gz", f"labels/{cid}.nii.gz"):
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_run_bench_prints_the_jax_line(tiny_bench, capsys):
    result = bench.run_bench(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == result
    assert sum(1 for ln in lines if ln.startswith("{")) == 1
    check_line(result)


def test_bench_gpu_on_the_cpu(tmp_path):
    """``bench_gpu`` alone: the accelerated half of the line, with its rep
    rule (at least ``reps`` passes) and its serial phase split."""
    ids = port_synthetic.build_raw_dataset(tmp_path, ["0001", "0002"], shape=SHAPE, seed=0)
    out = bench.bench_gpu(tmp_path, ids, device="cpu", reps=2, config=tiny_config())
    assert key_tree(out) == expected_keys()["detail"]["tpu"]
    assert out["n_reps"] >= 2 and out["n_volumes"] == 2 and out["backend"] == "cpu"
    assert out["volumes_per_sec_min"] <= out["volumes_per_sec"] <= out["volumes_per_sec_max"]
    assert all(v >= 0 for v in out["phase_seconds_median"].values())


def test_bench_pipeline_matches_jax(tmp_path):
    """The bench's pipeline (uint16 transfer and fetch, sparse fetch, body
    mask) on its own volumes equals the JAX package's ``FusedVolumePipeline``
    with the same weights within 1e-4 in float32."""
    cfg = tiny_config()
    model, pipe = bench.make_pipeline(cfg, "cpu")
    jcfg = JaxConfig.from_dict(TINY)
    jmodel = jax_build_model(jcfg.model, jnp.float32, inference=True, precision="highest")
    params = to_jax_params(model.state_dict())
    jpipe = JaxPipeline(lambda p, x: jmodel.apply(p, x, train=False), jcfg,
                        patch_batch=jcfg.tpu.patch_batch)
    ids = bench.raw_volumes(tmp_path, 2, SHAPE)
    for cid in ids:
        image = fastio.load_f32(bench.image_path(tmp_path, cid))[0]
        got, want = pipe(image), np.asarray(jpipe(params, image))
        assert got.shape == want.shape == SHAPE
        assert np.abs(got - want).max() <= 1e-4
        assert 0 < (got == 0).mean() < 1


def _roofline_module():
    spec = importlib.util.spec_from_file_location("jax_roofline", SCRIPTS / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kw", [{}, {"batch": 7, "d": 16, "ch": (4, 8, 16, 32)},
                                {"batch": 192, "d": 64}], ids=["default", "tiny", "b192-d64"])
def test_cost_levels_equal_the_jax_rows(kw):
    assert cost.analytic_levels(**kw) == _roofline_module().analytic_levels(**kw)


@pytest.mark.parametrize("model,patch", [
    ({}, 48), ({}, (20, 18, 30)), ({"encoder_channels": [4, 8, 16, 32]}, 16),
    ({"use_depthwise_separable": False}, 24),
    ({"use_depthwise_separable": False, "use_grouped_conv": False}, 24)], ids=str)
def test_forward_cost_operations_equal_flop_counter(model, patch):
    """The analytic operations of the whole forward equal
    ``FlopCounterMode``'s count of the model (on the meta device); bytes
    grow with the activation dtype and hold the float32 parameters."""
    mc = Config.from_dict({"model": model}).model
    dims = (patch,) * 3 if isinstance(patch, int) else patch
    with torch.device("meta"):
        net = build_model(mc, torch.bfloat16, inference=True)
        x = torch.empty(3, *dims, 1)
    with FlopCounterMode(display=False) as counter:
        net(x)
    flops, bf16_bytes = cost.forward_cost(mc, 3, patch, torch.bfloat16)
    assert flops == counter.get_total_flops()
    f32_flops, f32_bytes = cost.forward_cost(mc, 3, patch, torch.float32)
    assert f32_flops == flops and f32_bytes > bf16_bytes
    params = sum(p.numel() for p in net.parameters())
    assert cost.parameter_count(mc) == params
    assert bf16_bytes - sum(r["bytes"] for r in cost.forward_terms(mc, 3, patch)) == 4 * params


def test_forward_cost_takes_no_route():
    """The count is the model's and the shape's: no route argument."""
    import inspect

    assert list(inspect.signature(cost.forward_cost).parameters) == [
        "model_cfg", "batch", "patch", "dtype"]
    assert cost.parameter_count(Config().model) == 217228


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"{name}_torch", SCRIPTS / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LINK_KEYS = {
    "sparse_fetch_serving": {"experiment", "n_volumes", "segments", "dense_vps_median",
                             "sparse_vps_median", "speedup", "dense_vps_segments",
                             "sparse_vps_segments", "bit_identical"},
    "steps_per_dispatch": {"experiment", "batch", "k", "steps_per_sec_median", "step_ms",
                           "segments_sps"},
    "pack_mask_sliding_window": {"experiment", "n_volumes", "segments", "unpacked_vps_median",
                                 "packed_vps_median", "speedup", "unpacked_vps_segments",
                                 "packed_vps_segments", "bit_identical"},
    "patch_batch_roofline": {"experiment", "patch_batch", "forward_ms_median",
                             "forward_ms_per_patch", "achieved_gbps", "e2e_vps_median",
                             "e2e_vps_segments"},
    "tail_chunk_schedule": {"experiment", "patch_batch", "n_volumes", "segments",
                            "slots_uniform", "slots_tailed", "uniform_vps_median",
                            "tailed_vps_median", "speedup", "uniform_vps_segments",
                            "tailed_vps_segments", "max_abs_diff"},
}


def _check_train_step(rows):
    want = {"mode", "batch", "step_ms_median_synced", "step_ms_pipelined",
            "steps_per_sec_pipelined", "piped_segments_ms", "corpus_active", "device"}
    assert [(r["mode"], r["batch"]) for r in rows] == [("host", 2), ("corpus", 2)]
    assert all(set(r) == want and r["device"] == "cpu" for r in rows)
    assert [r["corpus_active"] for r in rows] == [False, True]
    assert all(r["steps_per_sec_pipelined"] > 0 for r in rows)


def _check_fused_block(rows):
    (row,) = rows
    assert set(row) == {"batch", "patch", "plain_ms", "fused_ms", "speedup", "max_abs_diff",
                        "block_launches", "device"}
    assert row["batch"] == 2 and row["max_abs_diff"] <= 5e-2 and row["device"] == "cpu"


def _check_link_opts(rows):
    assert [r["experiment"] for r in rows] == [
        "sparse_fetch_serving", "steps_per_dispatch", "steps_per_dispatch",
        "pack_mask_sliding_window", "patch_batch_roofline", "patch_batch_roofline",
        "tail_chunk_schedule"]
    for r in rows:
        assert LINK_KEYS[r["experiment"]] <= set(r) and r["device"] == "cpu"
    assert rows[0]["bit_identical"] and rows[3]["bit_identical"]
    assert rows[-1]["slots_tailed"] < rows[-1]["slots_uniform"]
    assert rows[-1]["max_abs_diff"] <= 0.06


def _check_roofline(rows):
    assert [r["route"] for r in rows] == ["plain", "fused_block"]
    mc = tiny_config().model
    flops, bytes_ = cost.forward_cost(mc, 2, 16, torch.bfloat16)
    for r in rows:
        assert r["gflop"] == round(flops / 1e9, 4) == r["flop_counter_gflop"]
        assert r["mbytes"] == round(bytes_ / 1e6, 4) and r["forward_ms_median"] > 0
        assert r["roofline_pct"] is None and r["achieved_tflops"] is None  # no card


SCRIPT_RUNS = {
    "bench_train_step": ({"N_CASES": 2, "SHAPE": SHAPE, "STEPS": 2, "BATCHES": (2,),
                          "SEGMENTS": 1}, [], _check_train_step),
    "bench_fused_block": ({"PATCH": 16, "ROUNDS": 2, "INNER": 1}, ["2"], _check_fused_block),
    "bench_link_opts": ({"N_VOLUMES": 2, "N_CASES": 2},
                        ["--shape", *map(str, SHAPE), "--segments", "1", "--steps", "2",
                         "--batches", "2", "--ks", "1", "2", "--pbatches", "4", "8",
                         "--tail-pbatch", "12"], _check_link_opts),
    "roofline": ({"PATCH": 16, "TIMED": 2, "BATCH": 2},
                 ["--route", "plain", "fused_block"], _check_roofline),
}


@pytest.mark.parametrize("name", sorted(SCRIPT_RUNS))
def test_script_runs_tiny_on_the_cpu(name, monkeypatch, capsys, tmp_path):
    """Each script end to end at a tiny size (``--device cpu``, module
    constants and the bench's config shrunk), printing its JSON lines."""
    consts, argv, check = SCRIPT_RUNS[name]
    monkeypatch.setattr(bench, "default_config", tiny_config)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    mod = _script(name)
    for k, v in consts.items():
        monkeypatch.setattr(mod, k, v)
    assert mod.main([*argv, "--device", "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    check(rows)
