"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
narrow widths (4..32 channels), 16^3 patches, float32, small volumes."""

from __future__ import annotations

import copy
import time
from pathlib import Path

import torch

from cellbench import harness, run

CONFIG_OF = {"fl70.serve_raw": "unet_fl70", "fl70.infer_stage": "unet_fl70"}


def tiny(cell: str, **params):
    """(config file, workload) of ``cell`` at the test size."""
    config = copy.deepcopy(harness.load_json("configs", CONFIG_OF[cell]))
    c = config["config"]
    c["model"]["encoder_channels"] = [4, 8, 16, 32]
    c["data"]["patch_size"] = [16, 16, 16]
    c["tpu"].update(compute_dtype="float32", patch_batch=8, z_bucket=16)
    workload = copy.deepcopy(harness.load_json("workloads", cell))
    workload["params"].update({"shape": [24, 24, 40], **params})
    return config, workload


def run_tiny(cell: str, seed: int = 2**31 + 11, seconds: float = 1.0, **params) -> dict:
    """The result line of one CPU run of ``cell`` at the test size."""
    torch.set_num_threads(2)
    config, workload = tiny(cell, **params)
    specs = [{"name": "setup_s", "unit": "s"}]
    return run.run_cell(cell, workload, config, seed, seconds, False, torch.device("cpu"),
                        specs, time.perf_counter())


ROOT = Path(__file__).resolve().parents[2]
