"""The control against each cell's limits: the plain reference in the
precision below the configuration's bfloat16 (fp8, ``cellbench/control.py``)
comes out as not correct, judged by the cell's own comparison.

On the CPU at the configuration's widths on small volumes of a few
windows; at each cell's own size on a card (``cuda`` marker)."""

import copy
import tempfile
import time
from pathlib import Path

import pytest
import torch

from cellbench import control, harness

SMALL = {"fl70.serve_raw": dict(shape=[48, 48, 96], pool=2),
         "fl70.infer_stage": dict(shape=[48, 48, 96], cases=2)}


def control_result(cell: str, seed: int, device, params=None) -> dict:
    workload = copy.deepcopy(harness.load_json("workloads", cell))
    workload["params"].update(params or {})
    config = harness.load_json("configs", workload["config"])
    with tempfile.TemporaryDirectory() as tmp:
        c = harness.Cell(cell, workload, config, seed, 0.0, False, device, Path(tmp),
                         time.perf_counter())
        return control.serving(c, c.settings(), device)


def check(cell, seed, device, params=None):
    res = control_result(cell, seed, device, params)
    assert not res["correct"], res["checks"]
    assert any(v["value"] > v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fails_on_the_cpu(cell):
    torch.set_num_threads(4)
    check(cell, 2**31 + 101, torch.device("cpu"), SMALL[cell])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [2**31 + 1, 2**31 + 2, 2**31 + 3])
def test_fails_at_the_cells_size(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    check(cell, seed, torch.device("cuda", 0))
