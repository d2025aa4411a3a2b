"""The harness finds every configuration, cell, driver and metric from its
files alone, and a new cell with a new metric runs from new files only."""

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from cellbench import harness, run
from tiny import ROOT, tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_found_by_name(entry):
    config = harness.load_json("configs", entry["name"])
    assert entry["file"] == f"cellbench/configs/{entry['name']}.json"
    assert config["source"] == entry["source"] and config["reduced"] == entry["reduced"]
    assert {"model", "data", "tpu", "training"} <= set(config["config"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cell_found_by_name(entry):
    workload = harness.load_json("workloads", entry["name"])
    assert workload["config"] == entry["config"] and workload["traffic"] == entry["traffic"]
    assert workload["why"] == entry["why"] and entry["chips"] == 1
    assert callable(harness.load_module("drivers", workload["driver"]).run)
    assert workload["limits"], "a cell compares at least one number"


@pytest.mark.parametrize("entry", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_found_by_name(entry):
    assert callable(harness.load_metric(entry["name"]).read)
    for cell in entry.get("workloads", []):
        assert any(w["name"] == cell for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_every_cell_reports_its_metrics(cell, trace):
    specs = run.metric_specs(BENCH, cell, trace)
    assert specs
    if not trace:
        names = {m["name"] for m in specs}
        assert "setup_s" in names and len(names) >= 2


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cellbench"] and BENCH["command"] == ["python3", "cellbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert any(e["name"] == m["moves"] for e in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_new_cell_and_metric_from_new_files_only(tmp_path):
    """A copy of the benchmark gains a cell (a workload file) and a metric (a
    reader file) and runs them with no other file changed."""
    copy = tmp_path / "cellbench"
    shutil.copytree(ROOT / "cellbench", copy, ignore=shutil.ignore_patterns("__pycache__"))
    config, workload = tiny("fl70.serve_raw", pool=2)
    workload["why"] = "a new cell added as data"
    (copy / "workloads" / "fl70.extra.json").write_text(json.dumps(workload))
    (copy / "configs" / "unet_tiny.json").write_text(json.dumps(config))
    (copy / "metrics" / "volumes_done.serve.py").write_text(textwrap.dedent('''
        def read(out):
            return float(out.units)
    '''))
    code = textwrap.dedent(f'''
        import json, sys, time, torch
        sys.path.insert(0, {str(tmp_path)!r}); sys.path.insert(1, {str(ROOT)!r})
        from cellbench import harness, run
        assert harness.ROOT == __import__("pathlib").Path({str(copy)!r})
        wl = harness.load_json("workloads", "fl70.extra")
        cfg = harness.load_json("configs", "unet_tiny")
        specs = [{{"name": "setup_s", "unit": "s"}}, {{"name": "volumes_done.serve", "unit": "vol"}}]
        res = run.run_cell("fl70.extra", wl, cfg, 7, 0.5, False, torch.device("cpu"), specs,
                           time.perf_counter())
        print(json.dumps(res))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["volumes_done.serve"]["value"] >= 1
    assert list(res)[-1] == "checks"
