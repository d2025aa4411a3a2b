"""Run one benchmark cell once.

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Loads, warms up every shape the cell uses,
measures for ``--seconds`` (the window ends at the first unit of work
that completes after that), checks the window's outputs against the plain
reference, and prints: earlier lines with the detail (the set-up's split,
the graph captures, the card, the spans, the checks), then as the last
line one JSON object with ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each compared number with its limit.  Exits non-zero, with no
result line, when there is no CUDA card, or when the JAX package or JAX
was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from cellbench import harness  # noqa: E402


def metric_specs(bench: dict, cell: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def run_cell(name: str, workload: dict, config: dict, seed: int, seconds: float, trace: bool,
             device, specs: list, t_start: float) -> dict:
    """Drive the cell and assemble the result line (a dict, ``checks`` last)."""
    import torch

    with tempfile.TemporaryDirectory(prefix="cellbench-") as tmp:
        cell = harness.Cell(name, workload, config, seed, seconds, trace, device, Path(tmp),
                            t_start)
        driver = harness.load_module("drivers", workload["driver"])
        out = driver.run(cell)
    metrics = {}
    for spec in specs:
        value = harness.load_metric(spec["name"]).read(out)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": kind,
                         "count": 1, "memory_peak_bytes": out.peak_bytes}}
    if out.trace is not None:
        result["device"]["busy_s"] = out.trace.busy_s
        result["device"]["window_s"] = out.trace.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in out.trace.ops],
                               "idle_gaps": [list(x) for x in out.trace.gaps]}
    print("setup_split " + json.dumps(out.setup_split), flush=True)
    print("detail " + json.dumps(out.detail, default=str), flush=True)
    if out.spans is not None:
        print("spans_ms " + json.dumps({k: [round(1e3 * x, 3) for x in v][:64]
                                        for k, v in out.spans.seconds.items()}), flush=True)
    result["checks"] = harness.checks_line(out.checks)
    return result


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"cellbench: BENCHMARK.json has no cell {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"cellbench: the cell needs {entry['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", entry["config"])
    print("card " + card_line(), flush=True)
    result = run_cell(args.workload, workload, config, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0),
                      metric_specs(bench, args.workload, bool(args.trace)), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"cellbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
