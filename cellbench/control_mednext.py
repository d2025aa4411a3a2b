"""The readings the MedNeXt cell's correctness limits are set from, on the card.

    python3 cellbench/control_mednext.py --workload mednext.serve_raw --seeds <n> [<n> ...]

``control.py`` for a MedNeXt cell: for each seed, from the cell's own
inputs (the ``serve_raw`` pool and its sampled volumes), the plain
reference computed in fp8 (every convolution's input, weight and output,
every norm's output and every block's output in e4m3, each tensor scaled to
the type's range: the precision below the configuration's bfloat16) is held against the float32
reference by the cell's own numbers and limits (``common.map_check``).
Prints one JSON line a seed, with ``correct`` as a run would give it.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from cellbench import common, harness, mednext  # noqa: E402
from cellbench.reference.unet import fake_quant  # noqa: E402


def serving(cell: harness.Cell, settings: dict, device) -> dict:
    """The control's readings of the cell's sampled maps, its checks against
    the cell's limits, and whether they pass."""
    from cellbench.drivers import serve_raw

    p = cell.params
    state = mednext.cell_state(cell, device)
    f32 = mednext.reference_net(settings, state, device)
    low = mednext.reference_net(settings, state, device, fake_quant())
    check_rng = np.random.default_rng([cell.seed, 1])
    raws = serve_raw.make_raws(cell)
    sample = sorted(check_rng.choice(len(raws), int(p["check_sample"]), False))
    patch = tuple(settings["data"]["patch_size"])
    gaps = []
    for i in sample:
        norm, mask = common.normalized_raw(settings, raws[i])
        ref = mednext.reference_map(f32, settings, norm, device, mask)
        gaps.append(common.map_gaps(mednext.reference_map(low, settings, norm, device, mask), ref,
                                    patch))
    checks = common.map_check(gaps, cell.limits)
    return {"control": {k: max(g[k] for g in gaps) for k in gaps[0]},
            "checks": harness.checks_line(checks), "correct": harness.passes(checks)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cellbench: the control runs on a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    workload = harness.load_json("workloads", args.workload)
    config = harness.load_json("configs", workload["config"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="cellbench-control-") as tmp:
            cell = harness.Cell(args.workload, workload, config, seed, 0.0, False, device,
                                Path(tmp), t0)
            res = serving(cell, cell.settings(), device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **res}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
