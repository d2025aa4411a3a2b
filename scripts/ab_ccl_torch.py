"""A/B of the CCL kernel on the card: this checkout's ``csrc/ccl.cu`` against
another version of the file, in one process, on ``chip_smoke.py`` phase
13a's masks and phase 13e's validation sweep.

    git show <commit>:light_unet_tpu_torch/csrc/ccl.cu > .chip_work/ccl_other.cu
    python3 scripts/ab_ccl_torch.py --other .chip_work/ccl_other.cu

The other file is built with the same flags into a library of its own and
takes the wrapper's place by swapping ``ops/_build._libs["ccl"]`` (its C
entry must be ``ccl_label(fg, labels, D, H, W, stream)``).  Phase 5's
preprocess (the closed body masks) and phase 6's serving on the
``fused_block`` route (the served maps) make the masks; then 13a runs with
this, the other, the other and this kernel (each run holds the labels
equal to the plain sweeps), and the graphed sweep (9 thresholds, cap 4096)
runs on two served maps in the same order.  Prints one line a mask with
the least time of each kernel and, last, one JSON object."""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ORDER = ("this", "other", "other", "this")
THRESHOLDS = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]


def build_other(src: Path, out_dir: Path) -> ctypes.CDLL:
    from light_unet_tpu_torch.ops import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libccl_other.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib_path),
           str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.ccl_label.argtypes = _build.ENTRIES["ccl"]["ccl_label"]
    lib.ccl_label.restype = ctypes.c_int
    return lib


def sweep_ms(libs: dict, maps: dict, data_dir: Path) -> dict:
    """{kernel: {case: [ms a threshold, one graphed sweep a run]}}."""
    import torch

    import chip_smoke as cs
    from light_unet_tpu_torch.ops import _build
    from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
    from light_unet_tpu_torch.utils import fastio

    out: dict = {}
    for cid, m in list(maps.items())[:2]:
        label = fastio.load_f32(data_dir / f"labels/{cid}.nii.gz")[0]
        gt = np.zeros(m.shape, np.uint8)
        gt[: label.shape[0], : label.shape[1], : label.shape[2]] = label > 0.5
        gt = torch.from_numpy(gt).cuda()
        prob = torch.from_numpy(np.ascontiguousarray(m, np.float32)).cuda()
        tables = {}
        for name in ORDER:
            _build._libs["ccl"] = libs[name]
            # a sweep made after the swap captures the swapped kernel
            sweep = DeviceValidationSweep(THRESHOLDS, max_components=4096, graphs=True,
                                          device="cuda")
            res = sweep.tables(prob, gt)
            tables.setdefault(name, [t.clone() for t in res])
            ms = min(cs.timed_dispatch(sweep.tables, prob, gt)[2] for _ in range(3))
            out.setdefault(name, {}).setdefault(cid, []).append(ms / len(THRESHOLDS))
            del sweep
        if not all(torch.equal(a, b) for a, b in zip(tables["this"], tables["other"])):
            raise AssertionError(f"the two kernels' sweep tables differ on case {cid}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="the other version of csrc/ccl.cu")
    parser.add_argument("--out", type=Path, default=None, help="also write the JSON here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ab_ccl_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.models.unet3d import build_model, init_weights
    from light_unet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    _build.build_host("fastio")
    libs = {"this": _build.load("ccl"),
            "other": build_other(args.other.resolve(), _build.build_dir() / "other")}
    smi = cs.nvidia_smi()
    cs.log(f"[ab] this {_build.CSRC / 'ccl.cu'} against {args.other}; {smi}")
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
        tmp = Path(tmp)
        data_dir, split, _, closed, _ = cs.preprocess_phase(tmp, cs.SERVING)
        model = init_weights(build_model(Config.from_dict(cs.SERVING).model, torch.bfloat16,
                                         inference=True), torch.Generator().manual_seed(1))
        model_path = tmp / "models/best_model.pth"
        model_path.parent.mkdir(parents=True)
        torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, model_path)
        cfg = json.loads(json.dumps(cs.SERVING))
        cfg["tpu"].update(dict(cs.GATES)["fused_block"])
        _, maps = cs.serve(cfg, model_path, data_dir, split, tmp / "served")
        masks = cs.ccl_masks(closed, maps)
        times: dict = {}
        try:
            for name in ORDER:
                _build._libs["ccl"] = libs[name]
                cs.log(f"[ab] 13a with {name}")
                rows, _ = cs.ccl_phase(masks, smi)
                for mask, row in rows.items():
                    times.setdefault(mask, {}).setdefault(name, []).append(row["ms"])
            sweeps = sweep_ms(libs, maps, data_dir)
        finally:
            _build._libs["ccl"] = libs["this"]
    for mask, by in times.items():
        cs.log(f"[ab] {mask}: this {min(by['this']):.4f} ms, other {min(by['other']):.4f} ms "
               f"(least of {len(by['this'])} runs each, order {' '.join(ORDER)})")
    for cid in sweeps["this"]:
        cs.log(f"[ab] 13e sweep, case {cid}: this {sweeps['this'][cid]}, other "
               f"{sweeps['other'][cid]} ms a threshold (graphed, tables equal)")
    result = {"device": smi, "ccl_ms": {m: {k: min(v) for k, v in by.items()}
                                        for m, by in times.items()},
              "sweep_ms_a_threshold": sweeps, "seconds": round(time.perf_counter() - t0, 1)}
    if args.out:
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
