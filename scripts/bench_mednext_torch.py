#!/usr/bin/env python3
"""MedNeXt-L k5 (``configs/mednext_l_k5_roi128.yaml``) on one NVIDIA GPU:
its resampling convolutions and its forward at a volume's chunk of 16
windows of 128^3, in bf16 (the 5^3 block kernel is checked and timed
alone by ``chip_smoke.py``'s phase 4c).

* ``resample``: the 8 resampling depthwise convs (4 strided, 4 transposed)
  on PyTorch's grouped convolutions, on a channels-first copy (the copies
  timed with them) and on the channels-last view, timed by CUDA events.
* ``forward``: the model's forward of 16 windows, eager and as one CUDA
  graph replay, its peak memory, its kernel launches (5^3 kernel, K2), and
  the device kernels that took most time in a traced replay.

Last line: one JSON object (also written to ``--out``); nvidia-smi's name and
power limit are printed beside the numbers.

    python3 scripts/bench_mednext_torch.py [--parts resample forward] [--out FILE]

It needs a CUDA card and imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

BATCH = 16
PATCH = 128
REPS = 10
YAML = ROOT / "configs" / "mednext_l_k5_roi128.yaml"


def events_ms(fn, reps: int = REPS) -> float:
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` calls, after one."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def config():
    from light_unet_tpu_torch.config import Config

    return Config.load(YAML)


def resample_part(mc, gen) -> list:
    import torch
    import torch.nn.functional as F

    from light_unet_tpu_torch.models.unet3d import to_ncdhw, to_ndhwc

    n, k = mc.n_channels, mc.kernel_size
    rows = []
    convs = [("down", PATCH // 2 ** i, n * 2 ** i) for i in range(4)]
    convs += [("up", PATCH // 2 ** (i + 1), n * 2 ** (i + 1)) for i in (3, 2, 1, 0)]
    for kind, side, c in convs:
        x = torch.randn((BATCH, side, side, side, c), generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        w = torch.randn((c, 1, k, k, k), generator=gen, device="cuda", dtype=torch.bfloat16)
        b = torch.randn((c,), generator=gen, device="cuda", dtype=torch.bfloat16)
        if kind == "down":
            def conv(xc):
                return F.conv3d(xc, w, b, 2, k // 2, 1, c)
        else:
            def conv(xc):
                return F.conv_transpose3d(xc, w, b, 2, k // 2, 0, c)

        def run(first):
            xc = to_ncdhw(x)
            return to_ndhwc(conv(xc.contiguous() if first else xc)).contiguous()

        row = {"kind": kind, "input": [BATCH, side, side, side, c]}
        with torch.no_grad():
            row["max_gap"] = (run(True).float() - run(False).float()).abs().max().item()
            row["channels_first_ms"] = events_ms(lambda: run(True), reps=3)
            row["channels_last_ms"] = events_ms(lambda: run(False), reps=3)
        rows.append(row)
        print(f"[resample] {kind} {row['input']}: channels-first {row['channels_first_ms']:.3f} "
              f"ms, channels-last {row['channels_last_ms']:.3f} ms", flush=True)
        del x
    for key in ("channels_first_ms", "channels_last_ms"):
        print(f"[resample] the 8 convs, {key}: {sum(r[key] for r in rows):.3f}", flush=True)
    return rows


def forward_part(mc, gen) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.models import mednext
    from light_unet_tpu_torch.ops import depthwise_kernel as dk
    from light_unet_tpu_torch.ops import norm_kernel
    from light_unet_tpu_torch.utils.graphs import GraphRunner

    cfg = config()
    model, _ = port_bench.seeded_model(cfg, "cuda")
    x = torch.rand((BATCH, PATCH, PATCH, PATCH, 1), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    out = {}
    with torch.no_grad():
        n5, nn_ = dk.counts5["launches"], norm_kernel.launches
        eager = model(x)
        out["dw5_launches"] = dk.counts5["launches"] - n5
        out["norm_launches"] = norm_kernel.launches - nn_
        out["eager_ms"] = events_ms(lambda: model(x), reps=3)
        out["eager_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del eager
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runner = GraphRunner("mednext", "cuda")
        first = runner(("fwd",), model, x)[0].clone()
        replay = runner(("fwd",), model, x)[0]
        out["graphed_equals_eager"] = bool(torch.equal(first, replay))
        out["replay_ms"] = events_ms(lambda: runner(("fwd",), model, x), reps=5)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            runner(("fwd",), model, x)
            torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        dev = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
        if dev and ev.key not in ("fwd",):
            by_name[ev.key] = dev / 1e3
    busy = sum(v for k, v in by_name.items() if not k.startswith(("cuda", "aten", "Graph")))
    out["top_kernels_ms"] = sorted(((k[:140], round(v, 3)) for k, v in by_name.items()),
                                   key=lambda kv: -kv[1])[:20]
    out["counts"] = dict(mednext.counts)
    print(f"[forward] B {BATCH} bf16: eager {out['eager_ms']:.1f} ms (peak "
          f"{out['eager_peak_gib']:.2f} GiB), replay {out['replay_ms']:.1f} ms, peak "
          f"{out['peak_gib']:.2f} GiB, dw5 launches {out['dw5_launches']}, K2 launches "
          f"{out['norm_launches']}, graphed == eager {out['graphed_equals_eager']}; kernel sum "
          f"{busy:.1f} ms", flush=True)
    for name, ms in out["top_kernels_ms"]:
        print(f"  {ms:10.3f} ms  {name}", flush=True)
    return out


def main(argv=None) -> int:
    import torch

    from light_unet_tpu_torch import bench as port_bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", nargs="+", default=["resample", "forward"],
                    choices=["resample", "forward"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_mednext_torch: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False  # the float32 head in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = port_bench.device_line("cuda")
    print(f"device: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    mc = config().model
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": smi, "batch": BATCH, "patch": PATCH}
    parts = {"resample": resample_part, "forward": forward_part}
    for name in args.parts:
        result[name] = parts[name](mc, gen)
        torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
