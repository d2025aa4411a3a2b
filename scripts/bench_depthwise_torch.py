#!/usr/bin/env python3
"""The depthwise 3x3x3 convolutions of the PyTorch port's serving forward on
one NVIDIA GPU.

One eager 192-patch bf16 forward of the plain route (``Config()``'s
model, seeded random weights) traced with ``torch.profiler``; each
depthwise conv runs inside a ``dw.<side>^3x<C>`` range, so every device
kernel is split by the depthwise conv that launched it (or none).  Printed:
device-busy ms a forward, the depthwise convs' ms and share, and the
kernels that took most time, each with its share inside and outside the
ranges.  (The 16 convs on the kernel, each against its plain version and
cuDNN with their bounds, are timed by ``chip_smoke.py`` phase 4b.)

Last line: one JSON object; nvidia-smi's name and power limit are printed
beside the numbers.

    python3 scripts/bench_depthwise_torch.py

It needs a CUDA card and imports nothing of JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BATCH = 192
PATCH = 48
TRACED = 3  # forwards in the profiled window


def depthwise_modules(model):
    """The model's depthwise 3x3x3 convs, in forward order."""
    from light_unet_tpu_torch.models.unet3d import DepthwiseConv3d

    return [m for m in model.modules() if isinstance(m, DepthwiseConv3d)]


@contextlib.contextmanager
def ranges(model):
    """Run each depthwise conv of ``model`` inside a ``dw.<side>^3x<C>``
    range."""
    import torch

    saved = []
    for m in depthwise_modules(model):
        orig = m.forward

        def wrapped(x, orig=orig):
            with torch.profiler.record_function(f"dw.{x.shape[1]}^3x{x.shape[-1]}"):
                return orig(x)

        m.forward = wrapped
        saved.append(m)
    try:
        yield
    finally:
        for m in saved:
            del m.forward  # the class's forward again


def kernel_times(prof):
    """{(range or None, kernel name): device us} over the trace, each kernel
    charged to the innermost ``dw.`` range around the op that launched it."""
    out = defaultdict(float)

    def walk(ev, label):
        if ev.name.startswith("dw."):
            label = ev.name
        for k in ev.kernels:
            out[(label, k.name)] += k.duration
        for ch in ev.cpu_children:
            walk(ch, label)

    for ev in prof.events():
        if ev.cpu_parent is None:
            walk(ev, None)
    return out


def attribution(model, x, smi: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), ranges(model):
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACED):
                model(x)
            torch.cuda.synchronize()
    times = kernel_times(prof)
    total = sum(times.values()) / TRACED / 1e3
    if total <= 0:
        raise RuntimeError("the profiler saw no device time")
    dw = sum(v for (label, _), v in times.items() if label) / TRACED / 1e3
    by_range = defaultdict(float)
    by_kernel = defaultdict(lambda: [0.0, 0.0])
    for (label, name), v in times.items():
        if label:
            by_range[label] += v / TRACED / 1e3
        by_kernel[name][0 if label else 1] += v / TRACED / 1e3
    print(f"[attribution] {BATCH}x{PATCH}^3 bf16 plain forward, eager, mean of {TRACED} traced "
          f"on {smi}: device busy {total:.3f} ms, depthwise convs {dw:.3f} ms "
          f"({100 * dw / total:.2f} %)", flush=True)
    for label, v in sorted(by_range.items(), key=lambda kv: -kv[1]):
        print(f"  {label}: {v:.3f} ms", flush=True)
    top = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:12]
    for name, (inside, outside) in top:
        print(f"  {inside + outside:9.3f} ms ({100 * (inside + outside) / total:5.2f} %; in "
              f"depthwise ranges {inside:.3f}, outside {outside:.3f}) {name[:110]}", flush=True)
    return {"busy_ms": total, "depthwise_ms": dw, "depthwise_share": dw / total,
            "by_range_ms": dict(by_range),
            "top_kernels": [[n[:120], round(a, 4), round(b, 4)] for n, (a, b) in top]}


def main(argv=None) -> int:
    import torch

    from light_unet_tpu_torch import bench as port_bench

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_depthwise_torch: needs a CUDA card", file=sys.stderr)
        return 2
    smi = port_bench.device_line("cuda")
    print(f"device: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}", flush=True)
    cfg = port_bench.default_config()
    model, _ = port_bench.seeded_model(cfg, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.rand((BATCH, PATCH, PATCH, PATCH, 1), generator=gen, device="cuda")
    print(json.dumps({"device": smi, "batch": BATCH, "patch": PATCH,
                      "attribution": attribution(model, x, smi)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
