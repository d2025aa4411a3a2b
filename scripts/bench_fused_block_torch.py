#!/usr/bin/env python3
"""Interleaved A/B of the PyTorch port's serving forward: the plain route
against fused residual blocks (the port of ``scripts/bench_fused_block.py``).

The fused route (``models/fused_forward.py:make_fused_apply``) runs every
residual block through the block kernel (``csrc/residual_block.cu``); the
plain route is the model's own convolutions, norms and activations.  The
whole forward of a batch of 48^3 patches (bf16, ``Config()``'s model,
seeded random weights, input drawn on the device from a seeded generator)
is timed both ways with CUDA events, interleaved plain / fused / plain /
fused, ``ROUNDS`` rounds of ``INNER`` forwards each; the medians, the
speed-up and the largest difference of the two outputs are printed, then
one JSON line a batch.  On a card it fails when the block kernel did not
launch (``ops/block_kernel.launches``) or when the outputs differ by more
than the bf16 bar of 5e-2 (``tests/unit/test_pallas_kernels.py:64``).

    python3 scripts/bench_fused_block_torch.py [batch ...]        # default 96 192
    python3 scripts/bench_fused_block_torch.py 2 --device cpu     # the plain versions

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PATCH = 48
ROUNDS = 7
INNER = 3  # forwards per timed round
BAR = 5e-2


def bench(fn, x, label, device) -> tuple:
    """(median ms a forward, last output) of ``ROUNDS`` timed rounds after a warm one."""
    from light_unet_tpu_torch.bench import elapsed_ms

    out = {}

    def forward():
        out["y"] = fn(x)

    elapsed_ms(forward, device)  # warm
    ts = [elapsed_ms(forward, device, INNER) for _ in range(ROUNDS)]
    med = statistics.median(ts)
    print(f"  {label}: median {med:.2f} ms  (n={ROUNDS}x{INNER}, "
          f"spread {min(ts):.2f}-{max(ts):.2f})", flush=True)
    return med, out["y"]


def main(argv=None) -> int:
    import torch

    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.models.fused_forward import make_fused_apply
    from light_unet_tpu_torch.ops import block_kernel
    from light_unet_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batches", type=int, nargs="*", default=[96, 192])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {port_bench.device_line(dev)}", flush=True)

    model, plain = port_bench.seeded_model(port_bench.default_config(), dev)
    fused = make_fused_apply(model)
    gen = torch.Generator(device=dev)
    rows = []
    for batch in args.batches:
        x = torch.rand((batch, PATCH, PATCH, PATCH, 1), generator=gen.manual_seed(0), device=dev)
        print(f"batch {batch} x {PATCH}^3:", flush=True)
        with torch.no_grad():
            tp, yp = bench(plain, x, "plain (warm)", dev)
            launches = block_kernel.launches
            tf, yf = bench(fused, x, "fused (warm)", dev)
            tp2, _ = bench(plain, x, "plain (re)", dev)
            tf2, _ = bench(fused, x, "fused (re)", dev)
        launched = block_kernel.launches - launches
        plain_ms, fused_ms = statistics.median([tp, tp2]), statistics.median([tf, tf2])
        err = float((yp.float() - yf.float()).abs().max())
        print(f"  => plain {plain_ms:.2f} ms, fused {fused_ms:.2f} ms, speedup "
              f"{plain_ms / fused_ms:.2f}x, max|diff| {err:.3e}, block kernel launches "
              f"{launched}", flush=True)
        row = {"batch": batch, "patch": PATCH, "plain_ms": round(plain_ms, 4),
               "fused_ms": round(fused_ms, 4), "speedup": round(plain_ms / fused_ms, 3),
               "max_abs_diff": err, "block_launches": launched,
               "device": port_bench.device_line(dev)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if dev.type == "cuda" and launched == 0:
            raise RuntimeError("the fused forward did not launch the block kernel")
        if not err <= BAR:
            raise RuntimeError(f"plain and fused forwards differ by {err:.3e} > {BAR}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
