#!/usr/bin/env python3
"""Roofline of the PyTorch port's serving forward on one NVIDIA H100 (the
port of ``scripts/roofline.py``, at the H100's peaks).

For a batch of ``BATCH`` 48^3 patches in bf16 (``Config()``'s model,
seeded random weights): the analytic operations and bytes of the whole
forward (``models/cost.py:forward_cost``, the same count for every route),
``torch.utils.flop_counter.FlopCounterMode``'s count over the plain forward
beside it (in place of XLA's cost model), and per route the median time of
10 forwards (CUDA events), the achieved TFLOP/s and TB/s, the ridge point,
the roofline bound and the share of it reached; then the per-level table of
the encoder's residual blocks (``models/cost.py:analytic_levels``, the JAX
script's rows), and one JSON line per route.

Peaks: dense bf16 989 TFLOP/s and HBM3 3.35 TB/s (NVIDIA's data sheet for
the H100 SXM at its full 700 W; the rates behind ``PERF.md``'s kernel
bounds), printed beside nvidia-smi's name and power limit.

    python3 scripts/roofline_torch.py                              # the plain route
    python3 scripts/roofline_torch.py --route plain fused_block
    python3 scripts/roofline_torch.py --device cpu                 # the CPU (no device numbers)

``--route``: ``plain`` (the model's inference forward: the norm and
depthwise kernels beside the other convolutions, as the JAX script times
the lax forward) and ``fused_block`` (the YAML's gate: the block kernel).
It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

H100_BF16_FLOPS = 989e12
H100_HBM_BYTES = 3.35e12

BATCH = 96
PATCH = 48
TIMED = 10
ROUTES = {"plain": {}, "fused_block": {"fused_block": True}}


def plain_flop_count(cfg, batch: int) -> int:
    """``FlopCounterMode``'s total over the plain forward, on the meta device
    (shapes only: nothing is computed or allocated)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from light_unet_tpu_torch.models.unet3d import build_model

    with torch.device("meta"):
        model = build_model(cfg.model, torch.bfloat16, inference=True)
        x = torch.empty(batch, PATCH, PATCH, PATCH, 1)
    with FlopCounterMode(display=False) as counter:
        model(x)
    return int(counter.get_total_flops())


def time_route(route: str, batch: int, device) -> list:
    """Milliseconds of ``TIMED`` forwards of ``route`` after a warm one."""
    import torch

    from light_unet_tpu_torch import bench as port_bench

    cfg = port_bench.default_config()
    for k, v in ROUTES[route].items():
        setattr(cfg.tpu, k, v)
    _, apply_fn = port_bench.seeded_model(cfg, device)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand((batch, PATCH, PATCH, PATCH, 1), generator=gen, device=device)
    with torch.no_grad():
        port_bench.elapsed_ms(lambda: apply_fn(x), device)  # warm
        return [port_bench.elapsed_ms(lambda: apply_fn(x), device) for _ in range(TIMED)]


def main(argv=None) -> int:
    import torch

    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.models.cost import analytic_levels, forward_cost, forward_terms
    from light_unet_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--route", nargs="+", choices=sorted(ROUTES), default=["plain"])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    smi = port_bench.device_line(dev)
    cfg = port_bench.default_config()

    flops, bytes_ = forward_cost(cfg.model, BATCH, PATCH, torch.bfloat16)
    counted = plain_flop_count(cfg, BATCH)
    ridge = H100_BF16_FLOPS / H100_HBM_BYTES
    bound_s = max(flops / H100_BF16_FLOPS, bytes_ / H100_HBM_BYTES)
    bound_by = "operations" if flops / H100_BF16_FLOPS >= bytes_ / H100_HBM_BYTES else "bytes"
    print(f"device: {smi}")
    print(f"peaks: H100 SXM dense bf16 {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s, HBM3 "
          f"{H100_HBM_BYTES / 1e12:.2f} TB/s (data sheet, 700 W); ridge {ridge:.0f} FLOP/byte")
    print(f"forward {BATCH}x{PATCH}^3 bf16, analytic: {flops / 1e9:.2f} GFLOP, "
          f"{bytes_ / 1e6:.1f} MB; FlopCounterMode over the plain forward: "
          f"{counted / 1e9:.2f} GFLOP")
    ai = flops / bytes_
    print(f"arithmetic intensity {ai:.1f} FLOP/byte -> {bound_by}-bound; roofline bound "
          f"{bound_s * 1e3:.3f} ms")
    print("per op of the forward (analytic):")
    for r in forward_terms(cfg.model, BATCH, PATCH, torch.bfloat16):
        print(f"  {r['op']:>12} level {r['level']}: {r['flops'] / 1e9:8.2f} GFLOP "
              f"{r['bytes'] / 1e6:8.1f} MB")

    on_card = dev.type == "cuda"  # a CPU time is no device number: no rates, no shares
    lines = []
    for route in args.route:
        times = time_route(route, BATCH, dev)
        t_med = statistics.median(times) / 1e3
        line = {"route": route, "batch": BATCH, "patch": PATCH,
                "forward_ms_median": round(t_med * 1e3, 4), "forward_ms_min": round(min(times), 4),
                "forward_ms_max": round(max(times), 4), "gflop": round(flops / 1e9, 4),
                "mbytes": round(bytes_ / 1e6, 4), "flop_counter_gflop": round(counted / 1e9, 4),
                "achieved_tflops": round(flops / t_med / 1e12, 4) if on_card else None,
                "achieved_tbps": round(bytes_ / t_med / 1e12, 4) if on_card else None,
                "ridge_flop_per_byte": round(ridge, 2), "bound_ms": round(bound_s * 1e3, 4),
                "bound_by": bound_by,
                "roofline_pct": round(100 * bound_s / t_med, 3) if on_card else None,
                "device": smi}
        print(f"[{route}] median {t_med * 1e3:.2f} ms (min {min(times):.2f} / max "
              f"{max(times):.2f} over {TIMED}) on {smi}", flush=True)
        if on_card:
            print(f"  achieved {line['achieved_tflops']:.3f} TFLOP/s "
                  f"({100 * flops / t_med / H100_BF16_FLOPS:.2f}% of bf16 peak), "
                  f"{line['achieved_tbps']:.3f} TB/s ({100 * bytes_ / t_med / H100_HBM_BYTES:.1f}% "
                  f"of HBM peak); {line['roofline_pct']:.1f}% of roofline", flush=True)
        lines.append(line)

    print("\nper-encoder-level analytic (residual blocks, optimistic fusion):")
    print(f"{'lvl':>3} {'C':>4} {'side':>5} {'GFLOP':>8} {'MB':>8} {'AI':>7}  bound")
    for r in analytic_levels(batch=BATCH, d=PATCH):
        bound = "BW" if r["arithmetic_intensity"] < ridge else "TC"
        print(f"{r['level']:>3} {r['channels']:>4} {r['spatial']:>5} "
              f"{r['gflops']:>8.2f} {r['mbytes']:>8.1f} "
              f"{r['arithmetic_intensity']:>7.1f}  {bound}")
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
