#!/usr/bin/env python3
"""Drive the PyTorch port (``light_unet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check (one card, about 5-10 minutes)
    python3 chip_smoke.py --quick    # build + kernel checks at a small batch only
    python3 chip_smoke.py --profile  # also trace fused_block serving, the fused pipeline, 20 training steps

Phases:
1. device line: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``light_unet_tpu_torch/csrc`` (``ops/_build.py``);
3. the fused InstanceNorm + LeakyReLU kernel at the four serving shapes,
   B = 192, bf16 and f32, slopes 0.01 and 1.0, held against its plain
   version (f32 <= 1e-4 abs, bf16 <= 2e-2 abs), two calls on one input
   bit-identical, and timed (CUDA events over 10 calls) beside it and
   beside ``F.instance_norm`` + ``F.leaky_relu``; its device time per call
   and device launches per call (must be 1) from torch.profiler, and its
   plan (chunks per sample, CTAs per SM, samples per round, shared bytes);
4. the fused residual-block kernel at the 8 block shapes of a 48^3 patch,
   B = 192 in bf16 and B = 16 in f32, held against its plain version
   (f32 <= 5e-5, bf16 <= 2e-2, relative to max(|ref|, 1)) and timed, with
   the device time of each of its three launches (conv1, conv2, out) from
   torch.profiler and the tile each conv launch took;
5. raw -> preprocess: 4 raw SUV-like 144x144x272 phantoms with labels at
   4 mm (body ellipsoid with cold pockets, a scanner bed, air specks, hot
   spheres; seeded) go through the port's
   ``split_dataset`` (ratios 0/1/0: all to val) and ``run_preprocess`` on
   the card; one case's processed image, body mask and voxel counts are
   held against the port's own CPU run of ``normalize_and_body_mask``
   (mask and counts equal, normalized <= 1e-6 abs); logged: seconds per
   case, one case's time split serially (decode, percentiles, device pass,
   NIfTI writes), CUDA-event ms of the body-mask chain and
   ``label_propagate`` rounds per volume;
6. the serving path: a seeded ``best_model.pth`` and the preprocessed tree
   (its body masks included) go through ``Inferencer.infer_split`` three
   times: ``tpu.fused_block`` (the block kernel's launch count must rise,
   the plain block must never run), ``tpu.use_pallas`` (the norm kernel's
   count must rise), and neither gate (the plain model), whose prob maps
   the first two must match within 5e-2 abs;
7. the fused per-volume pipeline: ``FusedVolumePipeline`` over the 4 raw
   volumes (uint16 upload and fetch, sparse fetch, decode and prepare on a
   worker thread) under the same three gates with the same launch-count
   bars and the same 5e-2 bar; each map must be exactly 0 wherever
   ``body_mask_core`` of the same dequantized volume on the card is 0;
   logged: vol/s, peak device memory, and under ``fused_block`` one
   volume's time split serially (decode, prepare, dispatch, fetch);
8. the train stage: the port ``Trainer`` at the full ``configs/unet_fl70.yaml``
   model (bf16, batch 2, 48^3, device corpus, ``steps_per_dispatch`` 4,
   separable augmentation, augmentation and dropout on, ``tpu.use_pallas``
   on) for 2 epochs on 2 of the processed phantoms, validating on the other
   2; checks: finite losses, parameters changed, checkpoints and
   ``best_model.pth`` written, no norm- or block-kernel launch inside the
   training steps and norm-kernel launches in validation, ``resume`` in a
   fresh trainer restores the epoch and the optimizer step, and one float32
   step (augmentation and dropout off, TF32 off) on the card within 1e-4
   relative of the same step on the CPU; logged: ms per step, steps/s,
   peak device memory, corpus bytes, epoch losses, skipped steps,
   validation seconds per case, device-sweep / escalated / host counts;
9. the evaluate stage: the trained ``best_model.pth`` serves the 2
   validation phantoms (``Inferencer``, ``fused_block``), then
   ``run_evaluate`` on the card; each case's per-threshold counts equal the
   host path's (``use_device=False``) on the same maps, DSC within 1e-9,
   and so do those of a device sweep with 16x the component cap on every
   served map (a briefly trained model's maps are speckled); logged:
   evaluate seconds per case, how many cases the stage's own sweep took,
   and device-sweep ms per threshold;
10. one JSON line of per-kernel numbers (launches summed over the runs under
   the kernel's gate: serving, fused pipeline, the training phase's
   validation and the evaluate phase's serving, each logged), the
   ``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  Float32 comparisons run with TF32 off.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12            # float32 outside the tensor cores
BF16_TENSOR_FLOPS = 989e12   # dense bf16 tensor cores
SERVING_SHAPE = (144, 144, 272)  # whole-body volume at 4 mm (the bench's VOLUME_SHAPE)
N_CASES = 4

# the serving configuration of configs/unet_fl70.yaml, with the block kernel's gate on
SERVING = {
    "data": {
        "patch_size": [48, 48, 48],
        "bbox_expansion_voxels": 3,
        "body_mask": {"enabled": True, "apply_to_inference": True},
        "volume_threshold": {"inference_cc": 0.5},
    },
    "model": {
        "encoder_channels": [16, 32, 64, 128], "output_channels": 1, "groups": 8,
        "use_depthwise_separable": True, "use_grouped_conv": True,
        "use_dropout": True, "dropout_p": 0.1,
    },
    "tpu": {
        "compute_dtype": "bfloat16", "transfer_dtype": "uint16", "fetch_dtype": "uint16",
        "sparse_fetch": True, "sparse_fetch_frac": 1.0, "patch_batch": 192, "z_bucket": 48,
        "mesh_shape": None, "use_pallas": False, "fused_block": True,
    },
    "validation": {"default_threshold": 0.3},
}

# (name, D=H=W, Cin, C) of the 8 residual blocks at a 48^3 patch
BLOCKS = [
    ("init_conv", 48, 1, 16), ("down1", 24, 16, 32), ("down2", 12, 32, 64),
    ("down3", 6, 64, 128), ("bottleneck", 6, 128, 128), ("up1", 12, 128, 64),
    ("up2", 24, 64, 32), ("up3", 48, 32, 16),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def nvidia_smi_clocks() -> str:
    """SM clock now and at most, memory clock, power draw and temperature
    (only logged: if nvidia-smi refuses the query, its message is printed)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return (res.stdout.strip() or res.stderr.strip()).splitlines()[0]


def kernel_name(symbol: str) -> str:
    """A ptxas entry's Itanium-mangled name as ``name<args>`` (enough of the
    grammar for this repo's kernels: nested names, int/bool literals,
    ``float`` and named types as template arguments)."""
    i, name = symbol.index("_ZN") + 3, ""

    def ident(k):
        j = k
        while symbol[j].isdigit():
            j += 1
        n = int(symbol[k:j])
        return symbol[j:j + n], j + n

    while symbol[i].isdigit():
        name, i = ident(i)
    args = []
    if symbol[i] == "I":
        i += 1
        while symbol[i] != "E":
            if symbol[i] == "L":
                j = symbol.index("E", i)
                args.append(symbol[i + 2:j])
                i = j + 1
            elif symbol[i].isdigit():
                arg, i = ident(i)
                args.append(arg)
            else:
                args.append({"f": "float"}.get(symbol[i], symbol[i]))
                i += 1
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_usage(text: str) -> list:
    """(kernel, "N registers, S bytes spill stores") per entry of an
    ``nvcc -Xptxas -v`` log."""
    out, kernel, spill = [], None, "?"
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
        elif kernel and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif kernel and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append((kernel, f"{regs} registers, {spill} bytes spill stores"))
            kernel = None
    return out


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILE_TRIES = 3


def device_events(fn, calls: int, complete) -> list:
    """Device events (kernels, memsets, copies) of ``calls`` calls of ``fn``
    from torch.profiler, as ``key_averages()`` entries.  A session whose
    events fail ``complete(events)`` is traced again, up to PROFILE_TRIES
    times: the profiler on the card's machine now and then drops a session's
    kernels.  Raises with what the last session saw."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if complete(events):
            return events
    raise AssertionError(f"profiler sessions incomplete in {PROFILE_TRIES} tries: "
                         f"{[(e.key, e.count) for e in events]}")


def device_launches(fn, match: str, calls: int = 5) -> tuple:
    """(kernel name, device ms per call, device operations per call) of
    ``fn`` from torch.profiler over ``calls`` calls: every kernel, memset and
    copy the device ran is counted, and the one kernel whose name holds
    ``match`` (seen ``calls`` times) is timed."""
    events = device_events(
        fn, calls, lambda ev: [e.count for e in ev if match in e.key] == [calls])
    hit = next(e for e in events if match in e.key)
    per_call = sum(e.count for e in events) / calls
    return hit.key, hit.self_device_time_total / 1e3 / calls, per_call


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call of ``fn`` issued back to back, not waiting for the
    device (the rate at which the host can enqueue calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def norm_phase(batch: int, gen, timed: bool):
    """K2 against its plain version; returns per-shape bf16 rows and the max errors."""
    import torch
    import torch.nn.functional as F

    from light_unet_tpu_torch.ops import norm_kernel as nk

    rows, max_err = {}, {}
    for d, c in [(48, 16), (24, 32), (12, 64), (6, 128)]:
        for dtype, bar in [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)]:
            x = (torch.randn((batch, d, d, d, c), generator=gen, device="cuda") * 3 + 1).to(dtype)
            # scales near 0.5 keep |y| < 4, where one bf16 ulp is below the bar
            s = 0.5 + 0.05 * torch.randn(c, generator=gen, device="cuda")
            b = 0.1 * torch.randn(c, generator=gen, device="cuda")
            for slope in (0.01, 1.0):
                got = nk.fused_instance_norm_leaky_relu(x, s, b, negative_slope=slope)
                want = nk.reference_instance_norm_leaky_relu(x, s, b, negative_slope=slope)
                again = nk.fused_instance_norm_leaky_relu(x, s, b, negative_slope=slope)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                if not err <= bar:
                    raise AssertionError(f"norm kernel {d}^3x{c} {dtype} slope {slope}: "
                                         f"max abs err {err} > {bar}")
                if not torch.equal(got, again):
                    raise AssertionError(f"norm kernel {d}^3x{c} {dtype} slope {slope}: "
                                         f"two calls on one input differ")
                max_err[dtype] = max(max_err.get(dtype, 0.0), err)
            plan = nk.kernel_plan(tuple(x.shape), dtype)
            log(f"  norm {d}^3 x {c} {str(dtype)[6:]} B={batch}: bit-identical twice; plan: "
                f"k {plan['k']} chunks of {plan['rows_per_chunk']} rows, {plan['ctas_per_sm']} "
                f"CTAs/SM, {plan['groups']} samples/round, {plan['smem']} smem bytes, "
                f"{plan['threads']} threads, streams {plan['streams']}")
            if dtype != torch.bfloat16 or not timed:
                continue
            xv = x.permute(0, 4, 1, 2, 3)
            ms = cuda_ms(lambda: nk.fused_instance_norm_leaky_relu(x, s, b))
            name, dev_ms, per_call = device_launches(
                lambda: nk.fused_instance_norm_leaky_relu(x, s, b), "in_leaky")
            enqueue_us = host_us(lambda: nk.fused_instance_norm_leaky_relu(x, s, b))
            if per_call != 1:
                raise AssertionError(f"norm kernel {d}^3x{c}: {per_call} device launches per call")
            plain_ms = cuda_ms(lambda: nk.reference_instance_norm_leaky_relu(x, s, b))
            lib_ms = cuda_ms(lambda: F.leaky_relu(
                F.instance_norm(xv, weight=s.to(dtype), bias=b.to(dtype), eps=nk.IN_EPS), 0.01))
            nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 6 * x.numel() / F32_FLOPS * 1e3
            rows[(d, c)] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                                bytes_ms=bytes_ms, ops_ms=ops_ms)
            log(f"    kernel {ms:.4f} ms (CUDA events), {dev_ms:.4f} ms device ({name}, "
                f"{per_call:g} launch per call), host {enqueue_us:.1f} us per call, "
                f"plain {plain_ms:.3f} ms, "
                f"F.instance_norm+leaky {lib_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms")
            del x, xv, got, want, again
    return rows, max_err


def block_ops(d: int, cin: int, c: int) -> tuple:
    """(CUDA-core flops, tensor-core-able flops) per sample of one block."""
    s = d ** 3
    dw = 2 * 27 * (cin + c) * s
    pw = 2 * (cin * c + c * c + (cin * c if cin != c else 0)) * s
    norms = 12 * c * s
    return dw + norms, pw


def launch_split(fn, calls: int = 3) -> dict:
    """Device ms per call of each of K1's launches (conv1, conv2, out), by
    kernel name, from torch.profiler over ``calls`` calls of ``fn``."""
    def roles(events):  # the stats memset is not a launch of the kernel
        out = {}
        for e in events:
            m = re.search(r"(conv1|conv2|block_out)\w*(<[^>]*>)?", e.key)
            if m:
                out[{"block_out": "out"}.get(m.group(1), m.group(1))] = (m.group(0), e)
        return out

    events = device_events(fn, calls, lambda ev: set(roles(ev)) == {"conv1", "conv2", "out"})
    return {role: (name, e.self_device_time_total / 1e3 / calls)
            for role, (name, e) in roles(events).items()}


def block_phase(model, batch: int, bar: float, gen, timed: bool):
    """K1 against its plain version at the 8 block shapes of a 48^3 patch,
    in the model's compute dtype."""
    import torch

    from light_unet_tpu_torch.ops import block_kernel as bk

    blocks = {
        "init_conv": model.init_conv, "down1": model.down1.res_block,
        "down2": model.down2.res_block, "down3": model.down3.res_block,
        "bottleneck": model.bottleneck, "up1": model.up1.res_block,
        "up2": model.up2.res_block, "up3": model.up3.res_block,
    }
    dtype = model.compute_dtype
    rows, max_err = {}, 0.0
    for name, d, cin, c in BLOCKS:
        blk = blocks[name]
        x = torch.randn((batch, d, d, d, cin), generator=gen, device="cuda").to(dtype)
        got = bk.fused_residual_block(x, blk)
        want = bk.reference_residual_block(x, blk)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(want.float().abs().max().item(), 1.0)
        if not err / scale <= bar:
            raise AssertionError(f"block kernel {name} {dtype} B={batch}: "
                                 f"max rel err {err / scale} > {bar}")
        max_err = max(max_err, err)
        if timed:
            ms = cuda_ms(lambda: bk.fused_residual_block(x, blk), iters=5, warmup=1)
            plain_ms = cuda_ms(lambda: bk.reference_residual_block(x, blk), iters=5,
                               warmup=1)
            nbytes = batch * d ** 3 * (cin + c) * x.element_size()
            core, tensor = block_ops(d, cin, c)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = batch * (core / F32_FLOPS + tensor / BF16_TENSOR_FLOPS) * 1e3
            rows[name] = dict(ms=ms, plain_ms=plain_ms, bytes_ms=bytes_ms, ops_ms=ops_ms)
            log(f"  block {name} {d}^3 {cin}->{c} bf16 B={batch}: kernel {ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.3f} ms "
                f"({'bytes' if bytes_ms >= ops_ms else 'operations'})")
            plan = bk.kernel_plan(tuple(x.shape), c, dtype)
            split = launch_split(lambda: bk.fused_residual_block(x, blk))
            log(f"    launches: " + ", ".join(f"{role} {kname} {t:.3f} ms"
                                              for role, (kname, t) in split.items())
                + "; tiles (TD, TH, TW, smem bytes): "
                + ", ".join(f"{k} {v}" for k, v in plan.items()))
        del x, got, want
    return rows, max_err


def write_raw_cases(raw_dir: Path, seed: int) -> list:
    """Raw whole-body PET phantoms at 4 mm with lesion labels, seeded:
    SUV-like intensities (air near 0, a textured body ellipsoid around
    1-2.5, cold pockets inside it that the closing fills, a scanner-bed slab
    and specks of air noise that the largest component drops, hot spheres of
    SUV 6-15 as lesions)."""
    from light_unet_tpu_torch.utils import nifti

    rng = np.random.default_rng(seed)
    for sub in ("images", "labels"):
        (raw_dir / sub).mkdir(parents=True, exist_ok=True)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    shape = SERVING_SHAPE
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    body = ((zz - shape[0] / 2) ** 2 / (0.42 * shape[0]) ** 2
            + (yy - shape[1] / 2) ** 2 / (0.36 * shape[1]) ** 2
            + (xx - shape[2] / 2) ** 2 / (0.45 * shape[2]) ** 2) <= 1.0
    # the bed lies 12 voxels below the body, more than the closing (radius 5)
    # bridges, so the largest component drops it
    bed = (yy >= int(0.95 * shape[1])) & (yy < int(0.95 * shape[1]) + 2) & (zz >= 8) & (xx >= 8)
    ids = [f"{i + 1:04d}" for i in range(N_CASES)]
    for cid in ids:
        img = body * (1.0 + 1.5 * rng.random(shape, dtype=np.float32))
        img += 0.05 * rng.random(shape, dtype=np.float32)
        img[np.broadcast_to(bed, shape)] = 0.4
        for _ in range(6):  # cold pockets of radius 2
            c = [int(rng.integers(int(s * 0.3), int(s * 0.7))) for s in shape]
            img[(zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= 4] = 0.01
        specks = rng.random(shape) < 2e-5
        img[specks & ~body] = 0.5
        label = np.zeros(shape, np.uint8)
        for _ in range(4):
            c = [int(rng.integers(int(s * 0.3), int(s * 0.7))) for s in shape]
            r = int(rng.integers(2, 5))
            sphere = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r * r
            img[sphere] = rng.uniform(6.0, 15.0)
            label[sphere] = 1
        nifti.save(nifti.Nifti1Image(img.astype(np.float32), aff),
                   raw_dir / "images" / f"{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(label, aff), raw_dir / "labels" / f"{cid}.nii.gz")
    return ids


def ccl_rounds(mask) -> int:
    """Rounds ``ops/ccl.label_propagate`` takes on ``mask``: its sweeps,
    counted here, with the labels held equal to its own."""
    import torch

    from light_unet_tpu_torch.ops import ccl

    n = mask.numel()
    labels = torch.arange(1, n + 1, dtype=torch.int64, device=mask.device).reshape(mask.shape)
    labels = labels * (mask > 0)
    rounds = 0
    while True:
        prev, rounds = labels, rounds + 1
        for axis in range(3):
            labels = ccl._axis_sweep(labels, axis, False, n + 1)
            labels = ccl._axis_sweep(labels, axis, True, n + 1)
        if torch.equal(labels, prev):
            break
    if not torch.equal(labels, ccl.label_propagate(mask)):
        raise AssertionError("counted CCL sweeps disagree with label_propagate")
    return rounds


def preprocess_phase(tmp: Path, config: dict) -> tuple:
    """Raw phantoms -> split -> ``run_preprocess`` on the card; one case held
    against the CPU.  Returns (processed dir, val split file, raw image paths)."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops.body_mask import body_mask_core, body_mask_settings
    from light_unet_tpu_torch.ops.fused import normalize_and_body_mask
    from light_unet_tpu_torch.ops.intensity import compute_clip_values, pad_volume
    from light_unet_tpu_torch.ops.morphology import binary_closing
    from light_unet_tpu_torch.ops.sliding_window import _valid_mask
    from light_unet_tpu_torch.pipeline.preprocess import run_preprocess
    from light_unet_tpu_torch.pipeline.split import split_dataset
    from light_unet_tpu_torch.utils import nifti

    raw, splits, processed = tmp / "raw", tmp / "splits", tmp / "processed"
    t0 = time.perf_counter()
    ids = write_raw_cases(raw, seed=0)
    log(f"[preprocess] {N_CASES} raw cases {SERVING_SHAPE} written in "
        f"{time.perf_counter() - t0:.1f} s")
    manifest = split_dataset(raw, splits, 0.0, 1.0, 0.0, seed=42)
    if manifest["splits"]["val"] != ids:
        raise AssertionError(f"split put {manifest['split_sizes']} cases, not all 4 in val")
    cfg = Config.from_dict(config)
    summaries = run_preprocess(cfg, raw, processed, splits, split="val", device="cuda")
    val = summaries["val"]
    if val["successful"] != N_CASES or val["failed"]:
        raise AssertionError(f"preprocess failed: {val['failed_cases']}")
    log(f"  run_preprocess on the card: {val['seconds'] / N_CASES:.2f} s per case "
        f"(decode, percentiles, device pass, NIfTI writes)")

    # one case against the port's CPU run of the same pass
    cid = ids[0]
    image = nifti.load(raw / f"images/{cid}_0000.nii.gz").get_fdata(np.float32)
    t0 = time.perf_counter()
    norm_cpu, mask_cpu, imeta, mmeta = normalize_and_body_mask(
        image, cfg.data.intensity, cfg.data.body_mask, z_bucket=cfg.tpu.z_bucket, device="cpu")
    cpu_s = time.perf_counter() - t0
    norm_card = nifti.load(processed / f"images/{cid}_0000.nii.gz").get_fdata(np.float32)
    mask_card = nifti.load(processed / f"body_masks/{cid}.nii.gz").get_fdata(np.float32) > 0.5
    meta = json.loads((processed / f"metadata/{cid}.json").read_text())
    err = float(np.abs(norm_card - norm_cpu).max())
    if not (np.array_equal(mask_card, mask_cpu) and meta["body_mask"] == mmeta
            and meta["clip_values"] == imeta["clip_values"] and err <= 1e-6):
        raise AssertionError(f"case {cid}: card and CPU preprocess differ (normalized {err}, "
                             f"counts {meta['body_mask']['voxel_counts']} vs "
                             f"{mmeta['voxel_counts']})")
    log(f"  case {cid} vs the CPU run ({cpu_s:.1f} s): mask equal, counts equal "
        f"{mmeta['voxel_counts']}, normalized max abs diff {err:.1e} (bar 1e-6)")

    # where one case's time goes, serially
    t0 = time.perf_counter()
    image = nifti.load(raw / f"images/{cid}_0000.nii.gz").get_fdata(np.float32)
    t1 = time.perf_counter()
    compute_clip_values(image, cfg.data.intensity.clip_percentile_low,
                        cfg.data.intensity.clip_percentile_high)
    t2 = time.perf_counter()
    norm, mask, _, _ = normalize_and_body_mask(image, cfg.data.intensity, cfg.data.body_mask,
                                               z_bucket=cfg.tpu.z_bucket, device="cuda")
    t3 = time.perf_counter()
    nifti.save(nifti.Nifti1Image(norm, np.diag([4.0, 4.0, 4.0, 1.0])), tmp / "phase_probe.nii.gz")
    nifti.save(nifti.Nifti1Image(mask.astype(np.uint8), np.diag([4.0, 4.0, 4.0, 1.0])),
               tmp / "phase_probe_mask.nii.gz")
    t4 = time.perf_counter()
    log(f"  one case, serially: decode {t1 - t0:.3f} s, percentiles {t2 - t1:.3f} s, "
        f"device pass (upload, normalize, body mask, fetch) {t3 - t2 - (t2 - t1):.3f} s, "
        f"NIfTI writes (image + mask) {t4 - t3:.3f} s")

    # the body-mask chain alone on the card, and its CCL rounds, per volume
    settings = body_mask_settings(cfg.data.body_mask)
    for cid in ids:
        norm = nifti.load(processed / f"images/{cid}_0000.nii.gz").get_fdata(np.float32)
        padded = torch.from_numpy(pad_volume(norm, cfg.tpu.z_bucket)).cuda()
        valid = _valid_mask(padded.shape, norm.shape, padded.device)
        ms = cuda_ms(lambda: body_mask_core(padded, valid, *settings), iters=3, warmup=1)
        closed = binary_closing((padded > settings[0]).float() * valid, settings[1], valid)
        log(f"  body-mask chain {tuple(padded.shape)}: {ms:.2f} ms (CUDA events), "
            f"label_propagate {ccl_rounds(closed)} rounds, case {cid}")
    return processed, splits / "val_list.txt", [raw / f"images/{i}_0000.nii.gz" for i in ids]


GATES = [("fused_block", {"fused_block": True, "use_pallas": False}),
         ("use_pallas", {"fused_block": False, "use_pallas": True}),
         ("plain", {"fused_block": False, "use_pallas": False})]


def check_gates(counts: dict, what: str) -> None:
    """The launch-count bars of the three gated runs."""
    if counts["fused_block"]["block"] == 0 or counts["fused_block"]["plain_block"] != 0:
        raise AssertionError(f"fused_block {what} did not go through the block kernel: "
                             f"{counts['fused_block']}")
    if counts["use_pallas"]["norm"] == 0:
        raise AssertionError(f"use_pallas {what} did not go through the norm kernel: "
                             f"{counts['use_pallas']}")
    if counts["plain"] != dict(block=0, plain_block=0, norm=0):
        raise AssertionError(f"plain {what} launched a kernel: {counts['plain']}")


def check_against_plain(runs: dict, what: str) -> None:
    for name in ("fused_block", "use_pallas"):
        err = max(float(np.abs(runs[name][c] - runs["plain"][c]).max()) for c in runs["plain"])
        log(f"  {name} vs plain model ({what}): max abs prob diff {err:.3e} (bar 5e-2)")
        if not err <= 5e-2:
            raise AssertionError(f"{name} {what} maps differ from the plain model by {err}")


def fused_run(config, state: dict, paths: list, profile: bool = False):
    """``FusedVolumePipeline`` over raw volumes, decode and prepare on a
    worker thread; returns (vol/s, peak bytes, {case: map}, {case: prepared})."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from light_unet_tpu_torch.models.fused_forward import make_fused_apply
    from light_unet_tpu_torch.models.unet3d import build_model
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
    from light_unet_tpu_torch.utils import nifti

    model = build_model(config.model, torch.bfloat16, inference=True,
                        use_pallas=config.tpu.use_pallas)
    model.load_state_dict(state, strict=True)
    model = model.cuda().eval()
    apply_fn = make_fused_apply(model) if config.tpu.fused_block else model
    pipe = FusedVolumePipeline(apply_fn, config, patch_batch=config.tpu.patch_batch, device="cuda")
    preps = {}

    def load_and_prepare(path):
        prep = pipe.prepare(nifti.load(path).get_fdata(np.float32))
        preps[path.name.split("_")[0]] = prep
        return prep

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    maps = []
    with prof if profile else contextlib.nullcontext():
        t0 = time.perf_counter()
        pending = None
        with ThreadPoolExecutor(max_workers=2) as pool:
            for prep in pool.map(load_and_prepare, paths):
                dispatched = pipe.dispatch(prep)
                if pending is not None:
                    maps.append(pipe.fetch(pending))
                pending = dispatched
            maps.append(pipe.fetch(pending))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if profile:
        report_profile(prof, seconds)
    out = {p.name.split("_")[0]: m for p, m in zip(paths, maps)}
    for cid, m in out.items():
        if m.shape != SERVING_SHAPE or not np.isfinite(m).all() or not m.max() > 0:
            raise AssertionError(f"bad fused map {cid}: {m.shape}, max {m.max()}")
    return len(paths) / seconds, torch.cuda.max_memory_allocated(), out, preps, pipe


def fused_phases(pipe, path: Path) -> None:
    """One volume through ``pipe`` serially: decode, prepare (host work and
    upload), dispatch (enqueue), fetch (device work and copy back)."""
    import torch

    from light_unet_tpu_torch.utils import nifti

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image = nifti.load(path).get_fdata(np.float32)
    t1 = time.perf_counter()
    prep = pipe.prepare(image)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    dispatched = pipe.dispatch(prep)
    t3 = time.perf_counter()
    pipe.fetch(dispatched)
    t4 = time.perf_counter()
    log(f"  one volume, serially: decode {t1 - t0:.3f} s, prepare {t2 - t1:.3f} s, "
        f"dispatch {t3 - t2:.3f} s, fetch (device work + copy) {t4 - t3:.3f} s")


def check_zero_outside_body(config, maps: dict, preps: dict) -> None:
    """Each map is exactly 0 wherever ``body_mask_core`` of the same
    dequantized volume, on the card, is 0."""
    import torch

    from light_unet_tpu_torch.ops.body_mask import body_mask_core, body_mask_settings
    from light_unet_tpu_torch.ops.fused import normalize_volume

    rng = config.data.intensity.normalization_range
    for cid, m in maps.items():
        volume, shape, lo, hi = preps[cid][:4]
        with torch.no_grad():
            norm, valid = normalize_volume(volume, shape, lo, hi, range_min=float(rng[0]),
                                           range_max=float(rng[1]), dequant=True)
            body = body_mask_core(norm, valid, *body_mask_settings(config.data.body_mask))[0]
        body = body.cpu().numpy()[: shape[0], : shape[1], : shape[2]] > 0.5
        if not body.any() or body.all() or np.any(m[~body] != 0):
            raise AssertionError(f"case {cid}: map not zero outside the body mask "
                                 f"({int(np.count_nonzero(m[~body]))} voxels)")


def report_profile(prof, wall_s: float) -> None:
    """Device time by kernel and the share of the wall time the device was busy."""
    import torch

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  [profile] wall {wall_s * 1e3:.0f} ms, device busy {busy_ms:.0f} ms "
        f"({100 * busy_ms / (wall_s * 1e3):.1f} %); device time by kernel:")
    for e in kernels[:12]:
        log(f"    {e.self_device_time_total / 1e3:9.1f} ms  x{e.count:<5d} {e.key[:90]}")


def serve(config: dict, model_path: Path, data_dir: Path, split: Path, workdir: Path,
          profile: bool = False):
    """One ``infer_split`` run; returns (vol/s, {case: prob map})."""
    import torch

    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.utils import nifti

    inf = Inferencer(config, model_path, workdir=str(workdir), device="cuda")
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof if profile else contextlib.nullcontext():
        t0 = time.perf_counter()
        result = inf.infer_split(split, data_dir)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    if profile:
        report_profile(prof, seconds)
    if result["failed"] or result["successful"] != N_CASES:
        raise AssertionError(f"serving run failed: {result}")
    maps = {}
    for p in sorted((workdir / "inference/prob_maps").glob("*_prob.nii.gz")):
        cid = p.name.split("_")[0]
        if not (workdir / f"inference/bboxes/{cid}_bboxes.json").exists():
            raise AssertionError(f"missing bboxes for {cid}")
        prob = nifti.load(p).get_fdata(np.float32)
        if prob.shape != SERVING_SHAPE or not np.isfinite(prob).all():
            raise AssertionError(f"bad prob map {p.name}: {prob.shape}")
        maps[cid] = prob
    if len(maps) != N_CASES:
        raise AssertionError(f"expected {N_CASES} prob maps, found {len(maps)}")
    return N_CASES / seconds, maps


def train_config(data_dir: Path, splits: Path, **over) -> dict:
    """``configs/unet_fl70.yaml`` (the port's defaults are that file) with the
    smoke's paths, 2 epochs, a checkpoint every epoch, the norm kernel's gate
    on, and the JAX package's convergence-test rate (3e-3, no warmup:
    ``tests/integration/test_convergence.py``) so that 2 short epochs move
    the model."""
    cfg = {
        "data_dir": str(data_dir), "splits_dir": str(splits),
        "training": {"epochs": 2, "learning_rate": 3e-3, "use_warmup": False},
        "output": {"save_every_n_epochs": 1},
        "tpu": {"use_pallas": True, "fused_block": False},
    }
    for key, value in over.items():
        cfg.setdefault(key, {}).update(value)
    return cfg


def write_splits(splits: Path, train: list, val: list) -> None:
    splits.mkdir(parents=True, exist_ok=True)
    for name, ids in (("train", train), ("val", val), ("test", [])):
        (splits / f"{name}_list.txt").write_text("".join(f"{i}\n" for i in ids))


def first_step_agreement(data_dir: Path, splits: Path, workdir: Path) -> float:
    """One float32 training step (augmentation and dropout off, TF32 off) on
    the card and on the CPU from the same weights and corners; returns the
    relative loss difference."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import Trainer

    off = {k: {"enabled": False} for k in ("random_flip", "random_rotation", "random_scale",
                                          "intensity_shift", "gaussian_noise")}
    cfg = train_config(data_dir, splits, tpu={"compute_dtype": "float32", "use_pallas": False},
                       model={"use_dropout": False}, augmentation=off)
    card = Trainer(Config.from_dict(cfg), workdir=str(workdir / "card"), device="cuda")
    cpu = Trainer(Config.from_dict(cfg), workdir=str(workdir / "cpu"), device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    corners = card.train_loader.sample_corners()
    for t in (card, cpu):
        t.model.train()
        t._set_lr(t.scheduler.current_lr())
    t0 = time.perf_counter()
    loss_card = float(card._step_on_batch(corners))
    t1 = time.perf_counter()
    loss_cpu = float(cpu._step_on_batch(corners))
    t2 = time.perf_counter()
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    log(f"  first float32 step: card loss {loss_card:.8f} ({(t1 - t0) * 1e3:.0f} ms with its "
        f"first launches), CPU loss {loss_cpu:.8f} ({t2 - t1:.1f} s), relative diff {rel:.2e} "
        f"(bar 1e-4)")
    if not (np.isfinite(loss_card) and rel <= 1e-4):
        raise AssertionError(f"card and CPU first steps differ: {loss_card} vs {loss_cpu}")
    for t in (card, cpu):
        t.writer.close()
    return rel


def profile_steps(trainer, chains: int = 5) -> None:
    """torch.profiler over ``chains`` K-step dispatch units of training
    (after the run, on the trained state): device busy share and device time
    by kernel."""
    import torch

    import itertools

    units = list(itertools.islice(trainer._dispatch_units(trainer.train_loader), chains + 1))
    trainer.model.train()
    trainer._step_on_batch(units.pop(0))
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    steps = 0
    with prof:
        t0 = time.perf_counter()
        for unit in units:
            trainer._step_on_batch(unit)
            steps += trainer._unit_steps(unit)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    trainer._epoch_oks.clear()
    log(f"  [profile] {steps} training steps: {seconds / steps * 1e3:.2f} ms/step profiled")
    report_profile(prof, seconds)


def train_phase(tmp: Path, data_dir: Path, ids: list, smi: str, profile: bool = False) -> tuple:
    """The port ``Trainer`` on the card; returns (best model path, val split,
    norm-kernel launches in validation)."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import Trainer
    from light_unet_tpu_torch.ops import block_kernel, norm_kernel

    splits, work = tmp / "train_splits", tmp / "train"
    write_splits(splits, ids[:2], ids[2:])
    cfg = Config.from_dict(train_config(data_dir, splits))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, workdir=str(work), device="cuda")
    steps = len(trainer.train_loader)
    log(f"  trainer built in {time.perf_counter() - t0:.1f} s: {steps} steps per epoch (batch "
        f"{cfg.training.batch_size}, {len(trainer.sampler)} pre-sampled locations in "
        f"{len(trainer.sampler.cases)} cases), corpus {trainer.corpus.per_chip_bytes / 2**20:.1f} MiB "
        f"on the card, K = {trainer._chain} steps per dispatch")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    launches = {"train": dict(norm=0, block=0, plain_block=0), "val": dict(norm=0, block=0)}
    epoch_s, val_s = [], []
    train_epoch, validate = trainer.train_epoch, trainer.validate

    def counted(fn, where, seconds):
        def run(epoch):
            torch.cuda.synchronize()
            n = (norm_kernel.launches, block_kernel.launches, block_kernel.plain_calls)
            t = time.perf_counter()
            out = fn(epoch)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t)
            launches[where]["norm"] += norm_kernel.launches - n[0]
            launches[where]["block"] += block_kernel.launches - n[1]
            if where == "train":
                launches[where]["plain_block"] += block_kernel.plain_calls - n[2]
            return out
        return run

    trainer.train_epoch = counted(train_epoch, "train", epoch_s)
    trainer.validate = counted(validate, "val", val_s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_kernel.launches = block_kernel.plain_calls = norm_kernel.launches = 0
    result = trainer.train()
    peak = torch.cuda.max_memory_allocated()
    hist = trainer.history
    for e, (es, vs) in enumerate(zip(epoch_s, val_s)):
        fb = trainer.val_fallback_history[e]
        log(f"  epoch {e + 1}: train {es:.2f} s = {es / steps * 1e3:.2f} ms/step "
            f"({steps / es:.1f} steps/s); loss {hist['train_loss'][e]:.5f}; validation "
            f"{vs:.2f} s = {vs / fb['n_cases']:.2f} s/case (device sweep {fb['device']}, "
            f"escalated {fb['escalated']}, host {fb['host']}); val loss {hist['val_loss'][e]:.5f}, "
            f"recall {hist['val_recall'][e]:.3f}, dsc {hist['val_dsc'][e]:.4f}, best threshold "
            f"{hist['val_best_threshold'][e]}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB; skipped steps "
        f"{result['skipped_steps_total']}; launches in training steps {launches['train']}, "
        f"in validation {launches['val']} on {smi}")
    if not np.isfinite(hist["train_loss"]).all() or len(hist["train_loss"]) != 2:
        raise AssertionError(f"training losses not finite: {hist['train_loss']}")
    if launches["train"] != dict(norm=0, block=0, plain_block=0):
        raise AssertionError(f"a fused kernel ran inside the training steps: {launches['train']}")
    if launches["val"]["norm"] == 0:
        raise AssertionError("validation did not go through the norm kernel")
    changed = sum(not torch.equal(v, trainer.model.state_dict()[k]) for k, v in before.items())
    if changed < len(before) // 2:
        raise AssertionError(f"only {changed}/{len(before)} parameter tensors changed")
    ckpts = sorted(p.name for p in (work / "models/checkpoints").glob("*.ckpt"))
    best = work / cfg.output.best_model_path
    if ckpts != ["checkpoint_epoch_001.ckpt", "checkpoint_epoch_002.ckpt"] or not best.exists():
        raise AssertionError(f"checkpoints {ckpts}, best model {best.exists()}")
    if not (work / "logs/training_history.json").exists():
        raise AssertionError("no training_history.json")
    log(f"  {changed}/{len(before)} parameter tensors changed; checkpoints {ckpts}; "
        f"{cfg.output.best_model_path} from epoch {result['best_epoch'] + 1}")

    fresh = Trainer(cfg, workdir=str(work), device="cuda")
    if not fresh.resume() or fresh.start_epoch != 2 or int(fresh.opt.count) != int(trainer.opt.count):
        raise AssertionError(f"resume: epoch {fresh.start_epoch}, step {int(fresh.opt.count)} vs "
                             f"{int(trainer.opt.count)}")
    log(f"  resume: a fresh trainer continues at epoch {fresh.start_epoch + 1} with the optimizer "
        f"at step {int(fresh.opt.count)}")
    fresh.writer.close()
    if profile:
        profile_steps(trainer)
    del trainer, fresh
    first_step_agreement(data_dir, splits, tmp / "first_step")
    torch.cuda.empty_cache()
    return best, splits / "val_list.txt", launches["val"]["norm"]


def evaluate_phase(tmp: Path, data_dir: Path, best: Path, split: Path, smi: str) -> dict:
    """Serve the validation phantoms with the trained model, ``run_evaluate``
    on the card, each case held against the host path; returns the serving
    run's kernel launches."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops import block_kernel, norm_kernel
    from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.pipeline.evaluate import (
        _device_case_results,
        evaluate_case,
        run_evaluate,
    )
    from light_unet_tpu_torch.utils import nifti

    work = tmp / "evaluate"
    cases = split.read_text().split()
    block_kernel.launches = block_kernel.plain_calls = norm_kernel.launches = 0
    inf = Inferencer(SERVING, best, workdir=str(work), device="cuda")
    result = inf.infer_split(split, data_dir)
    served = dict(block=block_kernel.launches, plain_block=block_kernel.plain_calls,
                  norm=norm_kernel.launches)
    if result["failed"] or result["successful"] != len(cases) or served["block"] == 0:
        raise AssertionError(f"serving the trained model failed: {result}, launches {served}")
    cfg = Config.from_dict(SERVING)
    maps = work / "inference/prob_maps"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = run_evaluate(cfg, split, maps, data_dir, work / "eval", device="cuda")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    detailed = json.loads((work / "eval/detailed_results.json").read_text())["per_case"]
    thresholds = sorted(summary)
    spacing = tuple(cfg.data.spacing.target)
    for cid in cases:
        host = evaluate_case(cid, maps, data_dir, thresholds, spacing=spacing, use_device=False)
        for t in thresholds:
            dev = detailed[cid][str(t)]
            if any(dev[k] != host[t][k] for k in ("tp", "fp", "fn")) or not (
                    abs(dev["dsc"] - host[t]["dsc"]) <= 1e-9):
                raise AssertionError(f"case {cid} threshold {t}: device {dev} vs host {host[t]}")
    log(f"  served {len(cases)} cases with the trained model (launches {served}); run_evaluate "
        f"on the card {seconds / len(cases):.2f} s per case (decode, upload, sweep or host "
        f"path, matching); every case's counts equal the host path's, DSC within 1e-9")
    # the device sweep engine on every served map, against the host path: a
    # cap of 16x the default (the trainer's escalation tier is 4x) holds the
    # speckled maps of a briefly trained model, which the evaluate stage's
    # default cap sends to the host path
    sweep = DeviceValidationSweep(thresholds, max_components=16 * 4096, device="cuda")
    took = 0
    for cid in cases:
        prob_map = nifti.load(maps / f"{cid}_prob.nii.gz").get_fdata()
        label = nifti.load(data_dir / f"labels/{cid}.nii.gz").get_fdata()
        dev = _device_case_results(prob_map, label, thresholds, spacing, sweep)
        if dev is None:
            raise AssertionError(f"case {cid}: the 16x-cap sweep fell back "
                                 f"({sweep.last_overflow_reason})")
        host = evaluate_case(cid, maps, data_dir, thresholds, spacing=spacing, use_device=False)
        for t in thresholds:
            if any(dev[t][k] != host[t][k] for k in ("tp", "fp", "fn")) or not (
                    abs(dev[t]["dsc"] - host[t]["dsc"]) <= 1e-9):
                raise AssertionError(f"case {cid} threshold {t}: device {dev[t]} vs host {host[t]}")
        took += detailed[cid] == {str(t): dev[t] for t in thresholds}
    log(f"  the device sweep (cap {sweep.max_components}) on every served map equals the host "
        f"path (counts, DSC within 1e-9); run_evaluate's default-cap sweep took {took} of "
        f"{len(cases)} cases on the device, the rest on the host path")
    # the sweep alone on one case's map, per threshold
    cid = cases[0]
    prob = torch.from_numpy(nifti.load(maps / f"{cid}_prob.nii.gz").get_fdata(np.float32)).cuda()
    label = nifti.load(data_dir / f"labels/{cid}.nii.gz").get_fdata()
    sweep.add_case(cid, label)
    res = sweep.case_metrics(cid, prob, spacing)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        res = sweep.case_metrics(cid, prob, spacing)
    ms = (time.perf_counter() - t0) / 3 / len(thresholds) * 1e3
    components = [r["tp"] + r["fp"] for r in res]
    log(f"  device sweep on case {cid} {tuple(prob.shape)}: {ms:.1f} ms per threshold "
        f"({len(thresholds)} thresholds, tables to the host and matching included; predicted "
        f"components per threshold {components}) on {smi}; default threshold: recall "
        f"{summary[cfg.validation.default_threshold]['recall']:.3f}, "
        f"dsc {summary[cfg.validation.default_threshold]['dsc']:.4f}")
    return served


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace the fused_block serving and fused-pipeline runs and 20 "
                        "training steps with torch.profiler")
    parser.add_argument("--quick", action="store_true",
                        help="build and check the kernels at a small batch; skip timing and serving")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    try:
        from light_unet_tpu_torch.config import Config
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})", file=sys.stderr)
        return 2
    from light_unet_tpu_torch.models.unet3d import build_model, init_weights
    from light_unet_tpu_torch.ops import _build, block_kernel, norm_kernel

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")
    log(f"[clocks] sm, max sm, mem, power, temperature: {nvidia_smi_clocks()}")

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s -> {_build.build_dir()}")
    for name in libs:
        for kernel, usage in ptxas_usage((_build.build_dir() / f"{name}.log").read_text()):
            log(f"  {name}: {kernel}: {usage}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = 4 if args.quick else 192

    # 3. K2
    log(f"[norm kernel] B={batch}")
    norm_rows, norm_err = norm_phase(batch, gen, timed=not args.quick)
    log(f"  max abs err: bf16 {norm_err[torch.bfloat16]:.3e}, f32 {norm_err[torch.float32]:.3e}")

    # 4. K1
    model_cfg = Config.from_dict(SERVING).model
    model = init_weights(build_model(model_cfg, torch.bfloat16, inference=True),
                         torch.Generator().manual_seed(1)).cuda().eval()
    model32 = build_model(model_cfg, torch.float32, inference=True).cuda().eval()
    model32.load_state_dict(model.state_dict(), strict=True)
    log(f"[block kernel] bf16 B={batch}")
    block_rows, block_err = block_phase(model, batch, 2e-2, gen, timed=not args.quick)
    _, block_err32 = block_phase(model32, 4 if args.quick else 16, 5e-5, gen, timed=False)
    log(f"  max abs err: bf16 {block_err:.3e}, f32 {block_err32:.3e}")
    log(f"[clocks] after the kernel phases: {nvidia_smi_clocks()}")
    if args.quick:
        log(f"[quick] kernels built and checked in {time.perf_counter() - t_start:.1f} s")
        return 0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=REPO) as tmp:
        tmp = Path(tmp)
        # 5. raw -> split -> preprocess on the card
        data_dir, split, raw_paths = preprocess_phase(tmp, SERVING)

        # 6. the serving path, from the preprocessed tree
        model_path = tmp / "models/best_model.pth"
        model_path.parent.mkdir(parents=True)
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        torch.save({"model_state_dict": state, "epoch": 0}, model_path)
        log(f"[serving] {N_CASES} preprocessed cases {SERVING_SHAPE}")
        runs, counts = {}, {}
        for name, gates in GATES:
            cfg = json.loads(json.dumps(SERVING))
            cfg["tpu"].update(gates)
            block_kernel.launches = block_kernel.plain_calls = norm_kernel.launches = 0
            vps, maps = serve(cfg, model_path, data_dir, split, tmp / name,
                              profile=args.profile and name == "fused_block")
            counts[name] = dict(block=block_kernel.launches, plain_block=block_kernel.plain_calls,
                                norm=norm_kernel.launches)
            runs[name] = maps
            log(f"  {name}: {vps:.3f} vol/s on {smi}; launches {counts[name]}")
        check_gates(counts, "serving run")
        check_against_plain(runs, "serving")

        # 7. the fused per-volume pipeline on the raw volumes
        log(f"[fused pipeline] {N_CASES} raw volumes {SERVING_SHAPE}, uint16 upload and fetch, "
            f"sparse fetch, patch_batch {SERVING['tpu']['patch_batch']}")
        fused_runs, fused_counts = {}, {}
        for name, gates in GATES:
            cfg = Config.from_dict(SERVING)
            for k, v in gates.items():
                setattr(cfg.tpu, k, v)
            block_kernel.launches = block_kernel.plain_calls = norm_kernel.launches = 0
            vps, peak, maps, preps, pipe = fused_run(
                cfg, state, raw_paths, profile=args.profile and name == "fused_block")
            fused_counts[name] = dict(block=block_kernel.launches,
                                      plain_block=block_kernel.plain_calls,
                                      norm=norm_kernel.launches)
            check_zero_outside_body(cfg, maps, preps)
            fused_runs[name] = maps
            log(f"  {name}: {vps:.3f} vol/s on {smi}; peak device memory {peak / 2**30:.2f} GiB; "
                f"launches {fused_counts[name]}; maps 0 outside the body mask")
            if name == "fused_block":
                fused_phases(pipe, raw_paths[0])
            del preps, pipe
        check_gates(fused_counts, "fused pipeline run")
        check_against_plain(fused_runs, "fused pipeline")

        # 8. the train stage on the processed phantoms
        ids = [p.name.split("_")[0] for p in raw_paths]
        log(f"[train] the port Trainer, configs/unet_fl70.yaml model, bf16, batch 2, 48^3, "
            f"train {ids[:2]}, validate {ids[2:]}, 2 epochs, use_pallas on")
        best, val_split, train_val_norm = train_phase(tmp, data_dir, ids, smi, profile=args.profile)

        # 9. the evaluate stage on the trained model's maps
        log(f"[evaluate] {val_split.read_text().split()} served with the trained model, "
            f"then run_evaluate on the card")
        eval_counts = evaluate_phase(tmp, data_dir, best, val_split, smi)

    # 10. results
    def total(rows, key, weights=None):
        return sum(r[key] * (weights or {}).get(k, 1) for k, r in rows.items())

    # calls per forward: 7 projection blocks x 3 norms + the identity bottleneck x 2
    norm_calls = {(48, 16): 6, (24, 32): 6, (12, 64): 6, (6, 128): 5}
    norm_bytes, norm_ops = total(norm_rows, "bytes_ms", norm_calls), total(norm_rows, "ops_ms", norm_calls)
    blk_bytes, blk_ops = total(block_rows, "bytes_ms"), total(block_rows, "ops_ms")
    kernels = [
        {
            "name": "residual_block", "route": "cuda",
            "source": "light_unet_tpu_torch/csrc/residual_block.cu",
            "replaces": "light_unet_tpu/ops/pallas_block.py:417",
            "launches": (counts["fused_block"]["block"] + fused_counts["fused_block"]["block"]
                         + eval_counts["block"]),
            "max_abs_err": block_err,
            "ms": total(block_rows, "ms"), "plain_ms": total(block_rows, "plain_ms"),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) for r in block_rows.values()),
            "bound_by": "bytes" if blk_bytes >= blk_ops else "operations",
            "library_ms": None,
        },
        {
            "name": "instance_norm_leaky", "route": "cuda",
            "source": "light_unet_tpu_torch/csrc/instance_norm.cu",
            "replaces": "light_unet_tpu/ops/pallas_kernels.py:118",
            "launches": (counts["use_pallas"]["norm"] + fused_counts["use_pallas"]["norm"]
                         + train_val_norm),
            "max_abs_err": norm_err[torch.bfloat16],
            "ms": total(norm_rows, "ms", norm_calls),
            "plain_ms": total(norm_rows, "plain_ms", norm_calls),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) * norm_calls[k]
                            for k, r in norm_rows.items()),
            "bound_by": "bytes" if norm_bytes >= norm_ops else "operations",
            "library_ms": total(norm_rows, "library_ms", norm_calls),
        },
    ]
    log(f"[result] launches: residual_block = serving {counts['fused_block']['block']} + fused "
        f"pipeline {fused_counts['fused_block']['block']} + evaluate-phase serving "
        f"{eval_counts['block']}; instance_norm_leaky = serving {counts['use_pallas']['norm']} + "
        f"fused pipeline {fused_counts['use_pallas']['norm']} + training-phase validation "
        f"{train_val_norm}")
    log("[result] per-kernel times are sums over one 192-patch bf16 forward; "
        f"instance_norm_leaky device time {total(norm_rows, 'device_ms', norm_calls):.4f} ms "
        f"(CUDA events {total(norm_rows, 'ms', norm_calls):.4f} ms)")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
