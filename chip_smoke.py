#!/usr/bin/env python3
"""Drive the PyTorch port (``light_unet_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full check (one card, about 8-11 minutes)
    python3 chip_smoke.py --quick    # build + kernel checks at a small batch only
    python3 chip_smoke.py --profile  # also trace fused_block serving, the fused pipeline, 20 training steps
    python3 chip_smoke.py --cli-rank DIR <CLI flags>  # one rank of phase 15's torchrun job

Phases:
1. device line: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build the CUDA kernels from ``light_unet_tpu_torch/csrc`` (``ops/_build.py``)
   and, in parallel, the host library ``csrc/fastio.cpp`` with the C++
   compiler (logged: compiler, its version, seconds, host cores);
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
   (mask and counts equal, normalized <= 1e-6 abs); the stage must have
   decoded and taken its percentiles through the host library; logged:
   seconds per case, one case's time split serially with ``StageTimer``
   (decode, percentiles, device pass, NIfTI writes), CUDA-event ms of the
   body-mask chain and ``label_propagate`` rounds per volume;
5b. the host I/O library (``utils/fastio.py``): ``load_f32`` equal to the
   codec bit for bit (arrays and headers) on the raw phantoms, their
   processed images and body masks and a scaled int16 file,
   ``load_batch_f32`` equal to the single decodes, ``percentiles`` equal to
   ``np.percentile`` and ``quantize_pad`` to the numpy chain on each raw
   volume; logged: each one's time beside its plain version's (min of 3),
   the inflate's MB/s, the batch decode's vol/s;
6. the serving path: a seeded ``best_model.pth`` and the preprocessed tree
   (its body masks included) go through ``Inferencer.infer_split`` three
   times: ``tpu.fused_block`` (the block kernel's launch count must rise,
   the plain block must never run), ``tpu.use_pallas`` (the norm kernel's
   count must rise), and neither gate (the plain model), whose prob maps
   the first two must match within 5e-2 abs; each run decodes image and
   body mask of every case through the host library; one case is then
   split serially with ``StageTimer`` (decode, prepare, dispatch, device
   work, candidate table, fetch, NIfTI write, JSON write);
7. the fused per-volume pipeline: ``FusedVolumePipeline`` over the 4 raw
   volumes (uint16 upload and fetch, sparse fetch, decode and prepare on a
   worker thread) under the same three gates with the same launch-count
   bars and the same 5e-2 bar; each map must be exactly 0 wherever
   ``body_mask_core`` of the same dequantized volume on the card is 0; each
   run makes one native decode, percentile selection and quantize + pad
   per volume; logged: vol/s, peak device memory, and under
   ``fused_block`` one volume's time split serially with ``StageTimer``
   (decode, prepare, dispatch, fetch);
8. the train stage: the port ``Trainer`` at the full ``configs/unet_fl70.yaml``
   model (bf16, batch 2, 48^3, device corpus, ``steps_per_dispatch`` 4,
   separable augmentation, augmentation and dropout on, ``tpu.use_pallas``
   on) for 2 epochs on 2 of the processed phantoms, validating on the other
   2, every dispatch unit a CUDA graph replay and every validation chunk
   forward too (the graph keys must be the JAX package's variants: the
   chain of 4 and the epoch's tail; warm-up and capture seconds, replays
   and pool logged); checks: finite losses, parameters changed, checkpoints and
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
10. mixed FL + DLBCL training: 2 more raw phantoms with DLBCL ids
   1001-1002 (seed 1) preprocessed on the card into the same tree; run A
   is ``configs/unet_mixed_fl_dlbcl.yaml`` (``fl_epoch_plus_dlbcl``, DLBCL
   steps = FL batches x 1.0; phase 8's model, rate and gates) for 1 epoch
   on FL 0001-0002 + DLBCL 1001-1002 through ``Trainer.train``, validating
   on FL 0003-0004, graphed (both domains' units share the keys): step
   counts per domain, finite losses, no kernel launch
   in the training steps and norm-kernel launches in validation,
   checkpoint and best model written, and a fresh trainer resumes with
   both sampler streams, the generator and the optimizer step equal; run B
   is ``probabilistic``, one epoch: FL + DLBCL samples = steps x batch,
   equal to a CPU ``MixedPatchSampler`` on the same seed; then one float32
   DLBCL step (a batch with lesion voxels) on the card within 1e-4 relative
   of the CPU's; logged: ms per step per domain, validation s per case,
   peak device memory;
11. multi-rank (``parallel/``): (a) a one-rank NCCL group on cuda:0 made
   by ``maybe_distributed_init``, ``all_reduce`` and
   ``reduce_scatter_tensor`` of uint8 on the card, then ``GuardedAdamW.step``
   (its gradient all-reduce) and a reduce-scatter captured in one CUDA
   graph and replayed, equal to the eager calls, then the patch-sharded
   window (serving flags, bf16, ``fused_block``) with its ``psum`` captured
   over the group and replayed, equal to the eager unit and to the
   single-device window bit for bit; (b) on one card 2
   spawned ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
   card; gloo ranks train with the eager step, which the log says), on
   several cards one rank a card over NCCL, with the full-width
   model: one processed phantom served by ``Inferencer``
   patch-sharded and slab-sharded (z padded to 288, slabs of 144) in bf16
   under ``fused_block`` (within 5e-2 of phase 6's map) and in float32 with
   TF32 off (within 1e-5 of a one-rank float32 map), rank 1 writing
   nothing, the slab maps exactly 0 outside the body mask and the block
   kernel launched on both ranks; then 20 data-parallel training steps
   (``batch_per_device`` 2, case-sharded corpus, K = 4,
   augmentation and dropout on) and a validation under ``use_pallas``
   (norm kernel in validation, never in the steps), the ranks' flat
   parameters bit-identical, and one float32 chain whose first 3 losses are
   within 1e-4 relative of one process at the same global batch; logged: s
   a volume on each rank beside one rank's, ms a step, peak memory a rank
   (ranks sharing one card: no speed-up claim);
12. the dispatch units as CUDA graphs against the eager path (``Trainer(...,
   graphs=False)``): (a) phase 8's configuration in float32 (TF32 off), 15
   steps as chains of 4, a tail chain of 2 and the single step with one
   planted non-finite batch, with cuDNN's deterministic algorithms: losses
   within 1e-5 relative, parameters and moments within 1e-5, skip flags,
   step count and generator state equal (with its default algorithms,
   graphed against eager and eager against eager are logged);
   (b) the same in bf16, each path timed (median ms a step over 24 steps
   after capture, back to back, first unit with its capture), profiled
   (device busy share, host launch calls a unit) and its peak memory
   logged; (d) the fused pipeline under ``fused_block``, graphed and eager,
   two passes each over the 4 raw volumes (vol/s; the first graphed pass
   pays the captures), the maps compared;
13. the per-volume units: (a) the CCL kernel (``csrc/ccl.cu``) against its
   plain version (the sweeps) on the 4 closed body masks of phase 5, two
   served maps at 0.3 and 7 adversarial masks at 144x144x288 (a serpentine
   of 72 sweep rounds, one blob, one-voxel components, empty, full, random
   0.3 and 0.6): labels equal, the largest label difference reported;
   timed on the body masks, served maps and random masks beside its bound
   (mask read + labels written, 5 bytes a voxel) and, on the first two, the
   sweeps; (b) the serving window (uint16 in and out, sparse fetch, packed
   body mask) and its candidate table (one eager call profiled), and (c)
   the fused program, each graphed and eager in every route and in bf16
   and float32; (d) the preprocess pass; (e) the validation sweep (9
   thresholds in one unit, the trainer's cap 4096; its 4x tier timed, one
   eager call profiled): graphed and eager bit-identical, each replay
   under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), host
   ms to dispatch a volume and device ms, warm-up and capture seconds and
   pool a key; (f) serving graphed and eager, one warmed ``Inferencer``
   each, in alternating passes g e e g (vol/s, maps equal), and one eager serving
   case split serially;
14. a cohort of four z buckets: 4 raw phantoms of 144x144x240, 144x144x272,
   160x160x312 and 144x144x360 (z_bucket 48 pads them to z 240, 288, 336
   and 384) preprocessed on the card (one preprocess key a bucket), then per
   route (``fused_block`` bf16, ``use_pallas`` bf16, plain float32 with TF32
   off) one ``Inferencer`` and one ``FusedVolumePipeline``: (a) graphed,
   the volumes served in the orders A B C D, D C B A and B D A C, every map,
   candidate table and bbox JSON of the later passes bit-identical to the
   first's (the keys of a runner share its memory pool); (b) eagerly,
   bit-identical to graphed; (c) the bf16 routes within 5e-2 of the plain
   float32 maps, every map exactly 0 outside the body mask; (d) per key the
   pool's growth, warm-up and capture seconds, reserved and peak memory
   after it, the ``HbmLedger`` summary, and what releasing a route gives
   back; then (e) ``DeviceValidationSweep`` over the served maps of the four
   buckets (one graphed key a bucket), graphed, eager and at 4x the cap,
   counts equal to the host path and the tables graphed = eager;
15. the CLI as a torchrun job: 6 raw phantoms 0031-0036 (seed 15) and
   ``--mode all`` (phase 8's model in float32 with ``use_pallas``, 1 epoch,
   the cases split 1 + 2 + 3, global batch 2 x N) run (i) in this process
   and (ii) as ``python3 -m torch.distributed.run --standalone
   --nproc_per_node N chip_smoke.py --cli-rank <dir> ...`` with N =
   ``torch.cuda.device_count()`` and ``tpu.distributed: true``, one shared
   workdir (each rank calls ``cli.run``, as ``python -m
   light_unet_tpu_torch.cli`` does, and writes its stage seconds, device,
   peak memory, kernel launches and the files it wrote); both with cuDNN's
   deterministic algorithms; the job's split lists and processed files
   equal to (i)'s byte for byte, with N = 1 its history, best model, maps,
   bbox JSONs and evaluate counts equal, with N > 1 its train and
   validation losses within 1e-4 relative (``compare_cli_runs``: over an
   epoch of AdamW the ranks' sums move the parameters apart, so the model,
   the maps and the thresholded metrics are logged), every rank on its own
   card with norm-kernel launches, no rank but 0 writing a file of the
   artifact tree; logged: s per stage per rank, start-up seconds (launch
   to process group);
16. one JSON line of per-kernel numbers (launches summed over the runs under
   the kernel's gate: serving, fused pipeline, the training phases'
   validation, the evaluate phase's serving, the multi-rank phase, the
   bucket phase and the torchrun phase, each logged, and the CCL kernel's in preprocess, serving,
   the fused pipeline and the bucket phase; a graph replay counts every
   launch it holds), the ``nvidia-smi`` line, and last ``{"ok": true,
   "device": {...}}``.

On one card every dispatch unit runs as a CUDA graph replay, the port's
default: the training units (phases 8, 10, 11's one-process references)
and per volume the window, the fused program, the preprocess pass, the
candidate table and the validation sweep (phases 5-10 and 14); phase 11a also
replays the patch-sharded window over its one-rank NCCL group.

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


def report_stages(timer, title: str) -> dict:
    """``title``, then ``StageTimer.report`` and its summary as one JSON line
    (seconds to 4 decimals); returns the summary."""
    log(f"  {title} (StageTimer):")
    timer.report(prefix="    ")
    summary = timer.summary()
    log(f"    stages: {json.dumps(summary)}")
    return summary


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


def write_raw_cases(raw_dir: Path, seed: int, ids=None, shape=SERVING_SHAPE) -> list:
    """Raw whole-body PET phantoms of ``shape`` at 4 mm with lesion labels,
    seeded (ids 0001-0004 unless given):
    SUV-like intensities (air near 0, a textured body ellipsoid around
    1-2.5, cold pockets inside it that the closing fills, a scanner-bed slab
    and specks of air noise that the largest component drops, hot spheres of
    SUV 6-15 as lesions)."""
    from light_unet_tpu_torch.utils import nifti

    rng = np.random.default_rng(seed)
    for sub in ("images", "labels"):
        (raw_dir / sub).mkdir(parents=True, exist_ok=True)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    body = ((zz - shape[0] / 2) ** 2 / (0.42 * shape[0]) ** 2
            + (yy - shape[1] / 2) ** 2 / (0.36 * shape[1]) ** 2
            + (xx - shape[2] / 2) ** 2 / (0.45 * shape[2]) ** 2) <= 1.0
    # the bed lies 12 voxels below the body, more than the closing (radius 5)
    # bridges, so the largest component drops it
    bed = (yy >= int(0.95 * shape[1])) & (yy < int(0.95 * shape[1]) + 2) & (zz >= 8) & (xx >= 8)
    ids = ids or [f"{i + 1:04d}" for i in range(N_CASES)]
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
    """Rounds the plain CCL (the JAX package's sweeps) takes on ``mask``,
    counted here, with its labels held equal to ``ops/ccl.label_propagate``'s
    (the CCL kernel on the card)."""
    import torch

    from light_unet_tpu_torch.ops import ccl, ccl_kernel

    n = mask.numel()
    labels = torch.arange(1, n + 1, dtype=torch.int64, device=mask.device).reshape(mask.shape)
    labels = labels * (mask > 0)
    rounds = 0
    while True:
        prev, rounds = labels, rounds + 1
        for axis in range(3):
            labels = ccl_kernel._axis_sweep(labels, axis, False, n + 1)
            labels = ccl_kernel._axis_sweep(labels, axis, True, n + 1)
        if torch.equal(labels, prev):
            break
    if not torch.equal(labels.to(torch.int32), ccl.label_propagate(mask)):
        raise AssertionError("counted CCL sweeps disagree with label_propagate (the kernel)")
    return rounds


def preprocess_phase(tmp: Path, config: dict) -> tuple:
    """Raw phantoms -> split -> ``run_preprocess`` on the card; one case held
    against the CPU.  Returns (processed dir, val split file, raw image paths,
    {name: closed body mask} for the CCL checks of phase 13, the CCL kernel's
    launches in ``run_preprocess``)."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops import ccl_kernel
    from light_unet_tpu_torch.ops.body_mask import body_mask_core, body_mask_settings
    from light_unet_tpu_torch.ops.fused import normalize_and_body_mask
    from light_unet_tpu_torch.ops.intensity import compute_clip_values, pad_volume
    from light_unet_tpu_torch.ops.morphology import binary_closing
    from light_unet_tpu_torch.ops.sliding_window import _valid_mask
    from light_unet_tpu_torch.pipeline.preprocess import run_preprocess
    from light_unet_tpu_torch.pipeline.split import split_dataset
    from light_unet_tpu_torch.utils import fastio, nifti
    from light_unet_tpu_torch.utils.graphs import runner_for
    from light_unet_tpu_torch.utils.tracing import StageTimer

    raw, splits, processed = tmp / "raw", tmp / "splits", tmp / "processed"
    t0 = time.perf_counter()
    ids = write_raw_cases(raw, seed=0)
    log(f"[preprocess] {N_CASES} raw cases {SERVING_SHAPE} written in "
        f"{time.perf_counter() - t0:.1f} s")
    manifest = split_dataset(raw, splits, 0.0, 1.0, 0.0, seed=42)
    if manifest["splits"]["val"] != ids:
        raise AssertionError(f"split put {manifest['split_sizes']} cases, not all 4 in val")
    cfg = Config.from_dict(config)
    calls = dict(fastio.calls)
    ccl_kernel.launches = 0
    summaries = run_preprocess(cfg, raw, processed, splits, split="val", device="cuda")
    ccl_launches = ccl_kernel.launches
    if ccl_launches < N_CASES:
        raise AssertionError(f"run_preprocess launched the CCL kernel {ccl_launches} times")
    val = summaries["val"]
    if val["successful"] != N_CASES or val["failed"]:
        raise AssertionError(f"preprocess failed: {val['failed_cases']}")
    native = {k: fastio.calls[k] - calls[k] for k in calls}
    if native["decode"] < N_CASES or native["order_stats"] < N_CASES:
        raise AssertionError(f"run_preprocess did not go through the host library: {native}")
    log(f"  run_preprocess on the card: {val['seconds'] / N_CASES:.2f} s per case "
        f"(decode, percentiles, device pass: one graph replay a volume after the first, "
        f"NIfTI writes); host library calls {native}; CCL kernel launches {ccl_launches}")

    # one case against the port's CPU run of the same pass
    cid = ids[0]
    image = fastio.load_f32(raw / f"images/{cid}_0000.nii.gz")[0]
    t0 = time.perf_counter()
    norm_cpu, mask_cpu, imeta, mmeta = normalize_and_body_mask(
        image, cfg.data.intensity, cfg.data.body_mask, z_bucket=cfg.tpu.z_bucket, device="cpu")
    cpu_s = time.perf_counter() - t0
    norm_card = fastio.load_f32(processed / f"images/{cid}_0000.nii.gz")[0]
    mask_card = fastio.load_f32(processed / f"body_masks/{cid}.nii.gz")[0] > 0.5
    meta = json.loads((processed / f"metadata/{cid}.json").read_text())
    err = float(np.abs(norm_card - norm_cpu).max())
    if not (np.array_equal(mask_card, mask_cpu) and meta["body_mask"] == mmeta
            and meta["clip_values"] == imeta["clip_values"] and err <= 1e-6):
        raise AssertionError(f"case {cid}: card and CPU preprocess differ (normalized {err}, "
                             f"counts {meta['body_mask']['voxel_counts']} vs "
                             f"{mmeta['voxel_counts']})")
    log(f"  case {cid} vs the CPU run ({cpu_s:.1f} s): mask equal, counts equal "
        f"{mmeta['voxel_counts']}, normalized max abs diff {err:.1e} (bar 1e-6)")

    # where one case's time goes, serially (the device pass computes the
    # percentiles again: the line after the report subtracts them); the
    # device pass is a replay, as in run_preprocess after its first case
    runner = runner_for(torch.device("cuda"), True, "preprocess")
    normalize_and_body_mask(image, cfg.data.intensity, cfg.data.body_mask,
                            z_bucket=cfg.tpu.z_bucket, device="cuda", runner=runner)
    timer = StageTimer()
    torch.cuda.synchronize()
    with timer.time("decode"):
        image = fastio.load_f32(raw / f"images/{cid}_0000.nii.gz")[0]
    with timer.time("percentiles"):
        compute_clip_values(image, cfg.data.intensity.clip_percentile_low,
                            cfg.data.intensity.clip_percentile_high)
    with timer.time("device pass"):
        norm, mask, _, _ = normalize_and_body_mask(image, cfg.data.intensity, cfg.data.body_mask,
                                                   z_bucket=cfg.tpu.z_bucket, device="cuda",
                                                   runner=runner)
    with timer.time("NIfTI writes"):
        nifti.save(nifti.Nifti1Image(norm, np.diag([4.0, 4.0, 4.0, 1.0])),
                   tmp / "phase_probe.nii.gz")
        nifti.save(nifti.Nifti1Image(mask.astype(np.uint8), np.diag([4.0, 4.0, 4.0, 1.0])),
                   tmp / "phase_probe_mask.nii.gz")
    split = report_stages(timer, "one case, serially")
    log(f"    device pass less its percentiles (upload, normalize, body mask, fetch): "
        f"{split['device pass']['total_seconds'] - split['percentiles']['total_seconds']:.4f} s")

    # the body-mask chain alone on the card, and the CCL rounds the plain
    # sweeps take on its closed mask, per volume (the masks go on to phase 13)
    settings = body_mask_settings(cfg.data.body_mask)
    closed_masks = {}
    for cid in ids:
        norm = fastio.load_f32(processed / f"images/{cid}_0000.nii.gz")[0]
        padded = torch.from_numpy(pad_volume(norm, cfg.tpu.z_bucket)).cuda()
        valid = _valid_mask(padded.shape, norm.shape, padded.device)
        ms = cuda_ms(lambda: body_mask_core(padded, valid, *settings), iters=3, warmup=1)
        closed = binary_closing((padded > settings[0]).float() * valid, settings[1], valid)
        log(f"  body-mask chain {tuple(padded.shape)}: {ms:.2f} ms (CUDA events), "
            f"plain CCL {ccl_rounds(closed)} sweep rounds (the kernel: 3 launches), case {cid}")
        closed_masks[f"closed body {cid}"] = closed.to(torch.uint8).cpu()
    return (processed, splits / "val_list.txt", [raw / f"images/{i}_0000.nii.gz" for i in ids],
            closed_masks, ccl_launches)


def min_seconds(fn, reps: int = 3) -> float:
    """The least host-clock seconds of ``reps`` calls of ``fn``."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def host_io_phase(tmp: Path, raw_paths: list, processed: Path, smi: str) -> None:
    """The host library (``utils/fastio.py``) on the card's host, bit for bit
    against the plain versions: ``load_f32`` against the codec on the raw
    phantoms, their processed images and body masks and a scaled int16 file
    (arrays and headers), ``load_batch_f32`` against the single decodes,
    ``percentiles`` against ``np.percentile`` and ``quantize_pad`` against the
    numpy chain on each raw volume; each of the three timed beside its plain
    version (min of 3), with the inflate's MB/s."""
    import os
    import zlib
    from concurrent.futures import ThreadPoolExecutor

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops.sliding_window import bucketed_shape
    from light_unet_tpu_torch.utils import fastio, nifti

    def plain(path):
        img = nifti.load(path)
        return img.get_fdata(np.float32), img.header

    def same(a, b):
        return a.shape == b.shape and np.array_equal(a.view(np.uint32), b.view(np.uint32))

    ids = [p.name.split("_")[0] for p in raw_paths]
    scaled = tmp / "scaled_int16.nii.gz"
    img = nifti.Nifti1Image(np.random.default_rng(3).integers(-900, 30000, (96, 80, 120),
                                                              dtype=np.int16), np.eye(4))
    img.header.scl_slope, img.header.scl_inter = 0.0123, -4.5
    nifti.save(img, scaled)
    files = (list(raw_paths) + [processed / f"images/{c}_0000.nii.gz" for c in ids]
             + [processed / f"body_masks/{c}.nii.gz" for c in ids] + [scaled])
    def differs(path):  # on worker threads: both decodes release the GIL in their inflate
        (got, hdr), (want, whdr) = fastio.load_f32(path), plain(path)
        return not same(got, want) or hdr.raw != whdr.raw

    with ThreadPoolExecutor(max_workers=4) as pool:
        bad = [p.name for p, d in zip(files, pool.map(differs, files)) if d]
    if bad:
        raise AssertionError(f"native decode differs from the codec: {bad}")
    singles = [fastio.load_f32(p)[0] for p in raw_paths]
    batch = fastio.load_batch_f32(raw_paths)
    if not all(same(a, b) for a, (b, _) in zip(singles, batch)):
        raise AssertionError("load_batch_f32 differs from the single decodes")
    log(f"  load_f32 equals the codec bit for bit (arrays and headers) on {len(files)} files: "
        f"{len(raw_paths)} raw, {len(ids)} processed images, {len(ids)} body masks, one int16 "
        f"with scl_slope 0.0123 / scl_inter -4.5; load_batch_f32 of the {len(raw_paths)} raw "
        f"equals the single decodes")

    cfg = Config.from_dict(SERVING)
    low, high = cfg.data.intensity.clip_percentile_low, cfg.data.intensity.clip_percentile_high
    for path, image in zip(raw_paths, singles):
        got = fastio.percentiles(image, (low, high))
        want = [float(np.percentile(image, low)), float(np.percentile(image, high))]
        if got != want:
            raise AssertionError(f"{path.name}: percentiles {got} vs np.percentile {want}")
        pshape = bucketed_shape(image.shape, tuple(cfg.data.patch_size), cfg.tpu.z_bucket)
        q = fastio.quantize_pad(image, pshape, *got)
        if not np.array_equal(q, fastio.quantize_pad_plain(image, pshape, *got)):
            raise AssertionError(f"{path.name}: quantize_pad differs from the numpy chain")
    log(f"  percentiles ({low}, {high}) equal np.percentile and quantize_pad equals the numpy "
        f"chain bit for bit on the {len(raw_paths)} raw volumes (pad {pshape})")

    path, image = raw_paths[0], singles[0]
    gz = path.read_bytes()
    payload = len(zlib.decompress(gz, 31))
    lo, hi = fastio.percentiles(image, (low, high))
    rows = [
        ("decode (load_f32)", lambda: fastio.load_f32(path), lambda: plain(path)),
        ("inflate alone (gunzip)", lambda: fastio.gunzip(gz, payload),
         lambda: zlib.decompress(gz, 31)),
        ("percentiles (both ranks)", lambda: fastio.percentiles(image, (low, high)),
         lambda: [np.percentile(image, low), np.percentile(image, high)]),
        ("quantize + pad", lambda: fastio.quantize_pad(image, pshape, lo, hi),
         lambda: fastio.quantize_pad_plain(image, pshape, lo, hi)),
    ]
    log(f"  host times, min of 3, one raw volume {SERVING_SHAPE} float32 ({len(gz) / 1e6:.2f} MB "
        f"gzipped, {payload / 1e6:.2f} MB inflated), {os.cpu_count()} host cores, card {smi}:")
    for name, native, base in rows:
        t_native, t_plain = min_seconds(native), min_seconds(base)
        rate = ""
        if "inflate" in name or "decode" in name:
            rate = (f"; native {len(gz) / t_native / 1e6:.1f} MB/s in, {payload / t_native / 1e6:.1f} "
                    f"MB/s out, plain {payload / t_plain / 1e6:.1f} MB/s out")
        log(f"    {name}: native {t_native:.4f} s, plain {t_plain:.4f} s "
            f"({t_plain / t_native:.2f}x){rate}")
    t_batch = min_seconds(lambda: fastio.load_batch_f32(raw_paths))
    log(f"    load_batch_f32 of {len(raw_paths)} raw volumes: {t_batch:.4f} s "
        f"({len(raw_paths) / t_batch:.2f} vol/s; single decodes "
        f"{len(raw_paths) * min_seconds(lambda: fastio.load_f32(path)):.4f} s)")


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
    if {k: v for k, v in counts["plain"].items() if k != "ccl"} != dict(block=0, plain_block=0,
                                                                          norm=0):
        raise AssertionError(f"plain {what} launched a kernel: {counts['plain']}")
    if not all(c["ccl"] for c in counts.values()):
        raise AssertionError(f"a {what} did not go through the CCL kernel: {counts}")


def check_against_plain(runs: dict, what: str) -> None:
    for name in ("fused_block", "use_pallas"):
        err = max(float(np.abs(runs[name][c] - runs["plain"][c]).max()) for c in runs["plain"])
        log(f"  {name} vs plain model ({what}): max abs prob diff {err:.3e} (bar 5e-2)")
        if not err <= 5e-2:
            raise AssertionError(f"{name} {what} maps differ from the plain model by {err}")


def fused_pipeline(config, state: dict, graphs: bool = True):
    """``FusedVolumePipeline`` over a model with ``state`` in ``config``'s
    compute dtype, under its gates."""
    import torch

    from light_unet_tpu_torch.models.fused_forward import make_fused_apply
    from light_unet_tpu_torch.models.unet3d import build_model
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline

    dtype = torch.float32 if config.tpu.compute_dtype == "float32" else torch.bfloat16
    model = build_model(config.model, dtype, inference=True, use_pallas=config.tpu.use_pallas)
    model.load_state_dict(state, strict=True)
    model = model.cuda().eval()
    apply_fn = make_fused_apply(model) if config.tpu.fused_block else model
    return FusedVolumePipeline(apply_fn, config, patch_batch=config.tpu.patch_batch,
                               graphs=graphs, device="cuda")


def fused_pass(pipe, paths: list) -> tuple:
    """One pass of ``pipe`` over raw volumes, decode and prepare on a worker
    thread; returns (seconds, [map], {case: prepared})."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from light_unet_tpu_torch.utils import fastio

    preps = {}

    def load_and_prepare(path):
        prep = pipe.prepare(fastio.load_f32(path)[0])
        preps[path.name.split("_")[0]] = prep
        return prep

    torch.cuda.synchronize()
    maps = []
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
    return time.perf_counter() - t0, maps, preps


def fused_run(config, state: dict, paths: list, profile: bool = False):
    """``FusedVolumePipeline`` over raw volumes, decode and prepare on a
    worker thread; returns (vol/s, peak bytes, {case: map}, {case: prepared})."""
    import torch

    pipe = fused_pipeline(config, state)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    with prof if profile else contextlib.nullcontext():
        seconds, maps, preps = fused_pass(pipe, paths)
    if profile:
        report_profile(prof, seconds)
    out = {p.name.split("_")[0]: m for p, m in zip(paths, maps)}
    for cid, m in out.items():
        if m.shape != SERVING_SHAPE or not np.isfinite(m).all() or not m.max() > 0:
            raise AssertionError(f"bad fused map {cid}: {m.shape}, max {m.max()}")
    return len(paths) / seconds, torch.cuda.max_memory_allocated(), out, preps, pipe


def fused_graphs_ab(state: dict, paths: list, smi: str) -> dict:
    """12d: ``FusedVolumePipeline`` under ``fused_block``, graphed and eager,
    two passes each over the raw volumes in turns (graphed, eager, eager,
    graphed passes): the first graphed pass pays the captures; the maps of
    the two paths compared."""
    from light_unet_tpu_torch.config import Config

    cfg = Config.from_dict(SERVING)
    pipes = {g: fused_pipeline(cfg, state, graphs=g) for g in (True, False)}
    rates, maps = {True: [], False: []}, {}
    for g in (True, False, False, True):
        seconds, maps[g], _ = fused_pass(pipes[g], paths)
        rates[g].append(len(paths) / seconds)
    err = max(float(np.abs(a - b).max()) for a, b in zip(maps[True], maps[False]))
    same = all(np.array_equal(a, b) for a, b in zip(maps[True], maps[False]))
    log(f"  [12d] fused pipeline, fused_block, {len(paths)} raw volumes: graphed "
        f"{rates[True][0]:.3f} vol/s (first pass, two captures) then {rates[True][1]:.3f}; eager "
        f"{rates[False][0]:.3f} then {rates[False][1]:.3f}; maps max abs diff {err:.3e} "
        f"(bit-identical: {same}) on {smi}")
    if not err <= 5e-2:
        raise AssertionError(f"graphed and eager fused maps differ by {err}")
    return rates


def fused_phases(pipe, path: Path) -> None:
    """One volume through ``pipe`` serially (StageTimer): decode, prepare
    (percentiles, quantize + pad, upload), dispatch (enqueue), fetch (device
    work and copy back)."""
    import torch

    from light_unet_tpu_torch.utils import fastio
    from light_unet_tpu_torch.utils.tracing import StageTimer

    timer = StageTimer()
    torch.cuda.synchronize()
    with timer.time("decode"):
        image = fastio.load_f32(path)[0]
    with timer.time("prepare"):
        prep = pipe.prepare(image)
        torch.cuda.synchronize()
    with timer.time("dispatch"):
        dispatched = pipe.dispatch(prep)
    with timer.time("fetch (device work + copy)"):
        pipe.fetch(dispatched)
    report_stages(timer, "one volume, serially")


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


def profile_unit(fn, what: str) -> None:
    """Device time by kernel of one ``fn()`` (``torch.profiler``)."""
    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    log(f"  [profile] {what}, one eager call:")
    report_profile(prof, wall_s)


def serve(config: dict, model_path: Path, data_dir: Path, split: Path, workdir: Path,
          profile: bool = False, graphs: bool = True):
    """One ``infer_split`` run over the cases of ``split`` by a new
    ``Inferencer``; returns (vol/s, {case: prob map})."""
    from light_unet_tpu_torch.core.inferencer import Inferencer

    inf = Inferencer(config, model_path, workdir=str(workdir), device="cuda", graphs=graphs)
    return serve_with(inf, data_dir, split, workdir, profile)


def serve_with(inf, data_dir: Path, split: Path, workdir: Path, profile: bool = False):
    """One ``infer_split`` run of ``inf`` (whose workdir is ``workdir``);
    returns (vol/s, {case: prob map})."""
    import torch

    from light_unet_tpu_torch.utils import nifti

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
    n_cases = len(split.read_text().split())
    if result["failed"] or result["successful"] != n_cases:
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
    if len(maps) != n_cases:
        raise AssertionError(f"expected {n_cases} prob maps, found {len(maps)}")
    return n_cases / seconds, maps


def serving_phases(config: dict, model_path: Path, data_dir: Path, case_id: str,
                   workdir: Path, graphs: bool = True) -> dict:
    """One serving case serially through ``Inferencer``'s own steps, each
    timed with StageTimer and synchronized at its end: the decodes and
    ``prepare`` inside ``_load_case_inputs``, the dispatch (enqueue), the
    device work, then the candidate table, fetch, NIfTI write and JSON write
    inside ``_finalize_case`` (its callees wrapped while it runs).  With
    graphs the dispatch is one replay of the window and the candidate table
    one replay of the table (the first case captured both)."""
    from unittest import mock

    import torch

    from light_unet_tpu_torch.core import inferencer as inferencer_mod
    from light_unet_tpu_torch.utils import fastio
    from light_unet_tpu_torch.utils.tracing import StageTimer

    inf = inferencer_mod.Inferencer(config, model_path, workdir=str(workdir), device="cuda",
                                    graphs=graphs)
    threshold = inf.config.validation.default_threshold
    if not inf.infer_case(case_id, data_dir, threshold):  # first launches, allocator
        raise AssertionError(f"serving {case_id} failed")
    timer = StageTimer()

    def timed(name, fn):
        def run(*args, **kwargs):
            with timer.time(name):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            return out
        return run

    torch.cuda.synchronize()
    with mock.patch.object(fastio, "load_f32", timed("decode (image + body mask)", fastio.load_f32)), \
            mock.patch.object(inf.sw, "prepare", timed("prepare", inf.sw.prepare)):
        inputs = inf._load_case_inputs(case_id, Path(data_dir))
    with timer.time("dispatch (enqueue)"):
        dispatched = inf._dispatch(inputs["prepared"])
    with timer.time("device work"):
        torch.cuda.synchronize()
    with mock.patch.object(inferencer_mod, "run_unit",
                           timed("candidate table", inferencer_mod.run_unit)), \
            mock.patch.object(inf.sw, "fetch", timed("fetch", inf.sw.fetch)), \
            mock.patch.object(inferencer_mod.nifti, "save", timed("NIfTI write",
                                                                  inferencer_mod.nifti.save)), \
            mock.patch.object(inferencer_mod.json, "dump", timed("JSON write",
                                                                 inferencer_mod.json.dump)):
        if not inf._finalize_case(case_id, inputs, dispatched, threshold):
            raise AssertionError(f"finalizing {case_id} failed")
    return report_stages(timer, f"one serving case ({case_id}, fused_block, "
                                f"{'graphed' if graphs else 'eager'}), serially")


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


# training.mixed_domains of configs/unet_mixed_fl_dlbcl.yaml (the card machine has no PyYAML)
MIXED_DOMAINS = {"enabled": True, "mode": "fl_epoch_plus_dlbcl", "fl_ratio": 0.5,
                 "dlbcl_ratio": 0.5, "dlbcl_steps": None, "dlbcl_steps_ratio": 1.0}


def mixed_train_config(data_dir: Path, splits: Path, **over) -> dict:
    """``configs/unet_mixed_fl_dlbcl.yaml`` (``unet_fl70.yaml`` with
    ``training.mixed_domains`` on): ``train_config`` with the YAML's mixed
    block and 1 epoch."""
    cfg = train_config(data_dir, splits, **over)
    cfg["training"] = {**cfg["training"], "epochs": 1,
                       "mixed_domains": {**MIXED_DOMAINS, **cfg["training"].get("mixed_domains", {})}}
    return cfg


def write_splits(splits: Path, train: list, val: list) -> None:
    splits.mkdir(parents=True, exist_ok=True)
    for name, ids in (("train", train), ("val", val), ("test", [])):
        (splits / f"{name}_list.txt").write_text("".join(f"{i}\n" for i in ids))


def first_step_agreement(data_dir: Path, splits: Path, workdir: Path, config=None,
                         loader: str = "train_loader", lesion: bool = False) -> float:
    """One float32 training step (augmentation and dropout off, TF32 off) on
    the card and on the CPU from the same weights and the same corners of
    ``loader`` (``config``: ``train_config`` or ``mixed_train_config``;
    ``lesion``: corners drawn until the batch holds lesion voxels, so that
    the loss is not the all-background value); returns the relative loss
    difference."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import Trainer
    from light_unet_tpu_torch.datasets.device_corpus import gather_patches

    off = {k: {"enabled": False} for k in ("random_flip", "random_rotation", "random_scale",
                                          "intensity_shift", "gaussian_noise")}
    cfg = (config or train_config)(data_dir, splits, tpu={"compute_dtype": "float32",
                                                          "use_pallas": False},
                                   model={"use_dropout": False}, augmentation=off)
    card = Trainer(Config.from_dict(cfg), workdir=str(workdir / "card"), device="cuda")
    cpu = Trainer(Config.from_dict(cfg), workdir=str(workdir / "cpu"), device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    corners = getattr(card, loader).sample_corners()
    patch = tuple(card.config.data.patch_size)

    def lesion_voxels(c):
        labels = gather_patches(card.corpus.images, card.corpus.labels,
                                torch.from_numpy(c).cuda(), patch)[1]
        return int(labels.sum())

    for _ in range(50 if lesion else 0):
        if lesion_voxels(corners):
            break
        corners = getattr(card, loader).sample_corners()
    if lesion and not lesion_voxels(corners):
        raise AssertionError(f"no {loader} batch with lesion voxels in 50 draws")
    for t in (card, cpu):
        t.model.train()
        t._set_lr(t.scheduler.current_lr())
    t0 = time.perf_counter()
    loss_card = float(card._step_on_batch(corners))
    t1 = time.perf_counter()
    loss_cpu = float(cpu._step_on_batch(corners))
    t2 = time.perf_counter()
    rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    what = (f"float32 {loader} step (corpus rows {sorted(set(corners[:, 0].tolist()))}, "
            f"{lesion_voxels(corners)} lesion voxels)" if lesion else "first float32 step")
    log(f"  {what}: card loss {loss_card:.8f} ({(t1 - t0) * 1e3:.0f} ms with its "
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


def count_launches(trainer) -> tuple:
    """Wrap ``trainer.train_epoch`` and ``trainer.validate`` so that each
    call adds its norm- and block-kernel launches (and, in training, the
    plain block's calls) to the returned counts and its seconds, between
    two synchronizations, to the returned lists."""
    import torch

    from light_unet_tpu_torch.ops import block_kernel, norm_kernel

    launches = {"train": dict(norm=0, block=0, plain_block=0), "val": dict(norm=0, block=0)}
    epoch_s, val_s = [], []

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

    trainer.train_epoch = counted(trainer.train_epoch, "train", epoch_s)
    trainer.validate = counted(trainer.validate, "val", val_s)
    return launches, epoch_s, val_s


def short_key(key: tuple) -> tuple:
    """A graph key for the log: a training unit's key without its mode flag,
    a per-volume unit's name and the shape of its first input."""
    if key[0] in ("chain", "step", "host"):
        return key[:-1]
    return key[0], key[-1][0][0]


def log_graphs(runner, what: str) -> None:
    """A ``GraphRunner``'s keys, warm-up and capture seconds, replays and pool."""
    keys = {short_key(k): (round(runner.warmup_seconds[k], 3), round(runner.capture_seconds[k], 3))
            for k in runner.graphs}
    log(f"  {what} graphs: {len(keys)} keys (key: warm-up s, capture s) {keys}; "
        f"{runner.replays} replays; pool {runner.pool_bytes / 2**30:.2f} GiB")


def unit_keys(steps: int, k: int) -> set:
    """The graph keys of ``steps`` corpus steps grouped K at a time: the
    chain, and the tail (a shorter chain, or the single step)."""
    want = {("chain", k) if k > 1 else ("step",)} if steps >= k else set()
    tail = steps % k
    if tail:
        want.add(("chain", tail) if tail > 1 else ("step",))
    return want


def check_graphs(trainer, steps: int) -> None:
    """The trainer ran graphed: its keys are the JAX package's variants for an
    epoch of ``steps`` corpus steps at its K, and validation replayed its
    window units."""
    want = unit_keys(steps, trainer._chain)
    got = {key[:-1] for key in trainer.graphs.graphs}
    log_graphs(trainer.graphs, "training")
    log_graphs(trainer.sw.graphs, "validation window")
    if trainer._val_sweep is not None and trainer._val_sweep.graphs is not None:
        log_graphs(trainer._val_sweep.graphs, "validation sweep")
    if got != want or not trainer.graphs.replays or not trainer.sw.graphs.replays:
        raise AssertionError(f"training graph keys {got}, want {want}; replays "
                             f"{trainer.graphs.replays}, window {trainer.sw.graphs.replays}")


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
    sampler = trainer.train_loader.sampler
    log(f"  trainer built in {time.perf_counter() - t0:.1f} s: {steps} steps per epoch (batch "
        f"{cfg.training.batch_size}, {len(sampler)} pre-sampled locations in "
        f"{len(sampler.cases)} cases), corpus {trainer.corpus.per_chip_bytes / 2**20:.1f} MiB "
        f"on the card, K = {trainer._chain} steps per dispatch")
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    launches, epoch_s, val_s = count_launches(trainer)
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
    check_graphs(trainer, steps)
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


def mixed_phase(tmp: Path, data_dir: Path, fl_ids: list, smi: str) -> int:
    """Mixed FL + DLBCL training on the card: two DLBCL phantoms preprocessed
    into the tree, run A (the shipped ``fl_epoch_plus_dlbcl`` config, one
    epoch + validation through ``Trainer.train``, then resume), run B
    (``probabilistic``, one epoch through ``Trainer.train_epoch``), one
    float32 DLBCL step against the CPU.  Returns the norm-kernel launches of
    run A's validation."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import Trainer
    from light_unet_tpu_torch.datasets.loader import _domains_dict
    from light_unet_tpu_torch.datasets.patch_sampler import MixedPatchSampler
    from light_unet_tpu_torch.datasets.volume_cache import VolumeCache
    from light_unet_tpu_torch.ops import block_kernel, norm_kernel
    from light_unet_tpu_torch.pipeline.preprocess import run_preprocess

    t0 = time.perf_counter()
    raw, dl_splits = tmp / "raw_dlbcl", tmp / "dlbcl_splits"
    dlbcl = write_raw_cases(raw, seed=1, ids=["1001", "1002"])
    write_splits(dl_splits, [], dlbcl)
    pre = run_preprocess(Config.from_dict(SERVING), raw, data_dir, dl_splits, split="val",
                         device="cuda")["val"]
    if pre["successful"] != len(dlbcl) or pre["failed"]:
        raise AssertionError(f"DLBCL preprocess failed: {pre['failed_cases']}")
    log(f"  DLBCL phantoms {dlbcl} written and preprocessed on the card in "
        f"{time.perf_counter() - t0:.1f} s ({pre['seconds'] / len(dlbcl):.2f} s per case "
        f"preprocess) on {smi}")
    splits, work = tmp / "mixed_splits", tmp / "mixed"
    write_splits(splits, fl_ids[:2] + dlbcl, fl_ids[2:])

    # run A: configs/unet_mixed_fl_dlbcl.yaml (fl_epoch_plus_dlbcl, ratio 1.0)
    cfg = Config.from_dict(mixed_train_config(data_dir, splits))
    t0 = time.perf_counter()
    trainer = Trainer(cfg, workdir=str(work), device="cuda")
    fl_batches = len(trainer.fl_loader)
    want_dlbcl = round(fl_batches * cfg.training.mixed_domains.dlbcl_steps_ratio)
    log(f"  run A ({trainer.mode}) built in {time.perf_counter() - t0:.1f} s: "
        f"{fl_batches} FL batches ({len(trainer.fl_loader.sampler)} locations), "
        f"{len(trainer.dlbcl_loader)} DLBCL batches ({len(trainer.dlbcl_loader.sampler)} "
        f"locations), corpus {trainer.corpus.n_cases} cases "
        f"{trainer.corpus.per_chip_bytes / 2**20:.1f} MiB, K = {trainer._chain}")
    launches, epoch_s, val_s = count_launches(trainer)
    spans, losses = [], []
    units, flatten = trainer._dispatch_units, trainer._flatten_losses

    def timed_units(loader):  # one span per domain, synchronized at its end
        torch.cuda.synchronize()
        t, n = time.perf_counter(), 0
        for unit in units(loader):
            n += trainer._unit_steps(unit)
            yield unit
        torch.cuda.synchronize()
        spans.append((n, time.perf_counter() - t))

    trainer._dispatch_units = timed_units
    trainer._flatten_losses = lambda device_losses: losses.append(flatten(device_losses)) or losses[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    block_kernel.launches = block_kernel.plain_calls = norm_kernel.launches = 0
    result = trainer.train()
    peak = torch.cuda.max_memory_allocated()
    (n_fl, fl_s), (n_dl, dl_s) = spans
    fb = trainer.val_fallback_history[0]
    log(f"  run A: FL {n_fl} steps {fl_s / n_fl * 1e3:.2f} ms/step, DLBCL {n_dl} steps "
        f"{dl_s / n_dl * 1e3:.2f} ms/step (epoch {epoch_s[0]:.2f} s); loss "
        f"{trainer.history['train_loss'][0]:.5f} (FL {np.mean(losses[0]):.5f}, DLBCL "
        f"{np.mean(losses[1]):.5f}); validation {val_s[0]:.2f} s = {val_s[0] / fb['n_cases']:.2f} "
        f"s/case (device sweep {fb['device']}, escalated {fb['escalated']}, host {fb['host']}), "
        f"recall {trainer.history['val_recall'][0]:.3f}, dsc {trainer.history['val_dsc'][0]:.4f}; "
        f"peak device memory {peak / 2**30:.2f} GiB; launches in training steps "
        f"{launches['train']}, in validation {launches['val']} on {smi}")
    if (n_fl, n_dl) != (fl_batches, want_dlbcl) or [len(v) for v in losses] != [n_fl, n_dl]:
        raise AssertionError(f"steps FL {n_fl} DLBCL {n_dl}, want {fl_batches} and {want_dlbcl}")
    if not all(np.isfinite(v).all() for v in losses) or result["skipped_steps_total"]:
        raise AssertionError(f"mixed losses not finite ({result['skipped_steps_total']} skipped)")
    if launches["train"] != dict(norm=0, block=0, plain_block=0) or launches["val"]["norm"] == 0:
        raise AssertionError(f"kernel launches: training {launches['train']}, "
                             f"validation {launches['val']}")
    log_graphs(trainer.graphs, "run A training (both domains)")
    want = unit_keys(n_fl, trainer._chain) | unit_keys(n_dl, trainer._chain)
    if not trainer.graphs.replays or {k[:-1] for k in trainer.graphs.graphs} != want:
        raise AssertionError(f"run A graph keys {list(trainer.graphs.graphs)}, want {want}")
    ckpts = sorted(p.name for p in (work / "models/checkpoints").glob("*.ckpt"))
    if ckpts != ["checkpoint_epoch_001.ckpt"] or not (work / cfg.output.best_model_path).exists():
        raise AssertionError(f"checkpoints {ckpts}, best model missing?")
    fresh = Trainer(cfg, workdir=str(work), device="cuda")
    same = [a.bit_generator.state == b.bit_generator.state
            for a, b in zip(fresh.streams, trainer.streams)] if fresh.resume() else []
    if (same != [True, True] or int(fresh.opt.count) != int(trainer.opt.count)
            or not torch.equal(fresh.gen.get_state(), trainer.gen.get_state())):
        raise AssertionError(f"resume: streams equal {same}, step {int(fresh.opt.count)} vs "
                             f"{int(trainer.opt.count)}")
    log(f"  run A: checkpoints {ckpts} and {cfg.output.best_model_path}; a fresh trainer resumes "
        f"at epoch {fresh.start_epoch + 1} with both sampler streams, the generator and the "
        f"optimizer step ({int(fresh.opt.count)}) equal")
    fresh.writer.close()
    del trainer, fresh
    torch.cuda.empty_cache()

    # run B: probabilistic, one epoch
    cfg_b = Config.from_dict(mixed_train_config(
        data_dir, splits, training={"mixed_domains": {"mode": "probabilistic"}}))
    prob = Trainer(cfg_b, workdir=str(tmp / "mixed_prob"), device="cuda")
    steps = len(prob.train_loader)
    prob._set_lr(prob.scheduler.current_lr())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss = prob.train_epoch(0)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = prob.train_dataset.get_sample_counts()
    ref = MixedPatchSampler(data_dir, splits / "train_list.txt", tuple(cfg_b.data.patch_size),
                            cfg_b.training.class_balanced_sampling.lesion_patch_ratio,
                            cfg_b.experiment.seed, _domains_dict(cfg_b),
                            cfg_b.training.mixed_domains.fl_ratio, cfg_b.data.body_mask,
                            VolumeCache())
    for _ in range(steps * cfg_b.training.batch_size):
        ref.draw_index()
    log(f"  run B (probabilistic): one epoch, {steps} steps (K = {prob._chain}) in "
        f"{seconds:.2f} s = {seconds / steps * 1e3:.2f} ms/step, loss "
        f"{loss:.5f}; samples FL {counts['fl_samples']} + DLBCL {counts['dlbcl_samples']}, the "
        f"CPU sampler's {ref.get_sample_counts()} on {smi}")
    if (counts["total_samples"] != steps * cfg_b.training.batch_size
            or counts != ref.get_sample_counts() or not np.isfinite(loss)):
        raise AssertionError(f"probabilistic counts {counts} vs {ref.get_sample_counts()}, "
                             f"loss {loss}")
    prob.writer.close()
    del prob
    first_step_agreement(data_dir, splits, tmp / "mixed_step", config=mixed_train_config,
                         loader="dlbcl_loader", lesion=True)
    torch.cuda.empty_cache()
    return launches["val"]["norm"]


def graph_trainer(data_dir: Path, splits: Path, workdir: Path, graphs: bool, **tpu):
    """Phase 8's configuration (``train_config``, ``tpu`` overrides), graphed
    or with the eager step (``graphs=False``), in train mode at its first
    rate."""
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import Trainer

    tr = Trainer(Config.from_dict(train_config(data_dir, splits, tpu=tpu)),
                 workdir=str(workdir), device="cuda", graphs=graphs)
    if (tr.graphs is not None) != graphs:
        raise AssertionError(f"graphs={graphs} built runner {tr.graphs}")
    tr.model.train()
    tr._set_lr(tr.scheduler.current_lr())
    return tr


def plant_nonfinite(tr) -> int:
    """One corpus row more (before any capture), with labels of 2, and a loss
    that is NaN for a batch holding such labels: a non-finite step that
    ``GuardedAdamW`` skips.  Returns the row."""
    import torch

    c = tr.corpus
    c.images = torch.cat([c.images, c.images[:1]])
    c.labels = torch.cat([c.labels, torch.full_like(c.labels[:1], 2)])
    base = tr.loss_fn

    def loss_fn(probs, labels):
        # a constant NaN added: the gradients stay finite, the loss does not
        nan = torch.where((labels > 1).any(), float("nan"), 0.0)
        return base(probs, labels) + nan

    tr.loss_fn = loss_fn
    return c.images.shape[0] - 1


def agreement_run(data_dir: Path, splits: Path, workdir: Path, graphs: bool) -> dict:
    """Phase 8's configuration in float32 (TF32 off), 15 steps as 5 units:
    chains of 4 (the second with the planted non-finite batch at its second
    step), a tail chain of 2, the single step, a chain of 4; returns the
    losses, skip flags, optimizer state, generator state and graph keys."""
    import torch

    tr = graph_trainer(data_dir, splits, workdir, graphs, compute_dtype="float32",
                       use_pallas=False)
    row = plant_nonfinite(tr)
    draw = tr.train_loader.sample_corners
    units = [np.stack([draw() for _ in range(k)]) for k in (4, 4, 2)] + [draw()]
    units.append(np.stack([draw() for _ in range(4)]))
    units[1][1, 0, 0] = row
    t0 = time.perf_counter()
    losses = tr._flatten_losses([tr._step_on_batch(u) for u in units])
    out = dict(losses=losses, seconds=time.perf_counter() - t0, gen=tr.gen.get_state(),
               oks=torch.cat([o.reshape(-1) for o in tr._epoch_oks]).cpu().tolist(),
               keys=sorted(k[:-1] for k in tr.graphs.graphs) if graphs else None,
               **{k: getattr(tr.opt, k).cpu().clone() for k in ("flat", "mu", "nu", "count")})
    tr.writer.close()
    del tr
    torch.cuda.empty_cache()
    return out


def compare_runs(a: dict, b: dict) -> dict:
    """Largest relative loss difference over b's finite steps, bit equality
    of the losses, and the largest parameter and moment differences."""
    fin = [i for i, ok in enumerate(b["oks"]) if ok == 1.0]
    rel = max([abs(a["losses"][i] - b["losses"][i]) / abs(b["losses"][i]) for i in fin]
              or [np.inf])
    bits = [a["losses"][i] for i in fin] == [b["losses"][i] for i in fin]
    return dict(rel=rel, bits=bits, **{k: float((a[k] - b[k]).abs().max())
                                       for k in ("flat", "mu", "nu")})


def graph_agreement(data_dir: Path, splits: Path, tmp: Path) -> dict:
    """12a: ``agreement_run`` graphed and eager from the same seed with
    cuDNN's deterministic algorithms: losses within 1e-5 relative,
    parameters and both moments within 1e-5 abs, skip flags, step counts
    and the generator's state equal.  Then with cuDNN's default algorithms
    (whose backward sums in a varying order): graphed against eager and
    eager against eager, logged."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        g, e = (agreement_run(data_dir, splits, tmp / f"agree_{x}", x) for x in (True, False))
    finally:
        torch.backends.cudnn.deterministic = saved
    d = compare_runs(g, e)
    log(f"  [12a] float32, 15 steps, deterministic cuDNN, graphed keys {g['keys']} vs eager: "
        f"losses rel diff {d['rel']:.3e} (bar 1e-5; bit-identical: {d['bits']}), flat / mu / nu "
        f"max abs diff {d['flat']:.3e} / {d['mu']:.3e} / {d['nu']:.3e} (bar 1e-5); skip flags "
        f"{[i for i, ok in enumerate(g['oks']) if ok == 0.0]} vs "
        f"{[i for i, ok in enumerate(e['oks']) if ok == 0.0]}; step count {int(g['count'])} vs "
        f"{int(e['count'])}; generator state equal {torch.equal(g['gen'], e['gen'])}; "
        f"{g['seconds']:.2f} s vs {e['seconds']:.2f} s (captures included)")
    if not (d["rel"] <= 1e-5 and max(d["flat"], d["mu"], d["nu"]) <= 1e-5
            and g["oks"] == e["oks"] and e["oks"].count(0.0) == 1 and e["oks"][5] == 0.0
            and int(g["count"]) == int(e["count"]) == 14 and torch.equal(g["gen"], e["gen"])
            and g["keys"] == [("chain", 2), ("chain", 4), ("step",)]):
        raise AssertionError(f"graphed and eager training differ: {d}, {g['oks']} vs "
                             f"{e['oks']}, keys {g['keys']}")
    g2, e2, e3 = (agreement_run(data_dir, splits, tmp / f"agree_default_{i}", x)
                  for i, x in enumerate((True, False, False)))
    for name, (a, b) in (("graphed vs eager", (g2, e2)), ("eager vs eager", (e3, e2))):
        d2 = compare_runs(a, b)
        log(f"  [12a] default cuDNN, {name}: losses rel diff {d2['rel']:.3e} (bit-identical: "
            f"{d2['bits']}), flat / mu / nu max abs diff {d2['flat']:.3e} / {d2['mu']:.3e} / "
            f"{d2['nu']:.3e}; skip flags equal {a['oks'] == b['oks']}")
    return d


def host_calls(prof) -> int:
    """CUDA runtime and driver calls that launch work or copy (kernel and
    graph launches, memcpy, memset) in a profile."""
    import torch

    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CPU and e.key.startswith("cu")
               and any(w in e.key for w in ("Launch", "Memcpy", "Memset")))


def graph_timing(data_dir: Path, splits: Path, tmp: Path, smi: str) -> dict:
    """12b: phase 8's configuration (bf16, K = 4), graphed and eager: one
    unit to capture (graphed) or warm up, then 6 units each synchronized
    (the median over their 24 steps), 6 back to back, 3 under
    torch.profiler (device busy share, host launch calls a unit); peak
    memory over the run."""
    import torch

    rows = {}
    for graphs in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        tr = graph_trainer(data_dir, splits, tmp / f"timing_{graphs}", graphs)
        draw = tr.train_loader.sample_corners
        units = [np.stack([draw() for _ in range(4)]) for _ in range(16)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._step_on_batch(units[0])
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        spans = []
        for u in units[1:7]:
            t0 = time.perf_counter()
            tr._step_on_batch(u)
            torch.cuda.synchronize()
            spans.append((time.perf_counter() - t0) / 4 * 1e3)
        t0 = time.perf_counter()
        for u in units[7:13]:
            tr._step_on_batch(u)
        torch.cuda.synchronize()
        b2b = (time.perf_counter() - t0) / 24 * 1e3
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            for u in units[13:]:
                tr._step_on_batch(u)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        tr._epoch_oks.clear()
        rows[graphs] = dict(
            median_ms=float(np.median(spans)), b2b_ms=b2b, first_s=first_s,
            busy=busy_ms / (wall * 1e3), busy_ms_step=busy_ms / 12, device_kinds=len(kernels),
            calls_unit=host_calls(prof) / 3, peak=torch.cuda.max_memory_allocated(),
            capture_s=sum(tr.graphs.capture_seconds.values()) if graphs else None,
            pool=tr.graphs.pool_bytes if graphs else None, profiled_ms=wall / 12 * 1e3)
        tr.writer.close()
        del tr
    for graphs, name in ((True, "graphed"), (False, "eager")):
        r = rows[graphs]
        extra = (f"; capture {r['capture_s']:.2f} s, pool {r['pool'] / 2**30:.2f} GiB"
                 if graphs else "")
        log(f"  [12b] {name}: {r['median_ms']:.2f} ms a step (median of 24 steps, each unit "
            f"synchronized), {r['b2b_ms']:.2f} ms back to back, first unit {r['first_s']:.2f} s"
            f"{extra}; profiled: {r['profiled_ms']:.2f} ms a step, device busy "
            f"{100 * r['busy']:.1f} % ({r['busy_ms_step']:.2f} ms of kernels a step, "
            f"{r['device_kinds']} kernel names), {r['calls_unit']:.0f} host launch calls a "
            f"unit of 4 steps; peak memory {r['peak'] / 2**30:.2f} GiB on {smi}")
    if not rows[True]["calls_unit"] < rows[False]["calls_unit"] / 10:
        raise AssertionError(f"graphed units still make {rows[True]['calls_unit']} host calls")
    return rows


def serpentine(depth: int, height: int, width: int) -> np.ndarray:
    """Rows along the last axis at even y, joined at alternating ends by one
    voxel at odd y, in every z-plane: the plain sweeps carry the last row's
    label one row a round (``tests/torch_ccl_masks.py`` has the same)."""
    m = np.zeros((depth, height, width), np.uint8)
    m[:, 0::2, :] = 1
    for y in range(1, height - 1, 2):
        m[:, y, width - 1 if (y // 2) % 2 == 0 else 0] = 1
    return m


def ccl_masks(closed: dict, maps: dict, shape=(144, 144, 288)) -> dict:
    """13a's masks: the closed body masks of phase 5, phase 6's served maps
    at the serving threshold, and the adversarial masks at the padded serving
    shape (a serpentine of one row a sweep round, one large blob, every
    other voxel its own component, empty, full, random)."""
    import torch

    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    c = [s / 2.0 for s in shape]
    rng = np.random.default_rng(13)
    masks = dict(closed)
    masks.update({f"served map {c} >= 0.3": torch.from_numpy((m >= 0.3).astype(np.uint8))
                  for c, m in list(maps.items())[:2]})
    adversarial = {
        "serpentine": serpentine(*shape),
        "one large blob": ((zz - c[0]) ** 2 / (c[0] - 2) ** 2 + (yy - c[1]) ** 2
                           / (c[1] - 2) ** 2 + (xx - c[2]) ** 2 / (c[2] - 4) ** 2 <= 1.0),
        "one-voxel components": (zz + yy + xx) % 2 == 0,
        "empty": np.zeros(shape, bool),
        "full": np.ones(shape, bool),
        "random 0.3": rng.random(shape) < 0.3,
        "random 0.6": rng.random(shape) < 0.6,
    }
    masks.update({k: torch.from_numpy(np.ascontiguousarray(v).astype(np.uint8))
                  for k, v in adversarial.items()})
    return masks


def ccl_phase(masks: dict, smi: str) -> tuple:
    """13a: the CCL kernel (``csrc/ccl.cu``) against its plain version (the
    sweeps) on every mask: int32 labels equal.  Timed (CUDA events) on the
    closed body masks (the body mask's call), the served maps (the candidate
    table's) and the random masks: the kernel, and on the first two the
    plain sweeps, beside the bound: the mask read (1 byte a voxel) and the
    labels written (4), at the card's memory rate.  Returns ({mask: row},
    the largest |kernel - plain| label difference over every mask)."""
    import torch

    from light_unet_tpu_torch.ops import ccl_kernel

    rows, max_err = {}, 0
    for name, mask in masks.items():
        m = mask.cuda()
        got = ccl_kernel.connected_labels(m)
        want = ccl_kernel.sweep_labels(m)
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err:
            bad = int((got != want).sum())
            raise AssertionError(f"CCL kernel and plain sweeps differ on {name}: {bad} voxels")
        seeds = torch.arange(1, m.numel() + 1, device=m.device, dtype=torch.int32)
        row = dict(rounds=ccl_rounds(m), components=int((got.reshape(-1) == seeds).sum()))
        if name.startswith(("closed body", "served map", "random")):
            row["ms"] = cuda_ms(lambda: ccl_kernel.connected_labels(m), iters=10)
            row["bound_ms"] = 5.0 * m.numel() / HBM_BYTES_PER_S * 1e3
        if name.startswith(("closed body", "served map")):
            row["plain_ms"] = cuda_ms(lambda: ccl_kernel.sweep_labels(m), iters=2, warmup=1)
        rows[name] = row
        timing = (f"; kernel {row['ms']:.3f} ms ({row['ms'] / row['bound_ms']:.1f}x its bound "
                  f"{row['bound_ms']:.4f} ms)" if "ms" in row else "")
        timing += f", plain {row['plain_ms']:.1f} ms" if "plain_ms" in row else ""
        log(f"  [13a] {name} {tuple(m.shape)}: labels equal ({row['components']} components, "
            f"plain {row['rounds']} sweep rounds){timing}")
        del m, got, want
    if max(r["rounds"] for r in rows.values()) <= 20:
        raise AssertionError("no mask needed more than 20 sweep rounds")
    timed = [r for k, r in rows.items() if k.startswith("closed body")]
    log(f"  [13a] CCL kernel on the closed body masks: {min(r['ms'] for r in timed):.3f}-"
        f"{max(r['ms'] for r in timed):.3f} ms a call, plain sweeps "
        f"{min(r['plain_ms'] for r in timed):.1f}-{max(r['plain_ms'] for r in timed):.1f} ms, "
        f"bound {timed[0]['bound_ms']:.4f} ms (bytes) on {smi}")
    return rows, max_err


def no_sync(fn, *args):
    """``fn(*args)`` with every synchronizing CUDA call an error
    (``torch.cuda.set_sync_debug_mode("error")``), after a sync, and its
    host seconds."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)


def timed_dispatch(fn, *args):
    """(output, host seconds to enqueue, device ms from the first enqueue to
    the end of the work) of one dispatch on an idle card."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = fn(*args)
    host = time.perf_counter() - t0
    end.record()
    torch.cuda.synchronize()
    return out, host, start.elapsed_time(end)


def graph_summary(runner) -> str:
    if runner is None:
        return "eager"
    return (f"warm-up {sum(runner.warmup_seconds.values()):.2f} s, capture "
            f"{sum(runner.capture_seconds.values()):.2f} s for {len(runner.graphs)} key(s), pool "
            f"{runner.pool_bytes / 2**30:.2f} GiB, {runner.replays} replays")


def route_model(state: dict, gates: dict, dtype):
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.models.fused_forward import make_fused_apply
    from light_unet_tpu_torch.models.unet3d import build_model

    model = build_model(Config.from_dict(SERVING).model, dtype, inference=True,
                        use_pallas=gates["use_pallas"])
    model.load_state_dict(state, strict=True)
    model = model.cuda().eval()
    return make_fused_apply(model) if gates["fused_block"] else model


def units_phase(state: dict, data_dir: Path, ids: list, raw_paths: list, smi: str) -> dict:
    """13b-e: each per-volume unit graphed (one replay) and eager
    (``graphs=False``), bit-identical, per route and in bf16 and float32:
    the serving window (uint16 in and out, sparse fetch, packed body mask)
    and its candidate table, the fused program, then the preprocess pass and
    the validation sweep.  The first graphed dispatch of a key captures it;
    the next volume's dispatch is a replay run under
    ``set_sync_debug_mode("error")``.  Logged: host ms to dispatch a volume
    and device ms, graphed and eager; capture seconds and pool a key."""
    import functools

    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.inferencer import MAX_DEVICE_COMPONENTS, table_unit
    from light_unet_tpu_torch.ops import fused
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer
    from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
    from light_unet_tpu_torch.utils import fastio
    from light_unet_tpu_torch.utils.device import precision_scope
    from light_unet_tpu_torch.utils.graphs import run_unit, runner_for, unit_key

    tpu = SERVING["tpu"]
    vols = [fastio.load_f32(data_dir / f"images/{c}_0000.nii.gz")[0] for c in ids[:2]]
    bodies = [fastio.load_f32(data_dir / f"body_masks/{c}.nii.gz")[0] for c in ids[:2]]
    raws = [fastio.load_f32(p)[0] for p in raw_paths[:2]]
    cfg = Config.from_dict(SERVING)
    thr = torch.full((), 0.3, device="cuda")
    table = functools.partial(table_unit, max_components=MAX_DEVICE_COMPONENTS)
    rows, served = [], None

    def run_pair(make, prepare, dispatch, result):
        """Graphed (capture on volume 0, replay on volume 1 without a sync)
        then eager on volume 1: (equal, {graphed/eager: host ms, device ms},
        graphed runner summary, graphed outputs)."""
        out, times, summary = {}, {}, ""
        for graphs in (True, False):
            engine = make(graphs)
            preps = [prepare(engine, i) for i in (0, 1)]
            if graphs:
                dispatch(engine, preps[0])
                no_sync(dispatch, engine, preps[1])  # the replay: no host sync inside
            res, host, dev = timed_dispatch(dispatch, engine, preps[1])
            out[graphs] = result(res)
            times[graphs] = (host * 1e3, dev)
            if graphs:
                summary = graph_summary(engine.graphs)
            del engine, preps, res
            torch.cuda.empty_cache()
        same = all(torch.equal(a, b) for a, b in zip(out[True], out[False]))
        return same, times, summary, out[True]

    for route, gates in GATES:
        for dtype in (torch.bfloat16, torch.float32):
            apply_fn = route_model(state, gates, dtype)
            dname = "bf16" if dtype == torch.bfloat16 else "f32"
            with torch.no_grad(), precision_scope(dtype):
                def make_sw(graphs):
                    return SlidingWindowInferencer(
                        apply_fn, SERVING["data"]["patch_size"], 0.5, tpu["patch_batch"],
                        tpu["z_bucket"], "uint16", "uint16", sparse_fetch=True,
                        host_prefetch=False, graphs=graphs, device="cuda")

                same, times, summary, graphed = run_pair(
                    make_sw, lambda e, i: e.prepare(vols[i], bodies[i]),
                    lambda e, p: e.dispatch(p),
                    lambda res: tuple(t for t in res[0] if isinstance(t, torch.Tensor)))
                # the candidate table of the same map, graphed and eager
                runner = runner_for(torch.device("cuda"), True, "table")
                key = unit_key("table", max_components=MAX_DEVICE_COMPONENTS)
                run_unit(runner, key, table, graphed[0], thr)
                tab_g, _ = no_sync(run_unit, runner, key, table, graphed[0], thr)
                tab_e = run_unit(None, key, table, graphed[0], thr)
                tab_same = all(torch.equal(a, b) for a, b in zip(tab_g, tab_e))
                _, tab_host_g, tab_dev_g = timed_dispatch(run_unit, runner, key, table,
                                                          graphed[0], thr)
                _, tab_host_e, tab_dev_e = timed_dispatch(run_unit, None, key, table,
                                                          graphed[0], thr)
                if route == "fused_block" and dtype == torch.bfloat16:
                    served = graphed[0]
                    profile_unit(lambda: run_unit(None, key, table, served, thr),
                                 f"candidate table ({tuple(served.shape)}, cap "
                                 f"{MAX_DEVICE_COMPONENTS})")
                rows.append(dict(unit="window", route=route, dtype=dname, same=same,
                                 times=times))
                rows.append(dict(unit="table", route=route, dtype=dname, same=tab_same,
                                 times={True: (tab_host_g * 1e3, tab_dev_g),
                                        False: (tab_host_e * 1e3, tab_dev_e)}))
                log(f"  [13b] serving window, {route} {dname}: graphed vs eager bit-identical "
                    f"{same}; host ms to dispatch a volume {times[True][0]:.2f} vs "
                    f"{times[False][0]:.2f}, device ms {times[True][1]:.1f} vs "
                    f"{times[False][1]:.1f}; {summary}; candidate table bit-identical "
                    f"{tab_same}, host ms {tab_host_g * 1e3:.2f} vs {tab_host_e * 1e3:.2f}, device "
                    f"ms {tab_dev_g:.2f} vs {tab_dev_e:.2f}; {graph_summary(runner)} on {smi}")
                del runner

                pcfg = Config.from_dict(SERVING)
                pcfg.tpu.compute_dtype = "bfloat16" if dtype == torch.bfloat16 else "float32"

                def make_fused(graphs):
                    return FusedVolumePipeline(apply_fn, pcfg, patch_batch=tpu["patch_batch"],
                                               host_prefetch=False, graphs=graphs, device="cuda")

                same, times, summary, _ = run_pair(
                    make_fused, lambda e, i: e.prepare(raws[i]), lambda e, p: e.dispatch(p),
                    lambda res: tuple(t for t in res[0] if isinstance(t, torch.Tensor)))
                rows.append(dict(unit="fused", route=route, dtype=dname, same=same, times=times))
                log(f"  [13c] fused program, {route} {dname}: graphed vs eager bit-identical "
                    f"(map, tile count, tiles) {same}; host ms to dispatch a volume "
                    f"{times[True][0]:.2f} vs {times[False][0]:.2f}, device ms "
                    f"{times[True][1]:.1f} vs {times[False][1]:.1f}; {summary} on {smi}")
            del apply_fn
            torch.cuda.empty_cache()

    # 13d: the preprocess pass (no network)
    class Pass:  # the preprocess pass as an engine with a runner, for run_pair
        def __init__(self, graphs):
            self.graphs = runner_for(torch.device("cuda"), graphs, "preprocess")

    same, times, summary, _ = run_pair(
        Pass, lambda e, i: fused.prepare_preprocess(raws[i], cfg.data.intensity,
                                                     tpu["z_bucket"], "cuda"),
        lambda e, p: fused.dispatch_preprocess(p, cfg.data.intensity, cfg.data.body_mask,
                                               e.graphs),
        lambda res: res)
    rows.append(dict(unit="preprocess", route="-", dtype="f32", same=same, times=times))
    log(f"  [13d] preprocess pass (normalize, body mask, counts): graphed vs eager bit-identical "
        f"{same}; host ms to dispatch a volume {times[True][0]:.2f} vs {times[False][0]:.2f}, "
        f"device ms {times[True][1]:.1f} vs {times[False][1]:.1f}; {summary} on {smi}")

    # 13e: the validation sweep on the served map (every threshold in one unit)
    label = fastio.load_f32(data_dir / f"labels/{ids[1]}.nii.gz")[0]
    gt = np.zeros(served.shape, np.uint8)
    gt[: label.shape[0], : label.shape[1], : label.shape[2]] = label > 0.5
    gt = torch.from_numpy(gt).cuda()
    thresholds = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9]

    def make_sweep(graphs, cap=4096):  # the trainer's cap, and its 4x escalation tier
        return DeviceValidationSweep(thresholds, max_components=cap, graphs=graphs,
                                     device="cuda")

    same, times, summary, _ = run_pair(make_sweep, lambda e, i: served,
                                       lambda e, p: e.tables(p, gt), lambda res: res)
    rows.append(dict(unit="sweep", route="-", dtype="-", same=same, times=times))
    big = make_sweep(True, 4 * 4096)
    big.tables(served, gt)
    _, big_host, big_dev = timed_dispatch(big.tables, served, gt)
    log(f"  [13e] validation sweep, {len(thresholds)} thresholds in one unit, cap 4096 (the "
        f"trainer's): graphed vs eager bit-identical {same}; host ms {times[True][0]:.2f} vs "
        f"{times[False][0]:.2f}, device ms {times[True][1]:.1f} vs {times[False][1]:.1f} "
        f"({times[True][1] / len(thresholds):.2f} ms a threshold graphed); {summary}; cap 16384 "
        f"(the escalation tier) graphed: host ms {big_host * 1e3:.2f}, device ms {big_dev:.1f} "
        f"({big_dev / len(thresholds):.2f} ms a threshold) on {smi}")
    del big
    profile_unit(lambda: make_sweep(False).tables(served, gt),
                 f"validation sweep ({len(thresholds)} thresholds, cap 4096)")
    bad = [(r["unit"], r["route"], r["dtype"]) for r in rows if not r["same"]]
    if bad:
        raise AssertionError(f"graphed and eager differ: {bad}")
    return rows


def serving_ab(cfg: dict, model_path: Path, data_dir: Path, split: Path, tmp: Path,
               reference: dict, smi: str) -> None:
    """13f: serving graphed and eager under the same conditions: one
    ``Inferencer`` each, both warmed by a first pass (the graphed one
    captures its keys there), then timed passes in the order graphed,
    eager, eager, graphed.  The maps of every pass equal phase 6's."""
    from light_unet_tpu_torch.core.inferencer import Inferencer

    infs = {g: Inferencer(cfg, model_path, workdir=str(tmp / f"serve_ab_{g}"), device="cuda",
                          graphs=g) for g in (True, False)}
    warm = {g: serve_with(inf, data_dir, split, tmp / f"serve_ab_{g}")[0]
            for g, inf in infs.items()}
    rates = {True: [], False: []}
    for g in (True, False, False, True):
        vps, maps = serve_with(infs[g], data_dir, split, tmp / f"serve_ab_{g}")
        if not all(np.array_equal(maps[c], reference[c]) for c in reference):
            raise AssertionError(f"{'graphed' if g else 'eager'} serving maps differ from phase 6's")
        rates[g].append(vps)

    def fmt(xs):
        return ", ".join(f"{x:.3f}" for x in xs)

    log(f"  [13f] serving, fused_block, {N_CASES} cases a pass, one Inferencer each, warmed "
        f"(first pass: graphed {warm[True]:.3f}, eager {warm[False]:.3f} vol/s); passes "
        f"g e e g: graphed {fmt(rates[True])} (mean {np.mean(rates[True]):.3f}), eager "
        f"{fmt(rates[False])} (mean {np.mean(rates[False]):.3f}) vol/s; maps equal phase 6's "
        f"on {smi}")


# phase 14: a cohort of mixed z extents (z_bucket 48 pads them to z 240, 288,
# 336 and 384: 225, 275, 325 and 375 windows), one of another in-plane size
BUCKET_CASES = {"0021": (144, 144, 240), "0022": (144, 144, 272), "0023": (160, 160, 312),
                "0024": (144, 144, 360)}
# the serving orders of phase 14's passes (the first one captures)
BUCKET_ORDERS = [(0, 1, 2, 3), (3, 2, 1, 0), (1, 3, 0, 2)]
# (name, gates, compute dtype) of phase 14's routes
BUCKET_ROUTES = [("fused_block", {"fused_block": True, "use_pallas": False}, "bfloat16"),
                 ("use_pallas", {"fused_block": False, "use_pallas": True}, "bfloat16"),
                 ("plain", {"fused_block": False, "use_pallas": False}, "float32")]


def gib(n: int) -> str:
    return f"{n / 2**30:.2f}"


def log_captures(records, what: str) -> None:
    """One line a captured key (``utils/graphs.py:captures``): runner, its
    first input's shape, warm-up and capture seconds, the pool's growth, and
    the device's reserved and peak allocated memory after the capture."""
    for c in records:
        log(f"    [{what}] {c.runner}#{c.serial} key {c.key[-1][0][0]}: warm-up "
            f"{c.warmup_s:.2f} s, capture {c.capture_s:.2f} s, pool +{gib(c.pool_bytes)} GiB; "
            f"reserved {gib(c.reserved)} GiB, peak allocated {gib(c.peak)} GiB")


def bucket_serve(inf, data_dir: Path, order: list, split: Path) -> tuple:
    """One ``infer_split`` pass of ``inf`` over ``order``: ({case: (map,
    bbox JSON text, candidate table on the host)}, seconds)."""
    from unittest import mock

    import torch

    from light_unet_tpu_torch.core import inferencer as inferencer_mod
    from light_unet_tpu_torch.utils import nifti

    split.write_text("\n".join(order) + "\n")
    tables, pending = {}, list(order)
    real = inferencer_mod.run_unit

    def record(*args):  # the table unit runs once a case, in the split's order
        out = real(*args)
        tables[pending.pop(0)] = [t.cpu() for t in out]
        return out

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with mock.patch.object(inferencer_mod, "run_unit", record):
        result = inf.infer_split(split, data_dir)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if result["failed"] or result["successful"] != len(order):
        raise AssertionError(f"serving {order} failed: {result}")
    out = {cid: (nifti.load(inf.prob_maps_dir / f"{cid}_prob.nii.gz").get_fdata(np.float32),
                 (inf.bboxes_dir / f"{cid}_bboxes.json").read_text(), tables[cid])
           for cid in order}
    return out, seconds


def same_serving(a: dict, b: dict) -> bool:
    """Every map, bbox JSON and candidate table bit-identical."""
    import torch

    return a.keys() == b.keys() and all(
        np.array_equal(a[c][0], b[c][0]) and a[c][1] == b[c][1]
        and all(torch.equal(x, y) for x, y in zip(a[c][2], b[c][2])) for c in a)


def bucket_route(name: str, gates: dict, dtype: str, state: dict, model_path: Path,
                 data_dir: Path, raw_paths: dict, work: Path, smi: str) -> tuple:
    """14a-d for one route: serving and the fused pipeline over the four
    buckets, graphed in three orders and eagerly; returns ({case: served
    map}, {case: fused map}, launches, peak reserved bytes)."""
    import gc

    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.ops import block_kernel, ccl_kernel, norm_kernel
    from light_unet_tpu_torch.utils import graphs, nifti
    from light_unet_tpu_torch.utils.hbm_ledger import HbmLedger

    cfg = json.loads(json.dumps(SERVING))
    cfg["tpu"].update(gates, compute_dtype=dtype)
    ids = list(BUCKET_CASES)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    start_reserved = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    first = len(graphs.captures)
    block_kernel.launches = block_kernel.plain_calls = norm_kernel.launches = 0
    ccl_kernel.launches = 0
    ledger = HbmLedger(device="cuda")
    t_route = time.perf_counter()

    # (a) one graphed Inferencer, the buckets in three orders
    inf = Inferencer(cfg, model_path, workdir=str(work / "graphed"), device="cuda")
    inf.sw.graphs.ledger = inf.table_graphs.ledger = ledger
    passes, seconds = [], []
    for k, order in enumerate(BUCKET_ORDERS):
        out, sec = bucket_serve(inf, data_dir, [ids[i] for i in order], work / f"order{k}.txt")
        passes.append(out)
        seconds.append(sec)
    keys = (len(inf.sw.graphs.graphs), len(inf.table_graphs.graphs))
    if keys != (4, 4):
        raise AssertionError(f"{name}: window and table keys {keys}, not one a bucket")
    reordered = [same_serving(passes[0], p) for p in passes[1:]]
    # (b) eagerly
    eager = Inferencer(cfg, model_path, workdir=str(work / "eager"), device="cuda", graphs=False)
    ref, eager_s = bucket_serve(eager, data_dir, ids, work / "eager.txt")
    eager_same = same_serving(passes[0], ref)
    # (c) exactly 0 outside the body mask
    for cid in ids:
        body = nifti.load(data_dir / f"body_masks/{cid}.nii.gz").get_fdata(np.float32) > 0.5
        m = passes[0][cid][0]
        if m.shape != BUCKET_CASES[cid] or not np.isfinite(m).all() or np.any(m[~body] != 0):
            raise AssertionError(f"{name}: served map {cid} {m.shape} not 0 outside the body mask")
    served = {cid: passes[0][cid][0] for cid in ids}
    log(f"  [14a] serving, {name} {dtype}: passes in orders {BUCKET_ORDERS} took "
        f"{', '.join(f'{s:.2f}' for s in seconds)} s (the first captures 4 window and 4 table "
        f"keys); later orders bit-identical to the first (maps, tables, bbox JSON) {reordered}; "
        f"[14b] eager {eager_s:.2f} s, bit-identical to graphed {eager_same}; maps 0 outside the "
        f"body mask")
    del eager, ref

    # the fused pipeline over the raw volumes, graphed in the same three orders, then eager
    pcfg = Config.from_dict(cfg)
    pipe = fused_pipeline(pcfg, state)
    pipe.graphs.ledger = ledger
    fused_maps, fused_s, preps = [], [], {}
    for order in BUCKET_ORDERS:
        paths = [raw_paths[ids[i]] for i in order]
        sec, maps, preps = fused_pass(pipe, paths)
        fused_maps.append({p.name.split("_")[0]: m for p, m in zip(paths, maps)})
        fused_s.append(sec)
    if len(pipe.graphs.graphs) != 4:
        raise AssertionError(f"{name}: {len(pipe.graphs.graphs)} fused keys, not 4")
    check_zero_outside_body(pcfg, fused_maps[0], preps)
    fused_reordered = [all(np.array_equal(fused_maps[0][c], f[c]) for c in ids)
                       for f in fused_maps[1:]]
    pipe_e = fused_pipeline(pcfg, state, graphs=False)
    _, maps, _ = fused_pass(pipe_e, [raw_paths[c] for c in ids])
    fused_eager = all(np.array_equal(fused_maps[0][c], m) for c, m in zip(ids, maps))
    log(f"  [14a] fused pipeline, {name} {dtype}: passes {', '.join(f'{s:.2f}' for s in fused_s)} "
        f"s; later orders bit-identical {fused_reordered}; [14b] eager bit-identical "
        f"{fused_eager}; maps 0 outside the card's body mask")
    if not all(reordered + fused_reordered) or not (eager_same and fused_eager):
        raise AssertionError(f"{name}: a replay order or the eager path changed a result")
    launches = dict(block=block_kernel.launches, plain_block=block_kernel.plain_calls,
                    norm=norm_kernel.launches, ccl=ccl_kernel.launches)

    # (d) what each key cost, and what releasing the route gives back
    log_captures(graphs.captures[first:], name)
    peak_reserved = torch.cuda.memory_stats()["reserved_bytes.all.peak"]
    reserved = torch.cuda.memory_reserved()
    log(f"  [14d] {name}: {ledger.summary()}; reserved {gib(start_reserved)} GiB at the start, "
        f"peak reserved {gib(peak_reserved)} GiB, peak allocated "
        f"{gib(torch.cuda.max_memory_allocated())} GiB; route "
        f"{time.perf_counter() - t_route:.1f} s; launches {launches} on {smi}")
    del inf, pipe, pipe_e, preps, passes
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"  [14d] {name} released: reserved {gib(reserved)} -> "
        f"{gib(torch.cuda.memory_reserved())} GiB")
    return served, fused_maps[0], launches, peak_reserved


def bucket_sweeps(cfg, maps: dict, maps_dir: Path, data_dir: Path, smi: str) -> None:
    """14e: ``DeviceValidationSweep`` over the served maps of the four
    buckets with their labels (each map padded to its bucket, as
    ``run_evaluate`` pads it; one graphed key a bucket): at the trainer's cap
    (4096) graphed and eager, and at its 4x tier, each taking the same path
    (device, or the host path on overflow) and, where the device path ran,
    the host path's counts; the graphed and eager tables bit-identical; and
    at a cap that holds the random model's speckled maps (up to ~2e5
    components a threshold), the device path on every bucket with the host
    path's counts."""
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    import torch

    from light_unet_tpu_torch.ops.intensity import pad_volume
    from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
    from light_unet_tpu_torch.pipeline.evaluate import _device_case_results, evaluate_case
    from light_unet_tpu_torch.utils import graphs, nifti

    thresholds = sorted(set(cfg.validation.threshold_sensitivity_range)
                        | {cfg.validation.default_threshold})
    spacing = tuple(cfg.data.spacing.target)
    sweeps = {"graphed": DeviceValidationSweep(thresholds, device="cuda"),
              "eager": DeviceValidationSweep(thresholds, graphs=False, device="cuda"),
              "graphed 4x cap": DeviceValidationSweep(thresholds, max_components=4 * 4096,
                                                      device="cuda"),
              "graphed wide cap": DeviceValidationSweep(thresholds, max_components=1 << 18,
                                                        device="cuda")}
    paths, tables_same, components, mismatches = {}, [], {}, []
    t0 = time.perf_counter()
    first = len(graphs.captures)
    # the exact host path of every case (numpy and scipy: ~10 s a speckled
    # map) runs in spawned processes while the device sweeps run here
    with ProcessPoolExecutor(max_workers=len(maps), mp_context=get_context("spawn")) as pool:
        hosts = {cid: pool.submit(evaluate_case, cid, maps_dir, data_dir, thresholds,
                                  spacing=spacing, use_device=False) for cid in maps}
        for cid, m in maps.items():
            label = nifti.load(data_dir / f"labels/{cid}.nii.gz").get_fdata()
            results = {}
            for name, sweep in sweeps.items():
                results[name] = _device_case_results(m, label, thresholds, spacing, sweep,
                                                     z_bucket=cfg.tpu.z_bucket)
                paths[cid, name] = "device" if results[name] is not None else \
                    f"host ({sweep.last_overflow_reason})"
            padded = torch.from_numpy(np.ascontiguousarray(pad_volume(m, cfg.tpu.z_bucket))).cuda()
            tabs = []
            for name in ("graphed", "eager"):
                sweep = sweeps[name]
                sweep.add_case(cid, label)
                tabs.append(sweep.tables(padded, sweep.gt_ids_padded(cid, padded.shape)))
                sweep.release_case(cid)
            tables_same.append(all(torch.equal(a, b) for a, b in zip(*tabs)))
            host = hosts[cid].result()
            for name, res in results.items():
                if res is None:
                    continue
                if name == "graphed wide cap":
                    components[cid] = [res[t]["tp"] + res[t]["fp"] for t in thresholds]
                for t in thresholds:
                    if any(res[t][k] != host[t][k] for k in ("tp", "fp", "fn")) or not (
                            abs(res[t]["dsc"] - host[t]["dsc"]) <= 1e-9):
                        mismatches.append((cid, name, t, res[t], host[t]))
    keys = {name: len(sweep.graphs.graphs) for name, sweep in sweeps.items() if sweep.graphs}
    log_captures(graphs.captures[first:], "sweep")
    log(f"  [14e] validation sweep, {len(thresholds)} thresholds {thresholds}, over the 4 "
        f"buckets' served maps: graphed keys {keys} ({graph_summary(sweeps['graphed'].graphs)}); "
        f"graphed and eager tables bit-identical {tables_same}; paths "
        f"{dict((f'{c} {n}', r) for (c, n), r in paths.items())}; predicted components a "
        f"threshold (wide cap) {components}; {time.perf_counter() - t0:.1f} s (the host path "
        f"in {len(maps)} spawned processes) on {smi}")
    differ = [c for c in maps if paths[c, "graphed"] != paths[c, "eager"]]
    wide = [c for c in maps if paths[c, "graphed wide cap"] != "device"]
    if mismatches or differ or wide or not all(tables_same) or set(keys.values()) != {len(maps)}:
        raise AssertionError(f"sweeps: counts unlike the host path {mismatches[:3]}, graphed and "
                             f"eager paths differ on {differ}, wide cap fell back on {wide}, "
                             f"tables {tables_same}, keys {keys}")
    log("  [14e] every device sweep's counts equal the host path's (DSC within 1e-9)")


def buckets_phase(tmp: Path, state: dict, model_path: Path, smi: str) -> dict:
    """14: four raw phantoms of four z buckets (one of another in-plane
    size) preprocessed on the card (one preprocess key a bucket), then per
    route (``fused_block`` bf16, ``use_pallas`` bf16, plain float32 with TF32
    off) one ``Inferencer`` and one ``FusedVolumePipeline``: graphed in three
    orders and eagerly, bit-identical; the bf16 routes within 5e-2 of the
    plain map; the validation sweep over the served maps.  Returns the
    kernels' launches (preprocess and every route)."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops import ccl_kernel
    from light_unet_tpu_torch.ops.sliding_window import bucketed_shape
    from light_unet_tpu_torch.pipeline.preprocess import run_preprocess
    from light_unet_tpu_torch.pipeline.split import split_dataset
    from light_unet_tpu_torch.utils import graphs

    t0 = time.perf_counter()
    raw, splits, data = tmp / "bucket_raw", tmp / "bucket_splits", tmp / "bucket_processed"
    ids = list(BUCKET_CASES)
    for i, (cid, shape) in enumerate(BUCKET_CASES.items()):
        write_raw_cases(raw, seed=20 + i, ids=[cid], shape=shape)
    split_dataset(raw, splits, 0.0, 1.0, 0.0, seed=42)
    cfg = Config.from_dict(SERVING)
    padded = {cid: bucketed_shape(s, cfg.data.patch_size, cfg.tpu.z_bucket)
              for cid, s in BUCKET_CASES.items()}
    first = len(graphs.captures)
    ccl_kernel.launches = 0
    val = run_preprocess(cfg, raw, data, splits, split="val", device="cuda")["val"]
    preprocess_ccl = ccl_kernel.launches
    pre = graphs.captures[first:]
    if val["successful"] != len(ids) or sorted(c.key[-1][0][0] for c in pre) != sorted(
            padded.values()) or {c.runner for c in pre} != {"preprocess"}:
        raise AssertionError(f"preprocess of the buckets: {val}, keys "
                             f"{[(c.runner, c.key[-1][0][0]) for c in pre]}")
    log(f"  [14] {len(ids)} raw phantoms {list(BUCKET_CASES.values())} -> padded "
        f"{list(padded.values())}; run_preprocess on the card {val['seconds']:.1f} s, CCL "
        f"launches {preprocess_ccl}")
    log_captures(pre, "preprocess")

    raw_paths = {cid: raw / f"images/{cid}_0000.nii.gz" for cid in ids}
    served, fused, launches, memory = {}, {}, {}, {}
    for name, gates, dtype in BUCKET_ROUTES:
        served[name], fused[name], launches[name], memory[name] = bucket_route(
            name, gates, dtype, state, model_path, data, raw_paths, tmp / f"buckets_{name}", smi)
    check_gates(launches, "bucket run")
    for name in ("fused_block", "use_pallas"):
        err = max(max(float(np.abs(run[name][c] - run["plain"][c]).max()) for c in ids)
                  for run in (served, fused))
        log(f"  [14c] {name} bf16 vs plain float32 over the 4 buckets (serving and fused): max "
            f"abs prob diff {err:.3e} (bar 5e-2)")
        if not err <= 5e-2:
            raise AssertionError(f"{name} bucket maps differ from the plain model by {err}")
    bucket_sweeps(cfg, served["fused_block"], tmp / "buckets_fused_block/graphed/inference/"
                  "prob_maps", data, smi)
    peak = max(memory.values())
    log(f"  [14] peak reserved over the routes {gib(peak)} GiB of "
        f"{gib(torch.cuda.get_device_properties(0).total_memory)} GiB; phase 14 "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    return dict(block=launches["fused_block"]["block"], norm=launches["use_pallas"]["norm"],
                ccl=preprocess_ccl + sum(c["ccl"] for c in launches.values()))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def nccl_phase(state: dict, volume: np.ndarray, body: np.ndarray) -> None:
    """11a: a one-rank NCCL group on cuda:0 through ``maybe_distributed_init``;
    ``all_reduce`` and ``reduce_scatter_tensor`` of uint8 run on the card;
    graphed: the optimizer step, and the patch-sharded window."""
    import torch

    from light_unet_tpu_torch.config import TpuConfig
    from light_unet_tpu_torch.parallel import distributed
    from light_unet_tpu_torch.parallel.collectives import psum, psum_scatter
    from light_unet_tpu_torch.parallel.mesh import create_mesh

    cfg = TpuConfig(distributed=True, coordinator_address=f"localhost:{free_port()}",
                    num_processes=1, process_id=0)
    if not distributed.maybe_distributed_init(cfg, "cuda:0"):
        raise AssertionError("maybe_distributed_init made no group")
    try:
        mesh = create_mesh(device="cuda:0")
        x = torch.arange(256, device="cuda:0").to(torch.uint8)
        summed = psum(x.clone(), mesh)
        scattered = psum_scatter(x.reshape(16, 16).clone(), mesh)
        torch.cuda.synchronize()
        if mesh.backend != "nccl" or not (torch.equal(summed, x)
                                          and torch.equal(scattered, x.reshape(16, 16))):
            raise AssertionError(f"one-rank NCCL collectives: backend {mesh.backend}")
        log(f"  [11a] one-rank NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} group on "
            f"cuda:0: all_reduce and reduce_scatter_tensor of uint8 ran on the card")
        nccl_graph_check(mesh)
        nccl_window_check(mesh, state, volume, body)
    finally:
        distributed.finish()


def nccl_graph_check(mesh) -> None:
    """11a, graphed: ``GuardedAdamW.step`` with its gradient all-reduce and a
    reduce-scatter, captured on the one-rank NCCL mesh and replayed, equal
    bit for bit to the same calls made eagerly."""
    import torch

    from light_unet_tpu_torch.core.trainer import GuardedAdamW
    from light_unet_tpu_torch.parallel.collectives import psum_scatter
    from light_unet_tpu_torch.utils.graphs import GraphRunner

    gen = torch.Generator(device="cuda").manual_seed(11)
    init = [torch.randn(s, generator=gen, device="cuda") for s in ((64, 3), (5,))]
    opts = [GuardedAdamW([torch.nn.Parameter(t.clone()) for t in init], 1e-3, 1e-4, mesh=mesh)
            for _ in range(2)]

    def unit(opt, g0, g1, loss):
        ok = opt.step([g0, g1], loss)
        return ok, psum_scatter(g0 * 2, mesh)

    runner = GraphRunner("nccl", "cuda:0")
    outs = []
    for i in range(4):
        args = [torch.randn(s, generator=gen, device="cuda") for s in ((64, 3), (5,))]
        args.append(torch.tensor(float("nan") if i == 2 else 0.5, device="cuda"))
        got = [t.clone() for t in runner(("step",), lambda *a: unit(opts[0], *a), *args)]
        want = unit(opts[1], *args)
        outs.append(all(torch.equal(a, b) for a, b in zip(got, want)))
    torch.cuda.synchronize()
    same = outs + [torch.equal(getattr(opts[0], k), getattr(opts[1], k))
                   for k in ("flat", "mu", "nu", "count")]
    log(f"  [11a] graphed on NCCL: GuardedAdamW.step (gradient all_reduce) and "
        f"reduce_scatter_tensor captured once, replayed {runner.replays} times (one planted "
        f"non-finite step): outputs and optimizer state equal to the eager calls: {all(same)}")
    if not all(same) or runner.replays != 3 or int(opts[0].count) != 3:
        raise AssertionError(f"NCCL graph replays differ from the eager calls: {same}")


def nccl_window_check(mesh, state: dict, volume: np.ndarray, body: np.ndarray) -> None:
    """11a, graphed: the patch-sharded window (``window_unit`` on a mesh: the serving
    flags, full width, bf16, ``fused_block``) over the one-rank NCCL mesh,
    its ``psum`` of prob and count captured, replayed, equal bit for bit to
    the same unit run eagerly and to the single-device window."""
    import functools

    import torch

    from light_unet_tpu_torch.ops import block_kernel
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer
    from light_unet_tpu_torch.utils.graphs import run_unit, runner_for, unit_key

    tpu = SERVING["tpu"]
    engine = SlidingWindowInferencer(
        route_model(state, dict(GATES)["fused_block"], torch.bfloat16),
        SERVING["data"]["patch_size"], 0.5, tpu["patch_batch"], tpu["z_bucket"], "uint16",
        "uint16", sparse_fetch=True, host_prefetch=False, graphs=False, device="cuda")
    key, fn, inputs = engine.unit(engine.prepare(volume, body))
    sharded = functools.partial(fn, mesh=mesh)  # window_unit, patch-sharded
    skey = unit_key("sharded", engine.apply_fn, **{k: v for k, v in key[5:]})
    runner = runner_for(torch.device("cuda:0"), True, "sharded", mesh=mesh)
    with torch.no_grad():
        single = run_unit(None, key, fn, *inputs)
        eager = run_unit(None, skey, sharded, *inputs)
        run_unit(runner, skey, sharded, *inputs)
        n = block_kernel.launches
        replay = run_unit(runner, skey, sharded, *inputs)
        per_replay = block_kernel.launches - n
    torch.cuda.synchronize()
    same = [all(torch.equal(a, b) for a, b in zip(replay, other)) for other in (eager, single)]
    log(f"  [11a] graphed on NCCL: the patch-sharded window (psum of prob and count) over the "
        f"one-rank group, {graph_summary(runner)}: the replay equal to the eager unit "
        f"{same[0]} and to the single-device window {same[1]}; block-kernel launches a replay "
        f"{per_replay}")
    if not all(same) or runner.replays != 1 or per_replay == 0:
        raise AssertionError(f"sharded window graph over NCCL: {same}, replays {runner.replays}")


# phase 11b's serving runs: (name, tpu overrides of SERVING)
MULTIRANK_SERVING = [
    ("bf16_patch", {}),
    ("bf16_slab", {"spatial_shard": True}),
    ("f32_patch", {"compute_dtype": "float32", "fetch_dtype": "float32", "sparse_fetch": False}),
    ("f32_slab", {"compute_dtype": "float32", "fetch_dtype": "float32", "sparse_fetch": False,
                  "spatial_shard": True}),
]


def multirank_train_config(data_dir: Path, splits: Path, **tpu) -> dict:
    """``train_config`` at ``batch_per_device`` 2 with the case-sharded corpus."""
    return train_config(data_dir, splits, training={"batch_size": 2},
                        tpu={"batch_per_device": True, "shard_corpus": True, **tpu})


def multirank_layout() -> tuple:
    """(ranks, backend) of phase 11b: one rank a card over NCCL where there
    are several cards, else 2 ranks sharing cuda:0 over gloo (NCCL refuses
    two ranks on one card)."""
    import torch

    n = torch.cuda.device_count()
    return (n, "nccl") if n >= 2 else (2, "gloo")


def multirank_rank(rank: int, n: int, init: str, work: str, plan: dict) -> None:
    """One rank of phase 11b (spawned; on cuda:rank under NCCL, on cuda:0
    under gloo): the four serving runs through ``Inferencer.infer_split``,
    then 5 K = 4 chains of data-parallel training in bf16 and the validation
    after them, then one float32 chain.  Writes what it saw to
    ``rank{rank}.json``."""
    import itertools

    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.core.trainer import Trainer
    from light_unet_tpu_torch.ops import block_kernel, norm_kernel
    from light_unet_tpu_torch.parallel import distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    work = Path(work)
    fields = dict(distributed=True, coordinator_address=init, num_processes=n, process_id=rank)
    device = f"cuda:{rank}" if plan["backend"] == "nccl" else "cuda:0"
    distributed.maybe_distributed_init(Config.from_dict({"tpu": fields}).tpu, device,
                                       backend=plan["backend"])
    out = {"rank": rank}
    try:
        for name, over in MULTIRANK_SERVING:
            cfg = json.loads(json.dumps(SERVING))
            cfg["tpu"].update(over, **fields)
            inf = Inferencer(cfg, plan["model"], workdir=str(work / f"{name}_r{rank}"),
                             device=device)
            block_kernel.launches = block_kernel.plain_calls = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = inf.infer_split(plan["split"], plan["data"])
            torch.cuda.synchronize()
            out[name] = dict(seconds=time.perf_counter() - t0, ok=res["successful"],
                             slab=bool(inf.sw.spatial_shard), block=block_kernel.launches,
                             plain_block=block_kernel.plain_calls,
                             peak=torch.cuda.max_memory_allocated())
            del inf

        data, splits = Path(plan["data"]), Path(plan["splits"])
        tr = Trainer(Config.from_dict(multirank_train_config(data, splits, **fields)),
                     workdir=str(work / f"train_r{rank}"), device=device)
        units = list(itertools.islice(tr._dispatch_units(tr.train_loader), 5))
        tr.model.train()
        tr._set_lr(tr.scheduler.current_lr())
        tr._step_on_batch(units.pop(0))  # first launches, allocator
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        norm_kernel.launches = block_kernel.launches = 0
        t0 = time.perf_counter()
        losses = tr._flatten_losses([tr._step_on_batch(u) for u in units])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        step_launches = dict(norm=norm_kernel.launches, block=block_kernel.launches)
        norm_kernel.launches = 0
        t1 = time.perf_counter()
        val_loss, metrics = tr.validate(0)
        torch.cuda.synchronize()
        out["train"] = dict(
            steps=len(losses) + 4, ms_per_step=seconds / len(losses) * 1e3, losses=losses,
            step_launches=step_launches, val_norm=norm_kernel.launches,
            val_s=time.perf_counter() - t1, val_loss=val_loss, recall=metrics["best_recall"],
            peak=torch.cuda.max_memory_allocated(), rows=int(tr.corpus.images.shape[0]),
            global_batch=tr.global_batch, replays=tr.graphs.replays if tr.graphs else 0)
        torch.save(tr.opt.flat.cpu(), work / f"flat_{rank}.pt")
        del tr

        cfg32 = multirank_train_config(data, splits, compute_dtype="float32", use_pallas=False,
                                       **fields)
        t32 = Trainer(Config.from_dict(cfg32), workdir=str(work / f"train32_r{rank}"),
                      device=device)
        t32.model.train()
        t32._set_lr(t32.scheduler.current_lr())
        unit = next(iter(t32._dispatch_units(t32.train_loader)))
        out["f32_losses"] = t32._flatten_losses([t32._step_on_batch(unit)])
    finally:
        (work / f"rank{rank}.json").write_text(json.dumps(out))
        distributed.finish()


def multirank_phase(tmp: Path, data_dir: Path, case_id: str, model_path: Path, bf16_map,
                    body, one_rank_s: float, smi: str) -> dict:
    """11b: ranks as ``multirank_layout`` says (on one card: 2 ranks sharing
    it over gloo).  Serving of ``case_id`` patch- and slab-sharded, in bf16
    (within 5e-2 of phase 6's one-rank map) and float32 with TF32 off
    (within 1e-5 of a one-rank float32 map), the slab maps exactly 0 outside
    the body mask, the block kernel launched on both ranks; 20 steps of
    data-parallel training (2 a rank, case-sharded corpus, K = 4,
    augmentation and dropout on) with the norm kernel in the validation
    after them and never in the steps, the flat parameters of all ranks
    equal bit for bit, and a float32 chain whose first 3 losses are within
    1e-4 relative of one process at the same global batch.  Ranks sharing
    one card make no speed-up claim.  Returns the kernels' launches."""
    import torch

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import Trainer
    from light_unet_tpu_torch.utils import nifti

    work = tmp / "multirank"
    work.mkdir()
    split = work / "split.txt"
    split.write_text(f"{case_id}\n")
    # phase 8's training cases, and one of its validation cases: the maps of
    # a model this young overflow the device sweep (~10 s a case on the host)
    splits = work / "splits"
    write_splits(splits, (tmp / "train_splits/train_list.txt").read_text().split(),
                 (tmp / "train_splits/val_list.txt").read_text().split()[:1])

    n, backend = multirank_layout()
    # the one-process references: a float32 map, and a float32 chain at batch 2n
    cfg = json.loads(json.dumps(SERVING))
    cfg["tpu"].update(MULTIRANK_SERVING[2][1])
    _, maps32 = serve(cfg, model_path, data_dir, split, work / "one_f32")
    ref32 = maps32[case_id]
    one = Trainer(Config.from_dict(train_config(
        data_dir, splits, training={"batch_size": 2 * n},
        tpu={"compute_dtype": "float32", "use_pallas": False})),
        workdir=str(work / "one_train32"), device="cuda")
    one.model.train()
    one._set_lr(one.scheduler.current_lr())
    want32 = one._flatten_losses([one._step_on_batch(next(iter(one._dispatch_units(
        one.train_loader))))])
    one.writer.close()
    del one
    torch.cuda.empty_cache()

    plan = {"model": str(model_path), "data": str(data_dir), "split": str(split),
            "splits": str(splits), "backend": backend}
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(multirank_rank, nprocs=n, join=True, args=(
        n, f"tcp://localhost:{free_port()}", str(work), plan))
    spawn_s = time.perf_counter() - t0
    got = [json.loads((work / f"rank{r}.json").read_text()) for r in range(n)]
    log(f"  [11b] {n} ranks over {backend}" + (
        "; the ranks train with the eager step and run the sharded windows eagerly (gloo "
        "stages its collectives through host memory, which a CUDA graph cannot capture)"
        if backend == "gloo" else "; training graphed with its NCCL collectives, sharded "
        "windows eager"))

    bars = {"bf16": (bf16_map, 5e-2), "f32": (ref32, 1e-5)}
    for name, _ in MULTIRANK_SERVING:
        dtype, mode = name.split("_")
        ref, bar = bars[dtype]
        prob = nifti.load(work / f"{name}_r0/inference/prob_maps/{case_id}_prob.nii.gz").get_fdata(
            np.float32)
        err = float(np.abs(prob - ref).max())
        written = [p for r in range(1, n) for p in (work / f"{name}_r{r}").rglob("*.*")]
        runs = [g[name] for g in got]
        log(f"  [11b] {name}: max abs diff {err:.3e} against one rank (bar {bar:g}); "
            f"{[round(r['seconds'], 2) for r in runs]} s a volume on the ranks (one rank, "
            f"phase 6: {one_rank_s:.2f} s); block-kernel launches {[r['block'] for r in runs]}; "
            f"peak memory {[round(r['peak'] / 2**30, 2) for r in runs]} GiB a rank on {smi}")
        if not err <= bar or written or any(r["ok"] != 1 or r["block"] == 0 or r["plain_block"]
                                            or r["slab"] != (mode == "slab") for r in runs):
            raise AssertionError(f"{name}: err {err}, ranks > 0 wrote {written}, runs {runs}")
        if mode == "slab" and np.any(prob[body < 0.5] != 0):
            raise AssertionError(f"{name}: map not 0 outside the body mask")

    trains = [g["train"] for g in got]
    flats = [torch.load(work / f"flat_{r}.pt") for r in range(n)]
    rel = [abs(a - b) / abs(b) for a, b in zip(got[0]["f32_losses"][:3], want32[:3])]
    same = all(torch.equal(flats[0], f) for f in flats[1:])
    log(f"  [11b] data-parallel training, global batch {trains[0]['global_batch']} (2 per rank), "
        f"{trains[0]['rows']} corpus row(s) a rank: {[round(t['ms_per_step'], 1) for t in trains]} "
        f"ms a step on the ranks over {len(trains[0]['losses'])} steps; losses "
        f"{[round(x, 5) for x in trains[0]['losses'][:4]]}...; validation "
        f"{trains[0]['val_s']:.2f} s (norm-kernel launches {[t['val_norm'] for t in trains]}; in "
        f"the steps {[t['step_launches'] for t in trains]}), val loss "
        f"{trains[0]['val_loss']:.5f}; peak memory {[round(t['peak'] / 2**30, 2) for t in trains]} "
        f"GiB a rank on {smi}")
    log(f"  [11b] float32 first steps, {n} ranks vs one process at batch {2 * n}: "
        f"{[round(x, 8) for x in got[0]['f32_losses'][:3]]} vs {[round(x, 8) for x in want32[:3]]}, "
        f"relative diff {max(rel):.2e} (bar 1e-4); flat parameters of the ranks bit-identical: "
        f"{same}; phase 11b spawn {spawn_s:.1f} s")
    log(f"  [11b] training graph replays a rank: {[t['replays'] for t in trains]} (NCCL: the "
        f"steps and their collectives replayed; gloo: the eager step)")
    if any((t["replays"] > 0) != (backend == "nccl") for t in trains):
        raise AssertionError(f"{backend} ranks replayed {[t['replays'] for t in trains]} units")
    if (any(t["losses"] != trains[0]["losses"] for t in trains)
            or not np.isfinite(trains[0]["losses"]).all()
            or any(t["step_launches"] != dict(norm=0, block=0) or t["val_norm"] == 0
                   for t in trains)):
        raise AssertionError(f"data-parallel training: {trains}")
    if not same or any(g["f32_losses"] != got[0]["f32_losses"] for g in got):
        raise AssertionError("the ranks' parameters or float32 losses differ")
    if not max(rel) <= 1e-4:
        raise AssertionError(f"float32 data-parallel steps differ from one process: {rel}")
    return dict(block=sum(g[name]["block"] for g in got for name, _ in MULTIRANK_SERVING),
                norm=sum(t["val_norm"] for t in trains))


TORCHRUN_IDS = [f"{i:04d}" for i in range(31, 37)]
CLI_STAGES = ("split", "preprocess", "train", "inference", "evaluate")


def instrument_cli(record: dict):
    """Time every stage of ``cli.run`` into ``record``: ``work_s`` (this
    process's own work in the stage, device synchronised) and ``stage_s``
    (from the stage's start until the barrier after it returns: the wait for
    the other ranks included); ``group_up`` is the wall-clock time at which
    the process group stood.  Returns a function that undoes it."""
    import torch

    from light_unet_tpu_torch import cli
    from light_unet_tpu_torch.parallel import distributed

    run_stage, barrier, init = cli._run_stage, distributed.barrier, distributed.maybe_distributed_init
    marks = []

    def sync(device):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def timed_stage(stage, args, *rest):
        t0 = time.perf_counter()
        rc = run_stage(stage, args, *rest)
        sync(args.device)
        record.setdefault("work_s", {})[stage] = round(time.perf_counter() - t0, 3)
        return rc

    def timed_barrier():
        barrier()
        now = time.perf_counter()
        record.setdefault("stage_s", []).append(round(now - marks[-1], 3))
        marks.append(now)

    def timed_init(tpu_cfg, device="cuda", *a, **k):
        made = init(tpu_cfg, device, *a, **k)
        record["group_up"] = time.time()
        record["device"] = str(device)
        marks.append(time.perf_counter())
        return made

    cli._run_stage, distributed.barrier = timed_stage, timed_barrier
    distributed.maybe_distributed_init = timed_init

    def undo():
        cli._run_stage, distributed.barrier = run_stage, barrier
        distributed.maybe_distributed_init = init
    return undo


def cli_rank(out_dir: str, argv: list) -> int:
    """One rank of phase 15's torchrun job: ``cli.run(argv)``, the function
    ``python -m light_unet_tpu_torch.cli`` runs, with cuDNN's deterministic
    algorithms, then ``rank_<RANK>.json`` in ``out_dir``: the stage seconds
    of ``instrument_cli``, the device, its peak memory, the kernels'
    launches, and every file the rank opened for writing (an audit hook on
    ``open`` and ``os.rename``, and ``torch.save``, whose writer opens the
    file in C++)."""
    import os

    entered = time.time()
    sys.path.insert(0, str(REPO))
    import torch

    from light_unet_tpu_torch import cli
    from light_unet_tpu_torch.ops import block_kernel, ccl_kernel, norm_kernel

    written = set()

    def audit(event, args):
        if event == "open" and isinstance(args[0], (str, bytes, os.PathLike)):
            mode, flags = args[1], args[2]
            if (isinstance(mode, str) and any(c in mode for c in "wax+")) or (
                    isinstance(flags, int) and flags > 0
                    and flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)):
                written.add(os.path.abspath(os.fsdecode(args[0])))
        elif event == "os.rename":
            written.add(os.path.abspath(os.fsdecode(args[1])))

    sys.addaudithook(audit)
    save = torch.save

    def recorded_save(obj, f, *args, **kwargs):
        if isinstance(f, (str, os.PathLike)):
            written.add(os.path.abspath(os.fsdecode(f)))
        return save(obj, f, *args, **kwargs)

    torch.save = recorded_save
    torch.backends.cudnn.deterministic = True
    record = {"rank": int(os.environ.get("RANK", 0)), "world": int(os.environ.get("WORLD_SIZE", 1)),
              "entered": entered}
    instrument_cli(record)
    record["rc"] = cli.run(argv)
    cuda = torch.device(record["device"]).type == "cuda"
    record.update(
        device_name=torch.cuda.get_device_name(record["device"]) if cuda else "cpu",
        peak_gib=torch.cuda.max_memory_allocated(record["device"]) / 2**30 if cuda else 0.0,
        launches=dict(norm=norm_kernel.launches, block=block_kernel.launches,
                      plain_block=block_kernel.plain_calls, ccl=ccl_kernel.launches),
        written=sorted(written))
    Path(out_dir, f"rank_{record['rank']}.json").write_text(json.dumps(record))
    return record["rc"]


def torchrun_config(n: int) -> dict:
    """Phase 8's training configuration (full width, ``use_pallas`` on) in
    float32, 1 epoch, the 6 cases split 1 + 2 + 3 (one training case keeps
    the epoch at ~185 steps), and a global batch of 2 x ``n`` that ``n``
    ranks divide."""
    cfg = train_config(Path("unused"), Path("unused"), tpu={"compute_dtype": "float32"},
                       training={"epochs": 1, "batch_size": 2 * n},
                       data={"split_ratio": {"train": 0.17, "val": 0.34, "test": 0.49}})
    del cfg["data_dir"], cfg["splits_dir"]  # the CLI's flags
    return cfg


def tree_files(root: Path) -> dict:
    return {str(p.relative_to(root)): p for p in sorted(root.rglob("*")) if p.is_file()}


def compare_cli_runs(one: Path, job: Path, bars: str) -> dict:
    """Phase 15's bars: the job's artifacts against the in-process run's.
    Always: split lists and processed images, labels and body masks equal
    byte for byte.  ``bars``:

    * ``"exact"`` (one rank): the training history, the best model's
      tensors, the maps, the bbox JSONs and ``detailed_results.json``'s
      counts equal;
    * ``"close"``: history and best model within 1e-5 relative, maps
      within 1e-4, bbox JSONs and counts equal;
    * ``"dp"`` (several cards): the epochs' train and validation losses
      within 1e-4 relative (the bar of phase 11b and of the CPU's
      data-parallel tests) and the learning rates equal.  Over an epoch of
      AdamW the sums of several ranks, in another order than one
      process's, move the parameters apart (phase 11b holds the first 3
      float32 steps bit for bit), and the thresholded validation metrics
      of a one-epoch model follow them, so those, the model and the maps
      are reported, not held.

    Returns the largest differences."""
    import torch

    from light_unet_tpu_torch.utils import nifti

    for name in ("train", "val", "test"):
        a = (one / f"splits/{name}_list.txt").read_text()
        if a != (job / f"splits/{name}_list.txt").read_text():
            raise AssertionError(f"torchrun job: {name} split differs")
    a_proc, b_proc = tree_files(one / "processed"), tree_files(job / "processed")
    if sorted(a_proc) != sorted(b_proc):
        raise AssertionError(f"torchrun job: processed trees differ: {sorted(a_proc)} vs "
                             f"{sorted(b_proc)}")
    for rel, p in a_proc.items():
        if rel.startswith(("images/", "labels/", "body_masks/")) \
                and p.read_bytes() != b_proc[rel].read_bytes():
            raise AssertionError(f"torchrun job: processed {rel} differs")

    def rel_diff(a, b):
        return max((abs(x - y) / max(abs(x), 1e-12) for x, y in zip(a, b)), default=0.0)

    ha = json.loads((one / "work/logs/training_history.json").read_text())
    hb = json.loads((job / "work/logs/training_history.json").read_text())
    if sorted(ha) != sorted(hb) or any(len(ha[k]) != len(hb[k]) for k in ha):
        raise AssertionError(f"training histories differ in shape: {ha} vs {hb}")
    hist_rel = max(rel_diff(ha[k], hb[k]) for k in ha)
    loss_rel = max(rel_diff(ha[k], hb[k]) for k in ("train_loss", "val_loss"))
    held = {"exact": hist_rel == 0.0, "close": hist_rel <= 1e-5,
            "dp": loss_rel <= 1e-4 and ha["learning_rate"] == hb["learning_rate"]}[bars]
    if not held:
        raise AssertionError(f"training histories differ (largest relative {hist_rel:.3e}, "
                             f"losses {loss_rel:.3e}; bars {bars}): {ha} vs {hb}")
    sa = torch.load(one / "work/models/best_model.pth", map_location="cpu")["model_state_dict"]
    sb = torch.load(job / "work/models/best_model.pth", map_location="cpu")["model_state_dict"]
    if sorted(sa) != sorted(sb):
        raise AssertionError("best_model.pth holds other tensors")
    model_rel = max(float((sa[k].double() - sb[k].double()).abs().max()
                          / max(float(sa[k].double().abs().max()), 1e-12)) for k in sa)
    if (bars == "exact" and model_rel != 0.0) or (bars == "close" and model_rel > 1e-5):
        raise AssertionError(f"best_model.pth tensors differ (largest relative {model_rel:.3e})")
    a_inf, b_inf = tree_files(one / "work/inference"), tree_files(job / "work/inference")
    if sorted(a_inf) != sorted(b_inf):
        raise AssertionError(f"inference trees differ: {sorted(a_inf)} vs {sorted(b_inf)}")
    map_err = 0.0
    for rel, p in a_inf.items():
        if rel.endswith("_prob.nii.gz"):
            map_err = max(map_err, float(np.abs(nifti.load(p).get_fdata()
                                                - nifti.load(b_inf[rel]).get_fdata()).max()))
    if bars != "dp" and map_err > (0.0 if bars == "exact" else 1e-4):
        raise AssertionError(f"probability maps differ by {map_err:.3e} (bars {bars})")
    if bars != "dp":
        for rel, p in a_inf.items():
            if rel.endswith("_bboxes.json") and p.read_text() != b_inf[rel].read_text():
                raise AssertionError(f"torchrun job: {rel} differs")
        da = json.loads((one / "work/inference/detailed_results.json").read_text())["per_case"]
        db = json.loads((job / "work/inference/detailed_results.json").read_text())["per_case"]
        counts = lambda d: {c: {t: {k: v[k] for k in ("tp", "fp", "fn")} for t, v in th.items()
                                if isinstance(v, dict) and "tp" in v} for c, th in d.items()}
        if counts(da) != counts(db):
            raise AssertionError("torchrun job: detailed_results.json counts differ")
    return dict(history_rel=hist_rel, loss_rel=loss_rel, model_rel=model_rel, map_err=map_err)


def torchrun_phase(tmp: Path, smi: str) -> int:
    """15: ``--mode all`` of the port's CLI on the 6 raw phantoms 0031-0036,
    (i) in this process on cuda:0 and (ii) as a torchrun job of N =
    ``torch.cuda.device_count()`` ranks (``tpu.distributed: true``, one
    shared workdir), each run into its own tree, held by
    ``compare_cli_runs`` and with every rank of the job on its own card and
    no rank but 0 writing a file of the artifact tree.  Returns the norm
    kernel's launches in both runs."""
    import os

    import torch

    from light_unet_tpu_torch import cli
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops import norm_kernel
    from light_unet_tpu_torch.utils import graphs

    n = torch.cuda.device_count()
    base = tmp / "torchrun"
    t0 = time.perf_counter()
    write_raw_cases(base / "raw", seed=15, ids=TORCHRUN_IDS)
    log(f"  {len(TORCHRUN_IDS)} raw phantoms {SERVING_SHAPE} written in "
        f"{time.perf_counter() - t0:.1f} s")
    cfg = Config.from_dict(torchrun_config(n))

    def argv(name: str) -> list:
        return ["--mode", "all", "--config", str(base / f"{name}.yaml"),
                "--data_root", str(base / "raw"), "--processed_dir", str(base / name / "processed"),
                "--splits_dir", str(base / name / "splits"), "--workdir", str(base / name / "work")]

    # (i) in this process
    cfg.tpu.distributed = False
    cfg.save(base / "one.yaml")
    record: dict = {}
    undo = instrument_cli(record)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    norm_kernel.launches = 0
    try:
        t0 = time.perf_counter()
        rc = cli.run(argv("one"))
        one_s = time.perf_counter() - t0
    finally:
        undo()
        torch.backends.cudnn.deterministic = deterministic
    one_norm = norm_kernel.launches
    if rc != 0 or one_norm == 0:
        raise AssertionError(f"in-process --mode all: rc {rc}, norm-kernel launches {one_norm}")
    log(f"  (i) in-process --mode all, one card: {one_s:.1f} s; s per stage "
        f"{dict(zip(CLI_STAGES, record['stage_s']))}; norm-kernel launches {one_norm}")
    graphs.release()
    torch.cuda.empty_cache()

    # (ii) the torchrun job
    cfg.tpu.distributed = True
    cfg.save(base / "job.yaml")
    ranks_dir = base / "ranks"
    ranks_dir.mkdir()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), str(REPO / "chip_smoke.py"), "--cli-rank", str(ranks_dir), *argv("job")]
    started = time.time()
    with open(base / "job.log", "w") as out:
        proc = subprocess.run(cmd, stdout=out, stderr=subprocess.STDOUT, timeout=900,
                              cwd=base, env=dict(os.environ, PYTHONUNBUFFERED="1"))
    job_s = time.time() - started
    if proc.returncode != 0:
        print((base / "job.log").read_text()[-6000:], file=sys.stderr)
        raise AssertionError(f"torchrun job of {n} ranks exited with {proc.returncode}")
    ranks = [json.loads((ranks_dir / f"rank_{r}.json").read_text()) for r in range(n)]
    devices = [r["device"] for r in ranks]
    if any(r["rc"] != 0 or r["world"] != n for r in ranks) or len(set(devices)) != n:
        raise AssertionError(f"torchrun ranks: {[(r['rank'], r['rc'], r['device']) for r in ranks]}")
    artifacts = str((base / "job").resolve())
    strays = {r["rank"]: [p for p in r["written"] if p.startswith(artifacts)]
              for r in ranks[1:]}
    if any(strays.values()):
        raise AssertionError(f"ranks other than 0 wrote artifact files: {strays}")
    diffs = compare_cli_runs(base / "one", base / "job", "exact" if n == 1 else "dp")
    job_norm = sum(r["launches"]["norm"] for r in ranks)
    if any(r["launches"]["norm"] == 0 for r in ranks):
        raise AssertionError(f"a rank never launched the norm kernel: "
                             f"{[r['launches'] for r in ranks]}")
    log(f"  (ii) torchrun --nproc_per_node {n} --mode all: {job_s:.1f} s; start-up (launch to "
        f"process group) {max(r['group_up'] for r in ranks) - started:.1f} s")
    for r in ranks:
        log(f"    rank {r['rank']} on {r['device']} ({r['device_name']}): s per stage "
            f"{dict(zip(CLI_STAGES, r['stage_s']))}, own work {r['work_s']}, peak "
            f"{r['peak_gib']:.2f} GiB, launches {r['launches']}")
    log(f"  job against in-process: splits and processed files equal, history relative "
        f"{diffs['history_rel']:.3e} (losses {diffs['loss_rel']:.3e}), best model relative "
        f"{diffs['model_rel']:.3e}, maps {diffs['map_err']:.3e}"
        f"{', bbox JSONs and evaluate counts equal' if n == 1 else ''}; ranks 1..{n - 1} wrote "
        f"no artifact file; on {smi}")
    return one_norm + job_norm


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="trace the fused_block serving and fused-pipeline runs and 20 "
                        "training steps with torch.profiler")
    parser.add_argument("--quick", action="store_true",
                        help="build and check the kernels at a small batch; skip timing and serving")
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--cli-rank"]:  # one rank of phase 15's torchrun job
        return cli_rank(argv[1], argv[2:])
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
    from light_unet_tpu_torch.ops import _build, block_kernel, ccl_kernel, norm_kernel
    from light_unet_tpu_torch.utils import fastio

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. device
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")
    log(f"[clocks] sm, max sm, mem, power, temperature: {nvidia_smi_clocks()}")

    # 2. build: the CUDA kernels (nvcc) and, beside them, the host library (C++ compiler)
    import os
    from concurrent.futures import ThreadPoolExecutor

    def timed_build(fn, *args):
        t = time.perf_counter()
        return fn(*args), time.perf_counter() - t

    with ThreadPoolExecutor(max_workers=2) as pool:
        host = pool.submit(timed_build, _build.build_host, "fastio")
        libs, cuda_s = timed_build(_build.build_all)
        host_lib, host_s = host.result()
    log(f"[build] {len(libs)} libraries in {cuda_s:.1f} s -> {_build.build_dir()}")
    for name in libs:
        for kernel, usage in ptxas_usage((_build.build_dir() / f"{name}.log").read_text()):
            log(f"  {name}: {kernel}: {usage}")
    cxx = _build.cxx_command()
    version = subprocess.run([*cxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout.splitlines()[0]
    log(f"[build] host library {host_lib.name} in {host_s:.1f} s (in parallel) -> "
        f"{host_lib.parent}: {' '.join(cxx)} ({version}) {' '.join(_build.CXX_FLAGS)}; "
        f"host cores {os.cpu_count()}")

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
        data_dir, split, raw_paths, closed_masks, preprocess_ccl = preprocess_phase(tmp, SERVING)

        # 5b. the host I/O library against its plain versions, and its times
        log(f"[host io] utils/fastio.py (csrc/fastio.cpp) on the card's host")
        t0 = time.perf_counter()
        host_io_phase(tmp, raw_paths, data_dir, smi)
        log(f"  host I/O phase {time.perf_counter() - t0:.1f} s")

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
            ccl_kernel.launches = 0
            decodes = fastio.calls["decode"]
            vps, maps = serve(cfg, model_path, data_dir, split, tmp / name,
                              profile=args.profile and name == "fused_block")
            counts[name] = dict(block=block_kernel.launches, plain_block=block_kernel.plain_calls,
                                norm=norm_kernel.launches, ccl=ccl_kernel.launches)
            runs[name] = maps
            decodes = fastio.calls["decode"] - decodes
            if decodes != 2 * N_CASES:
                raise AssertionError(f"{name} serving decoded {decodes} inputs natively, "
                                     f"not {2 * N_CASES}")
            if name == "fused_block":
                serving_vps = vps
            log(f"  {name}: {vps:.3f} vol/s on {smi}; launches {counts[name]}; "
                f"{decodes} native decodes (image + body mask per case)")
            if name == "fused_block":
                serving_phases(cfg, model_path, data_dir, split.read_text().split()[0],
                               tmp / "serving_split")
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
            ccl_kernel.launches = 0
            calls = dict(fastio.calls)
            vps, peak, maps, preps, pipe = fused_run(
                cfg, state, raw_paths, profile=args.profile and name == "fused_block")
            fused_counts[name] = dict(block=block_kernel.launches,
                                      plain_block=block_kernel.plain_calls,
                                      norm=norm_kernel.launches, ccl=ccl_kernel.launches)
            native = {k: fastio.calls[k] - calls[k] for k in calls}
            if native != dict(decode=N_CASES, order_stats=N_CASES, quantize_pad=N_CASES):
                raise AssertionError(f"{name} fused pipeline: host library calls {native}")
            check_zero_outside_body(cfg, maps, preps)
            fused_runs[name] = maps
            log(f"  {name}: {vps:.3f} vol/s on {smi}; peak device memory {peak / 2**30:.2f} GiB; "
                f"launches {fused_counts[name]}; host library calls {native}; maps 0 outside "
                f"the body mask")
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

        # 10. mixed FL + DLBCL training
        log(f"[mixed] configs/unet_mixed_fl_dlbcl.yaml, train FL {ids[:2]} + DLBCL 1001-1002, "
            f"validate FL {ids[2:]}, 1 epoch, use_pallas on")
        t0 = time.perf_counter()
        mixed_val_norm = mixed_phase(tmp, data_dir, ids, smi)
        log(f"  mixed phase {time.perf_counter() - t0:.1f} s on {smi}")

        # 11. multi-rank on one card: NCCL with one rank, then 2 gloo ranks
        log(f"[multi-rank] one-rank NCCL group, then {multirank_layout()} (ranks, backend): "
            f"{ids[0]} served patch- and slab-sharded, data-parallel training")
        t0 = time.perf_counter()
        body = fastio.load_f32(data_dir / f"body_masks/{ids[0]}.nii.gz")[0]
        nccl_phase(state, fastio.load_f32(data_dir / f"images/{ids[0]}_0000.nii.gz")[0], body)
        multirank_counts = multirank_phase(tmp, data_dir, ids[0], model_path,
                                           runs["fused_block"][ids[0]], body,
                                           1.0 / serving_vps, smi)
        log(f"  multi-rank phase {time.perf_counter() - t0:.1f} s on {smi}")

        # 12. the dispatch units as CUDA graphs against the eager path
        log("[graphs] phase 8's configuration graphed and eager (the explicit argument); "
            "the fused pipeline graphed and eager")
        t0 = time.perf_counter()
        graph_agreement(data_dir, tmp / "train_splits", tmp)
        graph_timing(data_dir, tmp / "train_splits", tmp, smi)
        fused_graphs_ab(state, raw_paths, smi)
        log(f"  graphs phase {time.perf_counter() - t0:.1f} s on {smi}")

        # 13. the per-volume units: the CCL kernel, graphed against eager, no host sync
        log("[units] the CCL kernel against the plain sweeps; each per-volume unit graphed "
            "and eager per route and dtype; serving graphed and eager")
        t0 = time.perf_counter()
        ccl_rows, ccl_err = ccl_phase(ccl_masks(closed_masks, runs["fused_block"]), smi)
        unit_rows = units_phase(state, data_dir, ids, raw_paths, smi)
        cfg = json.loads(json.dumps(SERVING))
        serving_ab(cfg, model_path, data_dir, split, tmp, runs["fused_block"], smi)
        serving_phases(cfg, model_path, data_dir, split.read_text().split()[0],
                       tmp / "serving_split_eager", graphs=False)
        log(f"  units phase {time.perf_counter() - t0:.1f} s on {smi}")

        # 14. a cohort of four z buckets through every stage, three routes
        log(f"[buckets] {len(BUCKET_CASES)} raw phantoms of four z buckets: preprocess, serving "
            f"and the fused pipeline per route in three orders and eagerly, the validation sweep")
        bucket_counts = buckets_phase(tmp, state, model_path, smi)

        # 15. the CLI in this process and as a torchrun job of one rank a card
        log(f"[torchrun] --mode all on {len(TORCHRUN_IDS)} raw phantoms in this process and as "
            f"a torchrun job of {torch.cuda.device_count()} rank(s), float32, use_pallas on")
        t0 = time.perf_counter()
        torchrun_norm = torchrun_phase(tmp, smi)
        log(f"  torchrun phase {time.perf_counter() - t0:.1f} s on {smi}")

    # 16. results
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
                         + eval_counts["block"] + multirank_counts["block"]
                         + bucket_counts["block"]),
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
                         + train_val_norm + mixed_val_norm + multirank_counts["norm"]
                         + bucket_counts["norm"] + torchrun_norm),
            "max_abs_err": norm_err[torch.bfloat16],
            "ms": total(norm_rows, "ms", norm_calls),
            "plain_ms": total(norm_rows, "plain_ms", norm_calls),
            "bound_ms": sum(max(r["bytes_ms"], r["ops_ms"]) * norm_calls[k]
                            for k, r in norm_rows.items()),
            "bound_by": "bytes" if norm_bytes >= norm_ops else "operations",
            "library_ms": total(norm_rows, "library_ms", norm_calls),
        },
        {
            "name": "ccl_label", "route": "cuda",
            "source": "light_unet_tpu_torch/csrc/ccl.cu",
            "replaces": "light_unet_tpu/ops/ccl.py:56",
            "launches": (counts["fused_block"]["ccl"] + fused_counts["fused_block"]["ccl"]
                         + preprocess_ccl + bucket_counts["ccl"]),
            "max_abs_err": float(ccl_err),
            "ms": float(np.mean([r["ms"] for k, r in ccl_rows.items() if "closed" in k])),
            "plain_ms": float(np.mean([r["plain_ms"] for k, r in ccl_rows.items()
                                       if "closed" in k])),
            "bound_ms": float(np.mean([r["bound_ms"] for k, r in ccl_rows.items()
                                       if "closed" in k])),
            "bound_by": "bytes",
            "library_ms": None,
        },
    ]
    log(f"[result] launches: residual_block = serving {counts['fused_block']['block']} + fused "
        f"pipeline {fused_counts['fused_block']['block']} + evaluate-phase serving "
        f"{eval_counts['block']} + multi-rank serving {multirank_counts['block']} + buckets "
        f"{bucket_counts['block']}; instance_norm_leaky = serving {counts['use_pallas']['norm']} + "
        f"fused pipeline {fused_counts['use_pallas']['norm']} + training-phase validation "
        f"{train_val_norm} + mixed-training validation {mixed_val_norm} + multi-rank "
        f"validation {multirank_counts['norm']} + buckets {bucket_counts['norm']} + torchrun "
        f"phase {torchrun_norm}; ccl_label = "
        f"serving {counts['fused_block']['ccl']} + fused pipeline "
        f"{fused_counts['fused_block']['ccl']} + preprocess {preprocess_ccl} + buckets "
        f"{bucket_counts['ccl']}")
    log("[result] ccl_label times are means over the 4 closed body masks (144x144x288); "
        f"max_abs_err {ccl_err} is the largest label difference from the plain sweeps over "
        "every mask of phase 13a")
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
