#!/usr/bin/env python3
"""Interleaved A/Bs of the PyTorch port's host-device link options (the
port of ``scripts/bench_link_opts.py``): block-sparse fetch, K-step chained
dispatch, bit-packed body-mask uploads, the patch batch and the tail chunk
schedule.

Every comparison is interleaved within one process (configuration A's
segment, B's, repeat) and reported as per-segment numbers and medians.
Each A/B's outputs are held against each other as the JAX script holds
them: sparse equal to dense and packed equal to unpacked bit for bit, the
tailed schedule within 0.06 of the uniform one (another batch size of the
bf16 forward).  The serving experiments run ``Config()``'s model (bf16,
plain route, seeded random weights) on synthetic 144x144x272 volumes
(``build_raw_dataset`` seed 0), on the card as the port serves: one CUDA
graph replay a volume.  One JSON line per experiment (per batch and K for
``chain``, per patch batch for ``pbatch``), with the JAX script's keys.

    python3 scripts/bench_link_opts_torch.py --which all
    python3 scripts/bench_link_opts_torch.py --which sparse --segments 5

The port has no ``pack_mask`` switch (``SlidingWindowInferencer`` packs
the mask whenever z is byte-aligned): the unpacked arm uploads the same
mask unpacked into the same prepared case.  ``pbatch``'s bytes are the
analytic bytes of the forward (``models/cost.py:forward_cost``) in place
of XLA's cost model.  It imports nothing of JAX and nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402

SHAPE = (144, 144, 272)  # reference-scale whole-body volume
N_VOLUMES = 4
N_CASES = 6  # training cases of the chain experiment


def _volumes(tmp: Path, n: int) -> list:
    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.utils import fastio

    ids = port_bench.raw_volumes(tmp, n, SHAPE)
    return [fastio.load_f32(port_bench.image_path(tmp, cid))[0] for cid in ids]


def _pipelined(engine, prepare, items) -> tuple:
    """(volumes/s, maps) of one pass: prepare and dispatch volume i + 1
    before fetching volume i (the serving mode)."""
    t0 = time.perf_counter()
    pending = None
    outs = []
    for item in items:
        d = engine.dispatch(prepare(item))
        if pending is not None:
            outs.append(engine.fetch(pending))
        pending = d
    outs.append(engine.fetch(pending))
    return len(items) / (time.perf_counter() - t0), outs


# --------------------------------------------------------------------------
def bench_sparse(device, segments: int = 3, n_volumes: int = N_VOLUMES) -> dict:
    """(a) block-sparse D2H on the serving path: ``FusedVolumePipeline``
    with ``tpu.sparse_fetch`` off and on.  The map is body-masked (exactly
    zero outside the dilated body), so the occupied tiles are a part of
    the bucketed grid."""
    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline

    cfg = port_bench.default_config()
    _, apply_fn = port_bench.seeded_model(cfg, device)
    with tempfile.TemporaryDirectory() as td:
        vols = _volumes(Path(td), n_volumes)
        pipes = {}
        for name, on in (("dense", False), ("sparse", True)):
            cfg.tpu.sparse_fetch = on
            pipes[name] = FusedVolumePipeline(apply_fn, cfg, patch_batch=cfg.tpu.patch_batch,
                                              device=device)
            pipes[name](vols[0])  # warm-up and capture
        seg = {"dense": [], "sparse": []}
        ref_out = None
        for _ in range(segments):
            for name in ("dense", "sparse"):
                vps, outs = _pipelined(pipes[name], pipes[name].prepare, vols)
                seg[name].append(vps)
                if name == "dense":
                    ref_out = outs
                else:  # bit-identical reconstruction, every segment
                    for a, b in zip(ref_out, outs):
                        np.testing.assert_array_equal(a, b)
    dense, sparse = (statistics.median(seg[k]) for k in ("dense", "sparse"))
    return {
        "experiment": "sparse_fetch_serving",
        "n_volumes": n_volumes,
        "segments": segments,
        "dense_vps_median": round(dense, 4),
        "sparse_vps_median": round(sparse, 4),
        "speedup": round(sparse / dense, 3),
        "dense_vps_segments": [round(v, 4) for v in seg["dense"]],
        "sparse_vps_segments": [round(v, 4) for v in seg["sparse"]],
        "bit_identical": True,
        "device": port_bench.device_line(device),
    }


# --------------------------------------------------------------------------
def bench_chain(device, segments: int = 3, steps: int = 16, batches=(2, 8),
                ks=(1, 4, 8), n_cases: int = N_CASES) -> list:
    """(b) K-step chained dispatch in corpus mode: one dispatch unit (one
    graph replay on a card) runs K gather -> augment -> train steps."""
    from light_unet_tpu_torch import bench as port_bench

    results = []
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        port_bench.processed_volumes(tmp, n_cases, SHAPE)
        for batch in batches:
            trainers, iters = {}, {}

            def next_unit(k):
                try:
                    return next(iters[k])
                except StopIteration:
                    t = trainers[k]
                    iters[k] = iter(t._dispatch_units(t.train_loader))
                    return next(iters[k])

            for k in ks:
                t = port_bench.bench_trainer(tmp, batch, device, steps_per_dispatch=k)
                if t.corpus is None:
                    raise RuntimeError("the chain experiment needs the device corpus")
                trainers[k] = t
                iters[k] = iter(t._dispatch_units(t.train_loader))
                t._flatten_losses([t._step_on_batch(next_unit(k))])  # warm-up, capture, sync

            seg = {k: [] for k in ks}
            for _ in range(segments):
                for k in ks:
                    t = trainers[k]
                    n_done = 0
                    t0 = time.perf_counter()
                    losses = []
                    while n_done < steps:
                        u = next_unit(k)
                        losses.append(t._step_on_batch(u))
                        n_done += t._unit_steps(u)
                    t._flatten_losses(losses)  # sync once (pipelined)
                    seg[k].append(n_done / (time.perf_counter() - t0))
            for k in ks:
                results.append({
                    "experiment": "steps_per_dispatch",
                    "batch": batch,
                    "k": k,
                    "steps_per_sec_median": round(statistics.median(seg[k]), 3),
                    "step_ms": round(1e3 / statistics.median(seg[k]), 1),
                    "segments_sps": [round(v, 3) for v in seg[k]],
                    "device": port_bench.device_line(device),
                })
            del trainers, iters
            port_bench.release(device)
    return results


# --------------------------------------------------------------------------
def _unpacked(sw, v, m) -> dict:
    """``sw.prepare(v, post_mask=m)`` with the mask uploaded unpacked: one
    uint8 a voxel of the padded grid (the library packs it 8 to a byte)."""
    import torch

    prep = sw.prepare(v)
    pm = np.zeros(tuple(prep["volume"].shape), np.uint8)
    pm[: m.shape[0], : m.shape[1], : m.shape[2]] = m > 0
    return {**prep, "post_mask": torch.from_numpy(pm).to(sw.device, non_blocking=True),
            "mask_packed": False}


def bench_mask(device, segments: int = 3, n_volumes: int = N_VOLUMES) -> dict:
    """(c) bit-packed body-mask uploads on the sliding-window path (the
    ``Inferencer`` serves with a host-loaded body mask): packed against
    unpacked."""
    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer

    cfg = port_bench.default_config()
    _, apply_fn = port_bench.seeded_model(cfg, device)
    with tempfile.TemporaryDirectory() as td:
        vols = _volumes(Path(td), n_volumes)
        masks = [(v > np.percentile(v, 40)).astype(np.uint8) for v in vols]
        sws, prepares = {}, {}
        for name in ("packed", "unpacked"):
            sws[name] = SlidingWindowInferencer(
                apply_fn, patch_size=tuple(cfg.data.patch_size), patch_batch=cfg.tpu.patch_batch,
                z_bucket=cfg.tpu.z_bucket, transfer_dtype="uint16", fetch_dtype="uint16",
                device=device)
        prepares["packed"] = lambda vm: sws["packed"].prepare(vm[0], post_mask=vm[1])
        prepares["unpacked"] = lambda vm: _unpacked(sws["unpacked"], *vm)
        for name in ("packed", "unpacked"):
            prep = prepares[name]((vols[0], masks[0]))
            if prep["mask_packed"] != (name == "packed"):
                raise RuntimeError(f"{name}: the padded z extent is not byte-aligned")
            sws[name].fetch(sws[name].dispatch(prep))  # warm-up and capture
        seg = {"packed": [], "unpacked": []}
        ref_out = None
        for _ in range(segments):
            for name in ("unpacked", "packed"):
                vps, outs = _pipelined(sws[name], prepares[name], list(zip(vols, masks)))
                seg[name].append(vps)
                if name == "unpacked":
                    ref_out = outs
                else:
                    for a, b in zip(ref_out, outs):
                        np.testing.assert_array_equal(a, b)
    unp, pk = (statistics.median(seg[k]) for k in ("unpacked", "packed"))
    return {
        "experiment": "pack_mask_sliding_window",
        "n_volumes": n_volumes,
        "segments": segments,
        "unpacked_vps_median": round(unp, 4),
        "packed_vps_median": round(pk, 4),
        "speedup": round(pk / unp, 3),
        "unpacked_vps_segments": [round(v, 4) for v in seg["unpacked"]],
        "packed_vps_segments": [round(v, 4) for v in seg["packed"]],
        "bit_identical": True,
        "device": port_bench.device_line(device),
    }


# --------------------------------------------------------------------------
def bench_pbatch(device, segments: int = 3, n_volumes: int = N_VOLUMES,
                 batches=(96, 192)) -> list:
    """(d) the patch batch: the raw forward at each batch (ms a patch; GB/s
    of the analytic bytes) and the end-to-end pipeline at each
    ``patch_batch``, interleaved.  Each batch's input is made on the device
    before its timing loop."""
    import torch

    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.models.cost import forward_cost
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline

    cfg = port_bench.default_config()
    _, apply_fn = port_bench.seeded_model(cfg, device)
    patch = tuple(cfg.data.patch_size)
    results = []
    with tempfile.TemporaryDirectory() as td:
        vols = _volumes(Path(td), n_volumes)
        gen = torch.Generator(device=device)
        xs, raw, cost_bytes = {}, {}, {}
        with torch.no_grad():
            for b in batches:
                xs[b] = torch.rand((b, *patch, 1), generator=gen.manual_seed(0),
                                   device=device).to(torch.bfloat16)
                cost_bytes[b] = forward_cost(cfg.model, b, patch, torch.bfloat16)[1]
                port_bench.elapsed_ms(lambda: apply_fn(xs[b]), device)  # warm
                raw[b] = []
            for _ in range(max(segments, 3)):
                for b in batches:
                    raw[b].append(port_bench.elapsed_ms(lambda: apply_fn(xs[b]), device) / 1e3)

        pipes = {}
        for b in batches:
            pipes[b] = FusedVolumePipeline(apply_fn, cfg, patch_batch=b, device=device)
            pipes[b](vols[0])
        e2e = {b: [] for b in batches}
        for _ in range(segments):
            for b in batches:
                e2e[b].append(_pipelined(pipes[b], pipes[b].prepare, vols)[0])

    for b in batches:
        t_med = statistics.median(raw[b])
        results.append({
            "experiment": "patch_batch_roofline",
            "patch_batch": b,
            "forward_ms_median": round(t_med * 1e3, 2),
            "forward_ms_per_patch": round(t_med * 1e3 / b, 3),
            "achieved_gbps": (round(cost_bytes[b] / t_med / 1e9, 1)
                              if torch.device(device).type == "cuda" else None),
            "e2e_vps_median": round(statistics.median(e2e[b]), 4),
            "e2e_vps_segments": [round(v, 4) for v in e2e[b]],
            "analytic_mbytes": round(cost_bytes[b] / 1e6, 2),
            "device": port_bench.device_line(device),
        })
    return results


# --------------------------------------------------------------------------
def bench_tail(device, segments: int = 3, n_volumes: int = N_VOLUMES,
               patch_batch: int = 192) -> dict:
    """(e) the tail-bucket chunk schedule (``choose_chunks``): 275 windows at
    chunk 192 forward 192 + 128 = 320 slots instead of the uniform
    round-up's 2 x 192 = 384.  The tailed schedule against the uniform one
    at the same ``patch_batch``; the maps within 0.06 (the tail's forward
    runs at another batch size, and bf16 sums differ with it)."""
    import light_unet_tpu_torch.ops.fused as fused_mod
    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
    from light_unet_tpu_torch.ops.sliding_window import _round_up, choose_chunk

    cfg = port_bench.default_config()
    _, apply_fn = port_bench.seeded_model(cfg, device)
    tailed_choose = fused_mod.choose_chunks

    def uniform_choose(n, pb):
        c = choose_chunk(max(1, n), pb)
        return c, 0, _round_up(max(n, 1), c)

    with tempfile.TemporaryDirectory() as td:
        vols = _volumes(Path(td), n_volumes)
        # one pipeline a schedule; the schedule is chosen in prepare(), so
        # swap the module's choose_chunks around each prepare (this script
        # prepares on its one thread)
        pipes = {name: FusedVolumePipeline(apply_fn, cfg, patch_batch=patch_batch, device=device)
                 for name in ("uniform", "tailed")}
        chooser = {"uniform": uniform_choose, "tailed": tailed_choose}
        slots = {}

        def prepare(name, v):
            fused_mod.choose_chunks = chooser[name]
            try:
                prep = pipes[name].prepare(v)
            finally:
                fused_mod.choose_chunks = tailed_choose
            slots[name] = int(prep.positions.shape[0])
            return prep

        for name in ("uniform", "tailed"):  # warm-up and capture of both
            pipes[name].fetch(pipes[name].dispatch(prepare(name, vols[0])))

        seg = {"uniform": [], "tailed": []}
        ref_out = None
        max_diff = 0.0
        for _ in range(segments):
            for name in ("uniform", "tailed"):
                vps, outs = _pipelined(pipes[name], lambda v, n=name: prepare(n, v), vols)
                seg[name].append(vps)
                if name == "uniform":
                    ref_out = outs
                else:
                    for a, b in zip(ref_out, outs):
                        max_diff = max(max_diff, float(np.abs(a - b).max()))
                        np.testing.assert_allclose(a, b, atol=0.06)
    uni, tl = (statistics.median(seg[k]) for k in ("uniform", "tailed"))
    return {
        "experiment": "tail_chunk_schedule",
        "patch_batch": patch_batch,
        "n_volumes": n_volumes,
        "segments": segments,
        "slots_uniform": slots["uniform"],
        "slots_tailed": slots["tailed"],
        "uniform_vps_median": round(uni, 4),
        "tailed_vps_median": round(tl, 4),
        "speedup": round(tl / uni, 3),
        "uniform_vps_segments": [round(v, 4) for v in seg["uniform"]],
        "tailed_vps_segments": [round(v, 4) for v in seg["tailed"]],
        "max_abs_diff": max_diff,
        "device": port_bench.device_line(device),
    }


def main(argv=None) -> int:
    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.utils.device import resolve_device

    global SHAPE
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--which", choices=["sparse", "chain", "mask", "pbatch", "tail", "all"],
                    default="all")
    ap.add_argument("--segments", type=int, default=3)
    ap.add_argument("--shape", type=int, nargs=3, default=None,
                    help="override the volume shape (a CPU smoke: 24 24 40)")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--steps", type=int, default=16, help="chain: steps timed per segment")
    ap.add_argument("--batches", type=int, nargs="+", default=[2, 8],
                    help="chain: batch sizes to compare")
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 4, 8],
                    help="chain: steps_per_dispatch values to compare")
    ap.add_argument("--pbatches", type=int, nargs="+", default=[96, 192],
                    help="pbatch: patch_batch values to compare")
    ap.add_argument("--tail-pbatch", type=int, default=192,
                    help="tail: patch_batch for the schedule A/B")
    args = ap.parse_args(argv)
    if args.shape:
        SHAPE = tuple(args.shape)
    dev = resolve_device(args.device)
    which = args.which

    def emit(rows):
        for r in rows if isinstance(rows, list) else [rows]:
            print(json.dumps(r), flush=True)
        port_bench.release(dev)

    if which in ("sparse", "all"):
        emit(bench_sparse(dev, args.segments, N_VOLUMES))
    if which in ("chain", "all"):
        emit(bench_chain(dev, args.segments, steps=args.steps, batches=tuple(args.batches),
                         ks=tuple(args.ks), n_cases=N_CASES))
    if which in ("mask", "all"):
        emit(bench_mask(dev, args.segments, N_VOLUMES))
    if which in ("pbatch", "all"):
        emit(bench_pbatch(dev, args.segments, N_VOLUMES, batches=tuple(args.pbatches)))
    if which in ("tail", "all"):
        emit(bench_tail(dev, args.segments, N_VOLUMES, patch_batch=args.tail_pbatch))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
