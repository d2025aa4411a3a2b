"""Raw whole-body volumes through the program's fused per-volume pipeline,
closed loop (the ``--mode bench`` loop of ``light_unet_tpu_torch/bench.py``).

Traffic (``params``): a pool of ``pool`` seeded phantoms of ``shape``
written as raw ``.nii.gz`` files, cycled until the window ends.  Two
worker threads decode (``utils/fastio.py``) and prepare
(``FusedVolumePipeline.prepare``: percentiles, uint16 quantize + pad,
upload) up to three volumes ahead; the main thread dispatches each
volume's program before it fetches the previous map.  The window opens
once the first volume is prepared (the pipeline primed) and closes with
the first map fetched after ``--seconds``; a volume counts when its map
is on the host.

Check: ``check_sample`` volumes of the pool, drawn from the seed, are held
against the float32 reference (percentiles, the stated transfer,
normalization, body mask, windowed forward with its Gaussian blend), each
through the last map the window fetched for it: ``map_gap_mean``, the
mean absolute difference of a voxel, and ``map_gap_window``, the largest
such mean over one window's voxels (the largest voxel's is printed
beside them).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cellbench import common, harness, nifti_io, phantoms, weights

WORKERS = 2  # decode + prepare threads, as --mode bench and Inferencer.infer_split run them
DEPTH = 3    # volumes decoded and prepared ahead of the dispatch


def make_raws(cell: harness.Cell) -> list:
    """The pool's raw volumes, from the seed."""
    p = cell.params
    rng = np.random.default_rng(cell.seed)
    return [phantoms.make_phantom(rng, tuple(p["shape"]), p.get("lesions", 2))[0]
            for _ in range(p["pool"])]


def run(cell: harness.Cell) -> harness.Outcome:
    p = cell.params
    dev = torch.device(cell.device)
    clock = common.Clock()
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.inferencer import COMPUTE_DTYPES
    from light_unet_tpu_torch.models.fused_forward import make_fused_apply
    from light_unet_tpu_torch.models.unet3d import build_model
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
    from light_unet_tpu_torch.utils import fastio
    clock.lap("imports")

    shape = tuple(p["shape"])
    raws = make_raws(cell)
    paths = [cell.workdir / f"v{i:02d}_0000.nii.gz" for i in range(len(raws))]
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(nifti_io.write, paths, raws))
    clock.lap("inputs")

    settings = cell.settings()
    cfg = Config.from_dict(settings)
    state = weights.cell_state(cell, dev)
    model = build_model(cfg.model, COMPUTE_DTYPES[cfg.tpu.compute_dtype], inference=True,
                        use_pallas=cfg.tpu.use_pallas)
    model.load_state_dict(state)
    model = model.to(dev).eval()
    apply_fn = make_fused_apply(model) if cfg.tpu.fused_block else model
    pipe = FusedVolumePipeline(apply_fn, cfg, patch_batch=cfg.tpu.patch_batch, device=dev)
    clock.lap("model")

    # the pool's one shape: the first volume builds the kernels and captures
    # the graph, the second is the first replay
    for path in paths[:2]:
        pipe.fetch(pipe.dispatch(pipe.prepare(fastio.load_f32(path)[0])))
    common.sync(dev)
    clock.lap("warmup")
    setup_s = time.perf_counter() - cell.t_start

    spans = harness.Spans()
    tracer = harness.Tracer(cell.trace, dev, spans)

    def load_and_prepare(i):
        with spans("decode"):
            image = fastio.load_f32(paths[i])[0]
        with spans("prepare"):
            return i, pipe.prepare(image)

    kept = {}
    done = 0
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        # the pipeline primed: the window opens with the first volume prepared
        queue = deque(pool.submit(load_and_prepare, k % len(paths)) for k in range(DEPTH))
        submitted = DEPTH
        queue[0].result()
        tracer.start()
        t0, w0, cpu0 = time.perf_counter(), time.time_ns(), time.process_time()
        pending = None
        while True:
            with spans("wait_input"):
                i, prep = queue.popleft().result()
            with spans("dispatch"):
                disp = pipe.dispatch(prep)
            if pending is not None:
                with spans("fetch"):
                    kept[pending[0]] = pipe.fetch(pending[1])
                done += 1
                if time.perf_counter() - t0 >= cell.seconds:
                    t_end, w1 = time.perf_counter(), time.time_ns()
                    cpu_s = time.process_time() - cpu0
                    break
            pending = (i, disp)
            queue.append(pool.submit(load_and_prepare, submitted % len(paths)))
            submitted += 1
        window_s = t_end - t0
        kept[i] = pipe.fetch(disp)  # the volume in flight, after the window
        trace = tracer.stop(units=done + 1)
        for fut in queue:
            fut.result()
    peak = common.peak_bytes(dev)
    attempted = done
    del pipe, apply_fn, model, queue, prep, disp
    common.free_program(dev)

    check_rng = np.random.default_rng([cell.seed, 1])
    sample = sorted(check_rng.choice(sorted(kept), size=min(int(p["check_sample"]), len(kept)),
                                     replace=False).tolist())
    net = common.reference_net(settings, state, dev)
    gaps = []
    for i in sample:
        norm, mask = common.normalized_raw(settings, raws[i])
        gaps.append(common.map_gaps(kept[i], common.reference_map(net, settings, norm, dev, mask),
                                    tuple(settings["data"]["patch_size"])))
    return harness.Outcome(
        units=done, window_s=window_s, attempted=attempted, failed=0,
        setup_s=setup_s, peak_bytes=peak, setup_split=clock.split, spans=spans, trace=trace,
        work=common.volume_work(settings, shape, dev),
        checks=common.map_check(gaps, cell.limits),
        detail={"sample": sample, "gaps": gaps, "captures": common.captures(),
                **common.timeline(spans, "fetch", w0, w1, cpu_s)})
