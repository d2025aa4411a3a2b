"""The inference stage over a preprocessed split: whole
``Inferencer.infer_split`` calls (``light_unet_tpu_torch/core/inferencer.py``),
repeated until the window is spent.

Traffic (``params``): ``cases`` seeded phantoms of ``shape``, normalized
to [0, 1] (percentile clip) and written as a preprocessed tree
(``images/``, ``body_masks/``: the phantom's body) with a split file; the
benchmark's weights as a reference ``.pth`` that the stage loads.  Each
call decodes and prepares on a worker thread, runs the window and the
candidate table on the card and writes ``{case}_prob.nii.gz`` and
``{case}_bboxes.json`` for every case, overwriting the last call's.  The
window holds whole calls: it ends with the first call that ends after
``--seconds``; a case counts when its files are written.

Check: ``check_sample`` cases drawn from the seed, from the files the last
call wrote.  ``map_gap_mean``: the mean absolute difference of a voxel of
the written map from the float32 reference's map (windowed forward,
Gaussian blend, body mask), and ``map_gap_window``: the largest such mean
over one window's voxels (the largest voxel's is printed beside them).
``bbox_mismatch``: candidates of the written JSON that differ from the
reference's candidates of the written map (threshold, components, size
filter, boxes, volumes, confidences), an exact count over every candidate
of the sampled cases.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cellbench import common, harness, nifti_io, phantoms, weights
from cellbench.reference import preprocess as ref_pre
from cellbench.reference import table as ref_table


class _Timed:
    """A module whose function ``attr`` runs inside the harness span ``name``
    (the stage calls the module's functions by attribute)."""

    def __init__(self, module, spans, attr: str, name: str):
        self._module, self._attr = module, attr
        self._fn = spans.wrap(getattr(module, attr), name)

    def __getattr__(self, attr):
        return self._fn if attr == self._attr else getattr(self._module, attr)


def make_inputs(cell: harness.Cell, settings: dict):
    """(data dir, split file, case ids, normalized volumes, body masks)."""
    p = cell.params
    shape = tuple(p["shape"])
    rng = np.random.default_rng(cell.seed)
    data = cell.workdir / "processed"
    for sub in ("images", "body_masks"):
        (data / sub).mkdir(parents=True, exist_ok=True)
    inten = settings["data"]["intensity"]
    _, body = phantoms.body_ellipsoid(shape)
    body = np.broadcast_to(body, shape).astype(np.uint8)
    ids, norms = [], []
    for k in range(int(p["cases"])):
        raw = phantoms.make_phantom(rng, shape, p.get("lesions", 2))[0]
        lo, hi = ref_pre.clip_values(raw, inten["clip_percentile_low"],
                                     inten["clip_percentile_high"])
        ids.append(f"{k + 1:04d}")
        norms.append(ref_pre.normalize(raw, lo, hi, *map(float, inten["normalization_range"])))
    jobs = [(data / "images" / f"{c}_0000.nii.gz", v) for c, v in zip(ids, norms)]
    jobs += [(data / "body_masks" / f"{c}.nii.gz", body) for c in ids]
    with ThreadPoolExecutor(4) as ex:
        list(ex.map(lambda job: nifti_io.write(*job), jobs))
    split = cell.workdir / "split.txt"
    split.write_text("\n".join(ids) + "\n")
    return data, split, ids, norms, body


def run(cell: harness.Cell) -> harness.Outcome:
    p = cell.params
    dev = torch.device(cell.device)
    clock = common.Clock()
    import light_unet_tpu_torch.core.inferencer as inferencer_mod
    from light_unet_tpu_torch.config import Config
    clock.lap("imports")

    settings = cell.settings()
    data, split, ids, norms, body = make_inputs(cell, settings)
    state = weights.cell_state(cell, dev)
    ckpt = cell.workdir / "model.pth"
    torch.save({"model_state_dict": {k: v.cpu() for k, v in state.items()}}, ckpt)
    clock.lap("inputs")

    cfg = Config.from_dict(settings)
    work = cell.workdir / "work"
    inf = inferencer_mod.Inferencer(cfg, str(ckpt), workdir=str(work), device=dev)
    clock.lap("model")

    # one shape: the first case captures the window and the table, the second replays
    warm = cell.workdir / "warm.txt"
    warm.write_text("\n".join(ids[:2]) + "\n")
    inf.infer_split(warm, data)
    common.sync(dev)
    clock.lap("warmup")
    setup_s = time.perf_counter() - cell.t_start

    spans = harness.Spans()
    tracer = harness.Tracer(cell.trace, dev, spans)
    saved = {k: getattr(inferencer_mod, k) for k in ("nifti", "json", "run_unit")}
    inferencer_mod.nifti = _Timed(saved["nifti"], spans, "save", "write_map")
    inferencer_mod.json = _Timed(saved["json"], spans, "dump", "write_json")
    inferencer_mod.run_unit = spans.wrap(saved["run_unit"], "table")
    inf._load_case_inputs = spans.wrap(inf._load_case_inputs, "decode_prepare")
    inf._dispatch = spans.wrap(inf._dispatch, "dispatch")
    inf.sw.fetch = spans.wrap(inf.sw.fetch, "fetch")
    done = failed = attempted = 0
    try:
        tracer.start()
        t0, w0, cpu0 = time.perf_counter(), time.time_ns(), time.process_time()
        while time.perf_counter() - t0 < cell.seconds:
            res = inf.infer_split(split, data)
            done += res["successful"]
            failed += len(res["failed"])
            attempted += len(ids)
        window_s = time.perf_counter() - t0
        w1, cpu_s = time.time_ns(), time.process_time() - cpu0
        trace = tracer.stop(units=done)
    finally:
        for k, v in saved.items():
            setattr(inferencer_mod, k, v)
    peak = common.peak_bytes(dev)
    del inf
    common.free_program(dev)

    out_cfg, data_cfg = settings["output"], settings["data"]
    threshold = float(settings["validation"]["default_threshold"])
    check_rng = np.random.default_rng([cell.seed, 1])
    sample = sorted(check_rng.choice(len(ids), size=min(int(p["check_sample"]), len(ids)),
                                     replace=False).tolist())
    net = common.reference_net(settings, state, dev)
    gaps, mismatch, found, components = [], 0, [], []
    for k in sample:
        cid = ids[k]
        written, spacing = nifti_io.read(work / out_cfg["prob_maps_dir"] / f"{cid}_prob.nii.gz")
        written = written.astype(np.float32)
        boxes = json.loads((work / out_cfg["bboxes_dir"] / f"{cid}_bboxes.json").read_text())
        ref = common.reference_map(net, settings, common.transferred(settings, norms[k]), dev,
                                   body)
        gaps.append(common.map_gaps(written, ref, tuple(data_cfg["patch_size"])))
        expected = ref_table.candidates(written, threshold,
                                        float(data_cfg["volume_threshold"]["inference_cc"]),
                                        spacing, int(data_cfg["bbox_expansion_voxels"]))
        mismatch += ref_table.mismatches(boxes["candidates"], expected)
        found.append(len(expected))
        components.append(ref_table.components(written, threshold))
    return harness.Outcome(
        units=done, window_s=window_s, attempted=attempted, failed=failed, setup_s=setup_s,
        peak_bytes=peak, setup_split=clock.split, spans=spans,
        trace=trace, work=common.volume_work(settings, tuple(p["shape"]), dev),
        checks={**common.map_check(gaps, cell.limits),
                "bbox_mismatch": (float(mismatch), float(cell.limits["bbox_mismatch"]))},
        detail={"sample": sample, "gaps": gaps, "candidates": found, "components": components,
                "captures": common.captures(),
                **common.timeline(spans, "write_json", w0, w1, cpu_s)})
