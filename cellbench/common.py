"""What the drivers share: the program's model from the benchmark's
weights, the work a volume holds, freeing the program's state before the
reference runs, and the reference's map of a volume."""

from __future__ import annotations

import gc
import time
from typing import Dict, Optional

import numpy as np
import torch

from cellbench import harness
from cellbench.cost import forward_cost
from cellbench.reference import preprocess as ref_pre
from cellbench.reference.unet import UNet, identity, no_tf32
from cellbench.reference.window import positions, window_map


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    dev = torch.device(device)
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


def free_program(device) -> None:
    """Destroy the program's graphs and give its memory back, so that the
    reference runs in what the program held."""
    from light_unet_tpu_torch.utils import graphs

    graphs.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def captures() -> list:
    """The program's graph captures of this process (``utils/graphs.py``)."""
    from light_unet_tpu_torch.utils import graphs

    return [{"runner": c.runner, "unit": c.key[0], "warmup_s": c.warmup_s,
             "capture_s": c.capture_s, "pool_bytes": c.pool_bytes, "peak": c.peak}
            for c in graphs.captures]


def volume_work(settings: dict, shape, device) -> Dict[str, float]:
    """Operations and bytes of the forward over one volume's windows (the
    windows the volume needs, not the padded slots a schedule may add), and
    the card's peaks for the compute dtype."""
    model, patch = settings["model"], tuple(settings["data"]["patch_size"])
    n = len(positions(shape, patch))
    bf16 = settings["tpu"]["compute_dtype"] == "bfloat16"
    flops, nbytes = forward_cost(model, n, patch, 2 if bf16 else 4, n_params(model))
    return {"windows": n, "flops": flops, "bytes": nbytes, **card_peaks(device, bf16)}


def forward_cost_of(settings: dict, batch: int) -> int:
    """Operations of one forward of ``batch`` patches."""
    model, patch = settings["model"], tuple(settings["data"]["patch_size"])
    return forward_cost(model, batch, patch)[0]


def n_params(model: dict) -> int:
    with torch.device("meta"):
        return sum(p.numel() for p in UNet(model).parameters())


def card_peaks(device, bf16: bool) -> Dict[str, float]:
    dev = torch.device(device)
    peaks = harness.peaks_for(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "")
    return {"peak_flops": peaks.get("bf16_flops_per_s" if bf16 else "fp32_flops_per_s", 0.0),
            "peak_bytes": peaks.get("hbm_bytes_per_s", 0.0)}


def reference_net(settings: dict, state: dict, device, quant=identity) -> UNet:
    no_tf32()
    net = UNet(settings["model"], quant).to(device)
    net.load_state_dict(state)
    return net.eval()


def reference_map(net, settings: dict, normalized: np.ndarray, device,
                  mask: Optional[np.ndarray] = None) -> np.ndarray:
    """The reference's map of a normalized volume, times ``mask``."""
    out = window_map(net, normalized, tuple(settings["data"]["patch_size"]), device)
    return out * mask if mask is not None else out


def map_gaps(written: np.ndarray, ref: np.ndarray, patch) -> Dict[str, float]:
    """Absolute voxel gaps of a map from the reference's: the mean over the
    volume, the largest mean over one window's voxels (the windows the
    volume is computed in, so that a fault in one window shows), and the
    largest voxel's."""
    d = np.abs(written.astype(np.float64) - ref)
    pz, py, px = patch
    window = max(float(d[z:z + pz, y:y + py, x:x + px].mean())
                 for z, y, x in positions(d.shape, patch))
    return {"mean": float(d.mean()), "window": window, "max": float(d.max())}


def map_check(gaps, limits: dict) -> Dict[str, tuple]:
    """``map_gap_mean`` and ``map_gap_window``: (the largest over the
    sampled maps, limit)."""
    return {f"map_gap_{k}": (max(g[k] for g in gaps), float(limits[f"map_gap_{k}"]))
            for k in ("mean", "window")}


def transferred(settings: dict, volume: np.ndarray) -> np.ndarray:
    """A preprocessed volume as the inference stage's stated transfer hands
    it to the card: uint16 levels of its own [min, max], back in float32."""
    if settings["tpu"].get("transfer_dtype") != "uint16":
        return volume
    lo, hi = float(volume.min()), float(volume.max())
    return ref_pre.dequantize_u16(ref_pre.transfer_u16(volume, lo, hi), lo, hi)


def normalized_raw(settings: dict, raw: np.ndarray):
    """(normalized volume, body mask or None) of a raw volume as the serving
    configuration states: clip percentiles, the stated transfer, rescale,
    the body mask when it applies to inference."""
    data = settings["data"]
    inten, bm = data["intensity"], data["body_mask"]
    lo, hi = ref_pre.clip_values(raw, inten["clip_percentile_low"], inten["clip_percentile_high"])
    values = raw
    if settings["tpu"].get("transfer_dtype") == "uint16":
        values = ref_pre.dequantize_u16(ref_pre.transfer_u16(raw, lo, hi), lo, hi)
    rng = inten["normalization_range"]
    norm = ref_pre.normalize(values, lo, hi, float(rng[0]), float(rng[1]))
    mask = None
    if bm.get("enabled") and bm.get("apply_to_inference"):
        mask = ref_pre.body_mask(norm, bm["threshold"], bm["closing_voxels"],
                                 bm["keep_largest_component"], bm["dilate_voxels"])
    return norm, mask


def timeline(spans: harness.Spans, done: str, w0: int, w1: int, cpu_s: float) -> dict:
    """The window's diagnostics for the ``detail`` line, read by no metric,
    from the spans that ran inside it (wall clock ns ``w0`` to ``w1``):
    ``done_s``, the seconds from ``w0`` at which each counted unit completed
    (the end of its span ``done``), in order; ``span_ms``, the 10th, 50th and
    90th percentiles of each span's milliseconds; ``cpu_s``, the process's
    CPU seconds over the window."""
    inside = [(n, s, e) for n, s, e in spans.intervals if s >= w0 and e <= w1]
    ms = {}
    for n, s, e in inside:
        ms.setdefault(n, []).append((e - s) * 1e-6)
    return {"done_s": sorted(round((e - w0) * 1e-9, 3) for n, _, e in inside if n == done),
            "span_ms": {n: [round(float(q), 3) for q in np.percentile(v, (10, 50, 90))]
                        for n, v in sorted(ms.items())},
            "cpu_s": round(cpu_s, 3)}


class Clock:
    """Set-up phases in seconds, in the order they ran."""

    def __init__(self):
        self.split: Dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.split[name] = now - self._t
        self._t = now
