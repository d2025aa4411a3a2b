"""Intensity preprocessing: percentile clip + min-max normalize (port of
``light_unet_tpu/ops/intensity.py``).

The clip values are exact host percentiles (``np.percentile``'s bits,
linear interpolation, a Python-float ``q`` on float32 data, from the native
host library's order statistics, ``utils/fastio.py:percentiles``); the
clip and rescale run on the device over a volume whose last axis may be
zero-padded to a ``z_bucket`` multiple, and the padding is forced to zero.

Every step rounds as the JAX package's does: the scale is the float32
quotient of ``range_max - range_min`` by the float32 ``hi - lo``, and each
step of the chain is its own op (no fused multiply-add).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from light_unet_tpu_torch.ops.sliding_window import _valid_mask
from light_unet_tpu_torch.utils import fastio
from light_unet_tpu_torch.utils.device import resolve_device


def masked_percentile(flat: torch.Tensor, n_valid: int, q: float) -> torch.Tensor:
    """Percentile (linear interpolation) over ``flat[:n_valid]`` of a 1-D
    tensor whose tail is padded with +inf."""
    s = torch.sort(flat).values
    pos = torch.tensor(n_valid - 1, dtype=torch.float32, device=flat.device) * (q / 100.0)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.float()
    return s[lo] * (1.0 - frac) + s[hi] * frac


def clip_normalize_device(volume: torch.Tensor, valid: torch.Tensor, lo, hi, *,
                          range_min: float, range_max: float) -> torch.Tensor:
    """Clip to [lo, hi] and rescale to [range_min, range_max] in float32;
    padding (``valid == 0``) is forced to zero, and ``hi <= lo`` gives
    ``range_min``.  ``lo`` and ``hi`` are floats or float32 tensors on the
    volume's device (the graphed units read them as device data)."""
    dev = volume.device
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=dev) for v in (lo, hi))
    span = hi - lo
    # a true float32 quotient (``float / tensor`` would multiply by a reciprocal)
    scale = torch.full((), float(np.float32(range_max - range_min)), device=dev) / torch.where(
        span > 0, span, 1.0)
    normalized = (torch.clamp(volume, lo, hi) - lo) * scale
    normalized = normalized + float(np.float32(range_min))
    return torch.where(hi > lo, normalized, float(np.float32(range_min))) * valid


def pad_volume(volume: np.ndarray, z_bucket: int) -> np.ndarray:
    """Zero-pad Z up to the bucket (validity is rebuilt on the device from
    the true extents)."""
    shape = volume.shape
    pshape = list(shape)
    if z_bucket > 1 and volume.ndim == 3:
        pshape[2] = ((shape[2] + z_bucket - 1) // z_bucket) * z_bucket
    padded = np.zeros(pshape, dtype=np.float32)
    padded[tuple(slice(0, s) for s in shape)] = volume
    return padded


def pad_to_bucket(volume: np.ndarray, z_bucket: int) -> Tuple[np.ndarray, np.ndarray]:
    """(padded, valid) float32 pair with Z rounded up to the bucket."""
    padded = pad_volume(volume, z_bucket)
    valid = np.zeros(padded.shape, dtype=np.float32)
    valid[tuple(slice(0, s) for s in volume.shape)] = 1.0
    return padded, valid


def compute_clip_values(image: np.ndarray, low_percentile: float = 0.5,
                        high_percentile: float = 99.5) -> Tuple[float, float]:
    """Host-side exact percentiles, ``np.percentile(image, q)`` for each q:
    one native selection serves both ranks (``utils/fastio.py``), and
    non-float32 or non-finite input takes two ``np.percentile`` calls."""
    lo, hi = fastio.percentiles(image, (low_percentile, high_percentile))
    return lo, hi


def intensity_metadata(lo: float, hi: float, low_percentile: float, high_percentile: float,
                       target_range) -> dict:
    """The metadata schema of ``preprocess_data.py:49-57``."""
    return {
        "clip_values": {
            "min": lo,
            "max": hi,
            "low_percentile": low_percentile,
            "high_percentile": high_percentile,
        },
        "normalization_range": list(target_range),
    }


@torch.no_grad()
def clip_and_normalize(image: np.ndarray, low_percentile: float = 0.5,
                       high_percentile: float = 99.5,
                       target_range: Tuple[float, float] = (0.0, 1.0), z_bucket: int = 1,
                       device="cuda") -> Tuple[np.ndarray, dict]:
    """(normalized float32 volume, metadata)."""
    dev = resolve_device(device)
    image = np.asarray(image, dtype=np.float32)
    lo, hi = compute_clip_values(image, low_percentile, high_percentile)
    padded = torch.from_numpy(pad_volume(image, z_bucket)).to(dev)
    valid = _valid_mask(padded.shape, image.shape, dev)
    normalized = clip_normalize_device(padded, valid, lo, hi, range_min=float(target_range[0]),
                                       range_max=float(target_range[1]))
    out = normalized.cpu().numpy()[tuple(slice(0, s) for s in image.shape)]
    return out, intensity_metadata(lo, hi, low_percentile, high_percentile, target_range)
