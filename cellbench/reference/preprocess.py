"""Intensity normalization and the body mask of a raw PET volume, plain
NumPy and SciPy (``scripts/preprocess_data.py`` of the upstream repository).

* clip to the 0.5th and 99.5th percentiles (``np.percentile``) and rescale
  to [0, 1];
* body mask: threshold the normalized volume (> 0.02), close with the L1
  ball of radius 5 (``binary_closing`` with the 6-neighbour cross, 5
  iterations, zero border), keep the largest 6-connected component,
  dilate with the cross 3 times.

The serving configurations state ``tpu.transfer_dtype: uint16``: the raw
volume crosses to the card as 16-bit levels of its clip range.
``transfer_u16``, ``dequantize_u16`` and ``normalize`` state that transfer
and the normalization that follows it in float32 arithmetic, one rounding
an operation, so that a voxel next to the threshold falls on the same side
as in any exact float32 implementation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage

CROSS = ndimage.generate_binary_structure(3, 1)


def clip_values(image: np.ndarray, low: float = 0.5, high: float = 99.5) -> Tuple[float, float]:
    return float(np.percentile(image, low)), float(np.percentile(image, high))


def transfer_u16(image: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """uint16 levels of ``image`` in its clip range: clip, subtract lo, times
    float32(65535 / (hi - lo)), round half up."""
    scale = np.float32(65535.0 / (hi - lo)) if hi > lo else np.float32(0.0)
    t = np.clip(image.astype(np.float32), np.float32(lo), np.float32(hi))
    t = (t - np.float32(lo)) * scale + np.float32(0.5)
    return t.astype(np.uint16)


def dequantize_u16(levels: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """The levels back in [lo, hi], float32."""
    f32 = np.float32
    return levels.astype(f32) * ((f32(hi) - f32(lo)) / f32(65535.0)) + f32(lo)


def normalize(values: np.ndarray, lo: float, hi: float, out_lo: float = 0.0,
              out_hi: float = 1.0) -> np.ndarray:
    """Clip to [lo, hi] and rescale to [out_lo, out_hi], float32 throughout."""
    f32 = np.float32
    lo32, hi32 = f32(lo), f32(hi)
    span = hi32 - lo32
    if not span > 0:
        return np.full(values.shape, f32(out_lo), f32)
    scale = f32(out_hi - out_lo) / span
    return ((np.clip(values.astype(f32), lo32, hi32) - lo32) * scale + f32(out_lo)).astype(f32)


def body_mask(normalized: np.ndarray, threshold: float = 0.02, closing: int = 5,
              keep_largest: bool = True, dilate: int = 3) -> np.ndarray:
    """bool body mask of a normalized volume."""
    mask = normalized > np.float32(threshold)
    if closing > 0:
        mask = ndimage.binary_closing(mask, CROSS, iterations=closing)
    if keep_largest:
        labels, n = ndimage.label(mask, CROSS)
        if n > 0:
            sizes = np.bincount(labels.ravel())
            sizes[0] = 0
            mask = labels == int(np.argmax(sizes))
    if dilate > 0:
        mask = ndimage.binary_dilation(mask, CROSS, iterations=dilate)
    return mask
