"""Gaussian importance map for sliding-window blending.

Same construction as the reference (``light_unet/utils.py:142-173``):
separable 1-D Gaussians with center ``len/2`` and sigma ``len/6``, outer
product, normalized to a max of 1.  Computed once on host (it is a tiny
constant folded into the jitted sliding-window program).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=None)
def gaussian_importance_map(patch_size: Tuple[int, int, int]) -> np.ndarray:
    def g1d(length: int) -> np.ndarray:
        center = length / 2.0
        sigma = length / 6.0
        x = np.arange(length)
        return np.exp(-((x - center) ** 2) / (2.0 * sigma**2))

    gz, gy, gx = (g1d(s) for s in patch_size)
    m = np.einsum("i,j,k->ijk", gz, gy, gx)
    return (m / m.max()).astype(np.float32)
