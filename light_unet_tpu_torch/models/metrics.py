"""Host connected components (port of ``light_unet_tpu/models/metrics.py:41``).

Used by the inferencer's host fallback when a volume has more candidate
components than the device table holds.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import ndimage


def get_connected_components(mask: np.ndarray, min_size: int = 0) -> Tuple[np.ndarray, int]:
    """6-connected components; drop components smaller than ``min_size`` voxels
    and relabel the survivors contiguously."""
    labeled, n = ndimage.label(mask)
    if min_size > 0 and n > 0:
        sizes = np.bincount(labeled.ravel())
        too_small = sizes < min_size
        too_small[0] = False
        labeled[too_small[labeled]] = 0
        labeled, n = ndimage.label(labeled > 0)
    return labeled, n
