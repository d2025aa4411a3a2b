"""Lesion candidates of a probability map, plain NumPy and SciPy
(``light_unet/core/inferencer.py:extract_bboxes`` of the upstream
repository): threshold (``>=``), 6-connected components, those under
``min_volume_cc`` dropped and the rest numbered in scan order, each one's
voxel box grown by ``expansion`` voxels and clipped to the volume, its
volume in cc and its confidence, the highest probability inside it."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
from scipy import ndimage

CROSS = ndimage.generate_binary_structure(3, 1)


def candidates(prob: np.ndarray, threshold: float, min_volume_cc: float,
               spacing: Sequence[float], expansion: int) -> List[Dict]:
    voxel_cc = float(spacing[0] * spacing[1] * spacing[2]) / 1000.0
    min_voxels = int(np.ceil(min_volume_cc / voxel_cc))
    labels, n = ndimage.label(prob >= np.float32(threshold), CROSS)
    if n == 0:
        return []
    sizes = np.bincount(labels.ravel(), minlength=n + 1)
    boxes = ndimage.find_objects(labels)
    peaks = ndimage.maximum(prob, labels, np.arange(1, n + 1))
    shape = np.asarray(prob.shape)
    out = []
    for lab in range(1, n + 1):  # scan order of each component's first voxel
        if sizes[lab] < min_voxels:
            continue
        box = boxes[lab - 1]
        mins = np.array([s.start for s in box])
        maxs = np.array([s.stop - 1 for s in box])
        lo = np.maximum(0, mins - expansion)
        hi = np.minimum(shape - 1, maxs + expansion)
        out.append({
            "bbox_voxel": [int(lo[0]), int(hi[0]), int(lo[1]), int(hi[1]), int(lo[2]), int(hi[2])],
            "volume_cc": float(sizes[lab] * voxel_cc),
            "confidence": float(np.float32(peaks[lab - 1])),
        })
    return out


def components(prob: np.ndarray, threshold: float) -> int:
    """Components of the thresholded map before the size filter (the count
    the program's device table holds up to its cap)."""
    return int(ndimage.label(prob >= np.float32(threshold), CROSS)[1])


def mismatches(written: List[Dict], expected: List[Dict]) -> int:
    """Candidates that differ between the program's list and the reference's,
    in order: the count of unequal pairs plus the difference in length."""
    n = abs(len(written) - len(expected))
    for a, b in zip(written, expected):
        same = (list(a.get("bbox_voxel", [])) == b["bbox_voxel"]
                and np.isclose(a.get("volume_cc", -1.0), b["volume_cc"], rtol=1e-9, atol=0)
                and np.float32(a.get("confidence", -1.0)) == np.float32(b["confidence"]))
        n += 0 if same else 1
    return n
