"""Candidate extraction on the device: threshold -> CCL -> component table
(port of ``light_unet_tpu/ops/components.py:34-172``).

Only a ``[K+1, 12]`` table leaves the device.  The cap ``max_components``
is never silent: the exact component count comes alongside, and
``bboxes_from_table`` returns None on overflow (or past the 2^24-voxel f32
exactness envelope) so the caller falls back to the host path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from light_unet_tpu_torch.ops.ccl import label_propagate

_BIGF = 3e9  # > int32 max: empty rows fail the < 2^31 - 1 guard


@torch.no_grad()
def component_table_device(prob: torch.Tensor, threshold: float,
                           max_components: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """(table [K+1, 12] f32, n_components) for the ``prob >= threshold`` components.

    Columns: size, bbox_min (z, y, x), bbox_max (z, y, x), max_prob,
    center (z, y, x), first voxel flat index (scipy scan-order key).  Row 0
    is background; rows follow the label value.  ``n_components`` is exact."""
    mask = prob >= torch.tensor(threshold, dtype=torch.float32)
    labels = label_propagate(mask)
    shape = labels.shape
    n = labels.numel()
    dev = prob.device
    flat_labels = labels.flatten()
    mask_flat = mask.flatten()

    # each component's label is its seed voxel's flat index + 1
    seeds = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    seed_mask = (flat_labels == seeds) & mask_flat
    n_components = seed_mask.sum(dtype=torch.int32)

    seed_idx = torch.full((max_components,), n, dtype=torch.int64, device=dev)
    found = torch.nonzero(seed_mask).flatten()[:max_components]
    seed_idx[: found.numel()] = found
    ranks = torch.arange(1, max_components + 1, dtype=torch.int64, device=dev)
    lut = torch.zeros(n + 2, dtype=torch.int64, device=dev)
    lut[seed_idx + 1] = ranks
    ids = lut[flat_labels]
    num_seg = max_components + 1

    coords = [
        torch.arange(shape[a], device=dev, dtype=torch.float32)
        .reshape([-1 if i == a else 1 for i in range(3)]).expand(shape).flatten()
        for a in range(3)
    ]
    fg = mask_flat.float()
    sum_cols = torch.stack([fg, coords[0] * fg, coords[1] * fg, coords[2] * fg], dim=1)
    sums = torch.zeros((num_seg, 4), dtype=torch.float32, device=dev).index_add_(0, ids, sum_cols)
    sizes = sums[:, 0]
    centers = sums[:, 1:4] / torch.clamp(sizes, min=1.0)[:, None]

    neg = torch.where(mask_flat, 0.0, -_BIGF).to(torch.float32)[:, None]
    flat_idx = torch.arange(n, dtype=torch.float32, device=dev)
    max_cols = torch.stack(
        [-coords[0], -coords[1], -coords[2], coords[0], coords[1], coords[2],
         prob.flatten().float(), -flat_idx], dim=1) + neg
    maxes = torch.full((num_seg, 8), -float("inf"), dtype=torch.float32, device=dev)
    maxes.scatter_reduce_(0, ids[:, None].expand_as(max_cols), max_cols, "amax")  # empty: -inf
    table = torch.cat(
        [sizes[:, None], -maxes[:, 0:3], maxes[:, 3:6],
         torch.clamp(maxes[:, 6], min=-1.0)[:, None], centers, -maxes[:, 7:8]], dim=1)
    return table, n_components


def bboxes_from_table(table: np.ndarray, n_components: int, volume_shape, min_volume_cc: float,
                      spacing, expansion_voxels: int, max_components: int = 64):
    """Host post-processing of the device table -> reference bbox dicts
    (same schema and ordering as ``core.inferencer.extract_bboxes``), or None
    when the host path must take over."""
    if int(n_components) > max_components:
        return None
    if int(np.prod(volume_shape)) >= 2**24:
        return None
    table = np.asarray(table)
    voxel_volume_cc = (spacing[0] * spacing[1] * spacing[2]) / 1000.0
    min_voxels = int(np.ceil(min_volume_cc / voxel_volume_cc))
    shape = np.asarray(volume_shape)
    # size-filter before numbering: scipy renumbers the survivors in scan order
    rows = [row for row in table if int(row[0]) >= min_voxels and row[11] < 2**31 - 1]
    rows.sort(key=lambda r: r[11])

    bboxes = []
    for cid, row in enumerate(rows, start=1):
        mins = row[1:4].astype(int)
        maxs = row[4:7].astype(int)
        lo = np.maximum(0, mins - expansion_voxels)
        hi = np.minimum(shape - 1, maxs + expansion_voxels)
        bboxes.append(
            {
                "mask_id": int(cid),
                "bbox_voxel": [int(lo[0]), int(hi[0]), int(lo[1]), int(hi[1]), int(lo[2]), int(hi[2])],
                "bbox_mm": [
                    float(lo[0] * spacing[0]),
                    float(hi[0] * spacing[0]),
                    float(lo[1] * spacing[1]),
                    float(hi[1] * spacing[1]),
                    float(lo[2] * spacing[2]),
                    float(hi[2] * spacing[2]),
                ],
                "volume_cc": float(int(row[0]) * voxel_volume_cc),
                "confidence": float(row[7]),
            }
        )
    return bboxes
