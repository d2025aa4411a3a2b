"""Connected-component labeling on the device (port of
``light_unet_tpu/ops/ccl.py:35-83``).

Every foreground voxel starts with its ``flat index + 1``; directional
sweeps of a masked running max (forward and backward along each axis)
repeat until a full round changes nothing.  Each component then carries the
max seed of its voxels, exactly as in the JAX package (the fixed point does
not depend on the sweep schedule).

A masked running max along an axis is a segmented ``cummax``: with ``seg``
the running count of background voxels, ``seg * big + label`` is ordered
first by run and then by label, so one ``torch.cummax`` sweeps every run of
the axis at once.
"""

from __future__ import annotations

import torch


def _axis_sweep(labels: torch.Tensor, axis: int, reverse: bool, big: int) -> torch.Tensor:
    """Running max of positive labels along ``axis``, restarting at zeros."""
    if reverse:
        labels = labels.flip(axis)
    seg = torch.cumsum(labels == 0, dim=axis, dtype=torch.int64)
    run_max = torch.cummax(seg * big + labels, dim=axis).values - seg * big
    out = torch.where(labels > 0, run_max, torch.zeros_like(labels))
    return out.flip(axis) if reverse else out


def label_propagate(mask: torch.Tensor) -> torch.Tensor:
    """Label a [D, H, W] {0,1} mask: int64 labels where each 6-connected
    component carries the max flat index + 1 of its voxels; background 0."""
    n = mask.numel()
    fg = (mask > 0).to(torch.int64)
    labels = torch.arange(1, n + 1, dtype=torch.int64, device=mask.device).reshape(mask.shape) * fg
    big = n + 1
    while True:
        prev = labels
        for axis in range(3):
            labels = _axis_sweep(labels, axis, False, big)
            labels = _axis_sweep(labels, axis, True, big)
        if torch.equal(labels, prev):
            return labels
