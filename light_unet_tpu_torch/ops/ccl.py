"""Connected-component labeling: a device path and a scipy host path (port
of ``light_unet_tpu/ops/ccl.py``).

Every foreground voxel starts with its ``flat index + 1``; directional
sweeps of a masked running max (forward and backward along each axis)
repeat until a full round changes nothing.  Each component then carries the
max seed of its voxels, exactly as in the JAX package (the fixed point does
not depend on the sweep schedule).

A masked running max along an axis is a segmented ``cummax``: with ``seg``
the running count of background voxels, ``seg * big + label`` is ordered
first by run and then by label, so one ``torch.cummax`` sweeps every run of
the axis at once.

``keep_largest_component`` keeps the component with the most voxels (on a
tie, the smaller label, as ``jnp.argmax`` and ``torch.argmax`` both take the
first maximum).  ``label_components`` gives scipy's labels and numbering
from either backend: scipy on the host, or ``label_propagate`` renumbered
in first-voxel scan order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import ndimage

from light_unet_tpu_torch.utils.device import resolve_device


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


def keep_largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Largest 6-connected component of a {0,1} mask as float32, all on the
    device (labels, bincount, argmax); all zero when there is no foreground."""
    labels = label_propagate(mask)
    counts = torch.bincount(labels.reshape(-1), minlength=mask.numel() + 1)
    counts[0] = 0
    largest = torch.argmax(counts)
    has_fg = counts[largest] > 0
    return torch.where(has_fg, (labels == largest).float(),
                       torch.zeros(mask.shape, dtype=torch.float32, device=mask.device))


def _renumber_scan_order(raw: np.ndarray) -> Tuple[np.ndarray, int]:
    """Renumber positive labels to 1..n in first-voxel scan order (scipy's numbering)."""
    uniq, first_idx, inverse = np.unique(raw.reshape(-1), return_index=True, return_inverse=True)
    new_vals = np.zeros(len(uniq), dtype=np.int32)
    rank = 1
    for u in np.argsort(first_idx):
        if uniq[u] != 0:
            new_vals[u] = rank
            rank += 1
    return new_vals[inverse].reshape(raw.shape), rank - 1


def label_components(mask: np.ndarray, backend: str = "host",
                     device="cuda") -> Tuple[np.ndarray, int]:
    """6-connectivity labels and count with scipy's output.

    ``backend="host"`` runs scipy; ``backend="device"`` runs
    ``label_propagate`` on ``device`` and renumbers on the host."""
    if backend == "host":
        labeled, n = ndimage.label(np.asarray(mask) > 0)
        return labeled.astype(np.int32), int(n)
    if backend != "device":
        raise ValueError(f"backend must be 'host' or 'device', got {backend!r}")
    t = torch.as_tensor(np.asarray(mask, dtype=np.float32), device=resolve_device(device))
    return _renumber_scan_order(label_propagate(t).cpu().numpy())
