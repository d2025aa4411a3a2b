"""Binary morphology on the device (port of
``light_unet_tpu/ops/morphology.py``).

Dilation and erosion by the L1 ball (diamond) of radius k are k iterated
6-neighbourhood (cross) dilations or erosions, each the max or min of the
voxel and its six shifted neighbours.  This is scipy's
``iterate_structure(generate_binary_structure(3, 1), k)`` with
``border_value=0``; a ``valid`` mask clamps every dilation so bucket padding
acts as the edge of the unpadded volume.  ``max_pool3d`` is not used: its
window is a cube, not the L1 ball.

All functions take and return float32 {0, 1} tensors of shape [D, H, W].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _neighbor(x: torch.Tensor, axis: int, delta: int, fill: float) -> torch.Tensor:
    """Value of the neighbour ``delta`` steps along ``axis`` (out of bounds -> fill)."""
    size = x.shape[axis]
    pad = [0] * (2 * x.ndim)
    k = 2 * (x.ndim - 1 - axis)  # F.pad lists (before, after) pairs from the last axis
    if delta > 0:
        pad[k] = delta
        start = 0
    else:
        pad[k + 1] = -delta
        start = -delta
    return F.pad(x, pad, value=fill).narrow(axis, start, size)


def dilate_cross(x: torch.Tensor) -> torch.Tensor:
    """One 6-connectivity binary dilation (zero border)."""
    out = x
    for axis in range(3):
        out = torch.maximum(out, _neighbor(x, axis, 1, 0.0))
        out = torch.maximum(out, _neighbor(x, axis, -1, 0.0))
    return out


def erode_cross(x: torch.Tensor) -> torch.Tensor:
    """One 6-connectivity binary erosion (zero border, scipy ``border_value=0``)."""
    out = x
    for axis in range(3):
        out = torch.minimum(out, _neighbor(x, axis, 1, 0.0))
        out = torch.minimum(out, _neighbor(x, axis, -1, 0.0))
    return out


def binary_dilation(x: torch.Tensor, iterations: int,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k iterated cross dilations == dilation by the L1 ball of radius k;
    ``valid`` clamps growth so bucket padding acts as the array edge."""
    for _ in range(iterations):
        x = dilate_cross(x)
        if valid is not None:
            x = x * valid
    return x


def binary_erosion(x: torch.Tensor, iterations: int) -> torch.Tensor:
    for _ in range(iterations):
        x = erode_cross(x)
    return x


def binary_closing(x: torch.Tensor, radius: int,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Closing by the L1 ball of radius ``radius``: erosion of the
    valid-clamped dilation (scipy ``binary_closing`` parity, including its
    zero-border erosion)."""
    return binary_erosion(binary_dilation(x, radius, valid), radius)
