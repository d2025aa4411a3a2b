"""Body-mask generation on the device (port of
``light_unet_tpu/ops/body_mask.py``).

Threshold the normalized PET volume (default 0.02), close with an L1 ball of
radius ``closing_voxels``, keep the largest 6-connected component, dilate by
``dilate_voxels`` (``scripts/preprocess_data.py:91-174`` of the reference).
The chain runs on the device; only the bbox and the metadata are built on
the host.  The metadata schema is the reference's: the voxel count after
each stage and the bbox.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from light_unet_tpu_torch.ops.ccl import keep_largest_component
from light_unet_tpu_torch.ops.intensity import pad_volume
from light_unet_tpu_torch.ops.morphology import binary_closing, binary_dilation
from light_unet_tpu_torch.ops.sliding_window import _valid_mask
from light_unet_tpu_torch.utils.device import resolve_device


def body_mask_core(normalized: torch.Tensor, valid: torch.Tensor, threshold: float,
                   closing_voxels: int, keep_largest: bool,
                   dilate_voxels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(float32 {0,1} mask, int32 [initial, after_closing, after_largest,
    final] voxel counts) of a zero-padded normalized volume."""
    mask = (normalized > threshold).float() * valid
    initial = torch.count_nonzero(mask)
    if closing_voxels > 0:
        mask = binary_closing(mask, closing_voxels, valid)
    after_closing = torch.count_nonzero(mask)
    after_largest = after_closing
    if keep_largest:
        mask = keep_largest_component(mask)
        after_largest = torch.count_nonzero(mask)
    if dilate_voxels > 0:
        mask = binary_dilation(mask, dilate_voxels, valid)
    final = torch.count_nonzero(mask)
    return mask, torch.stack([initial, after_closing, after_largest, final]).to(torch.int32)


def body_mask_settings(body_mask_config) -> Tuple[float, int, bool, int]:
    """(threshold, closing_voxels, keep_largest_component, dilate_voxels) of a
    ``BodyMaskConfig`` or a dict with the same keys."""
    get = body_mask_config.get if isinstance(body_mask_config, dict) else (
        lambda k, d=None: getattr(body_mask_config, k, d))
    return (float(get("threshold", 0.02)), int(get("closing_voxels", 5)),
            bool(get("keep_largest_component", True)), int(get("dilate_voxels", 3)))


def mask_metadata(mask: np.ndarray, counts: np.ndarray, threshold: float, closing_voxels: int,
                  keep_largest: bool, dilate_voxels: int) -> dict:
    """The reference's schema: settings, the four voxel counts and the
    inclusive voxel bbox of the bool ``mask`` ([0,0,0]..shape when empty)."""
    coords = np.argwhere(mask)
    bbox_min = coords.min(axis=0).tolist() if len(coords) else [0, 0, 0]
    bbox_max = coords.max(axis=0).tolist() if len(coords) else list(mask.shape)
    return {
        "threshold": threshold,
        "closing_voxels": closing_voxels,
        "keep_largest_component": keep_largest,
        "dilate_voxels": dilate_voxels,
        "voxel_counts": {
            "initial": int(counts[0]),
            "after_closing": int(counts[1]),
            "after_largest_component": int(counts[2]),
            "final": int(counts[3]),
        },
        "bbox": {"min": bbox_min, "max": bbox_max},
    }


@torch.no_grad()
def generate_body_mask(normalized_image: np.ndarray, body_mask_config, z_bucket: int = 1,
                       device="cuda") -> Tuple[np.ndarray, dict]:
    """(bool mask, metadata) of a normalized [D, H, W] volume."""
    dev = resolve_device(device)
    settings = body_mask_settings(body_mask_config)
    img = np.asarray(normalized_image, dtype=np.float32)
    shape = img.shape
    padded = torch.from_numpy(pad_volume(img, z_bucket)).to(dev)
    valid = _valid_mask(padded.shape, shape, dev)
    mask_dev, counts = body_mask_core(padded, valid, *settings)
    mask = mask_dev.cpu().numpy()[tuple(slice(0, s) for s in shape)] > 0.5
    return mask, mask_metadata(mask, counts.cpu().numpy(), *settings)
