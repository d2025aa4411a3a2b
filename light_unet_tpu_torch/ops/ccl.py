"""Connected-component labeling: a device path and a scipy host path (port
of ``light_unet_tpu/ops/ccl.py``).

``label_propagate`` labels each 6-connected component with the largest flat
index of its voxels + 1, exactly as the JAX package does: on a card with
the union-find kernel of ``csrc/ccl.cu`` (a fixed number of launches, no
host read, so a CUDA graph holds it), on the CPU with the JAX package's
sweeps (``ops/ccl_kernel.py:sweep_labels``, its plain version).

``keep_largest_component`` keeps the component with the most voxels (on a
tie, the smaller label, as ``jnp.argmax`` and ``torch.argmax`` both take the
first maximum); its counts are an ``index_add_`` (``bincount`` reads its
size on the host).  ``label_components`` gives scipy's labels and numbering
from either backend: scipy on the host, or ``label_propagate`` renumbered
in first-voxel scan order.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from scipy import ndimage

from light_unet_tpu_torch.ops.ccl_kernel import connected_labels
from light_unet_tpu_torch.utils.device import resolve_device


def label_propagate(mask: torch.Tensor) -> torch.Tensor:
    """Label a [D, H, W] {0,1} mask: int32 labels where each 6-connected
    component carries the max flat index + 1 of its voxels; background 0."""
    return connected_labels(mask)


def keep_largest_component(mask: torch.Tensor) -> torch.Tensor:
    """Largest 6-connected component of a {0,1} mask as float32, all on the
    device (labels, counts, argmax); all zero when there is no foreground."""
    labels = label_propagate(mask).reshape(-1)
    counts = torch.zeros(mask.numel() + 1, dtype=torch.int32, device=mask.device)
    counts.index_add_(0, labels, torch.ones_like(labels))
    counts[:1].zero_()  # the background
    largest = torch.argmax(counts)
    has_fg = counts.amax() > 0
    return torch.where(has_fg & (labels == largest), 1.0, 0.0).reshape(mask.shape)


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
