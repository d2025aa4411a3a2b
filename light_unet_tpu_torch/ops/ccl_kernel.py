"""6-connected component labels of a [D, H, W] mask: the union-find kernel
of ``csrc/ccl.cu`` and its plain version (the port of
``light_unet_tpu/ops/ccl.py:label_propagate``).

Each component carries the largest flat index of its voxels + 1, the
background 0, as int32, exactly as the JAX package labels.

On a CUDA tensor ``connected_labels`` launches the kernel (three launches:
each tile of 8x8x32 voxels labelled in shared memory, the tiles' faces
merged in the label array, finalize; no host read, no scratch: its global
union-find forest lives in the label array) or raises; on a CPU tensor it
runs the plain version beside it, ``sweep_labels``: every foreground voxel
starts with its ``flat index + 1``, and directional sweeps of a masked
running max (forward and backward along each axis) repeat until a full
round changes nothing, as the JAX package's ``lax.while_loop`` does.  Its loop reads a
device value on the host each round, so it is never the card's path.
``launches`` counts kernel calls.

A masked running max along an axis is a segmented ``cummax``: with ``seg``
the running count of background voxels, ``seg * big + label`` is ordered
first by run and then by label, so one ``torch.cummax`` sweeps every run of
the axis at once.
"""

from __future__ import annotations

import torch

from light_unet_tpu_torch.ops import _build

launches = 0


def _axis_sweep(labels: torch.Tensor, axis: int, reverse: bool, big: int) -> torch.Tensor:
    """Running max of positive labels along ``axis``, restarting at zeros."""
    if reverse:
        labels = labels.flip(axis)
    seg = torch.cumsum(labels == 0, dim=axis, dtype=torch.int64)
    run_max = torch.cummax(seg * big + labels, dim=axis).values - seg * big
    out = torch.where(labels > 0, run_max, torch.zeros_like(labels))
    return out.flip(axis) if reverse else out


def sweep_labels(mask: torch.Tensor) -> torch.Tensor:
    """Plain version: the sweeps until a round changes nothing (int32)."""
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
            return labels.to(torch.int32)


@torch.no_grad()
def connected_labels(x: torch.Tensor) -> torch.Tensor:
    """int32 labels of the {0, 1} (or any: foreground is ``x > 0``) mask ``x``."""
    if x.device.type == "cpu":
        return sweep_labels(x)
    if x.device.type != "cuda" or x.dim() != 3 or x.numel() >= 2**31 - 1:
        raise ValueError(f"CCL kernel takes a 3-D CUDA tensor of fewer than 2^31 - 1 voxels, "
                         f"got {tuple(x.shape)} on {x.device}")
    global launches
    fg = (x > 0).contiguous()  # bool: one byte a voxel, 0 or 1
    labels = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    d, h, w = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load("ccl")
    rc = lib.ccl_label(fg.data_ptr(), labels.data_ptr(), d, h, w, stream)
    _build.check(lib, rc, "ccl_label")
    launches += 1
    return labels
