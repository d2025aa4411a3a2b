"""Sliding-window inference over a whole volume, plain float32.

The published scheme (``light_unet/utils.py`` of the upstream repository):
48^3 windows at overlap 0.5 (stride 24), the last window of each axis
snapped to the volume's edge, every window weighted by a Gaussian
importance map (centre ``len / 2``, sigma ``len / 6``, peak 1) and the
weighted sum divided by the summed weights.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def positions(shape: Sequence[int], patch: Sequence[int], overlap: float = 0.5) -> np.ndarray:
    """[N, 3] window origins."""
    axes = []
    for dim, p in zip(shape, patch):
        stride = max(1, int(p * (1.0 - overlap)))
        if dim <= p:
            axes.append([0])
            continue
        pos = list(range(0, dim - p + 1, stride))
        if pos[-1] + p < dim:
            pos.append(dim - p)
        axes.append(pos)
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


def gaussian(patch: Sequence[int]) -> np.ndarray:
    def g1(n):
        x = np.arange(n)
        return np.exp(-((x - n / 2.0) ** 2) / (2.0 * (n / 6.0) ** 2))

    m = np.einsum("i,j,k->ijk", *(g1(n) for n in patch))
    return (m / m.max()).astype(np.float32)


@torch.no_grad()
def window_map(net, volume: np.ndarray, patch: Sequence[int], device, batch: int = 24
               ) -> np.ndarray:
    """The blended float32 map of ``net`` over ``volume`` [D, H, W] (every
    axis at least the patch), computed ``batch`` windows at a time."""
    vol = torch.as_tensor(np.ascontiguousarray(volume, np.float32), device=device)
    w = torch.as_tensor(gaussian(patch), device=device)
    acc = torch.zeros_like(vol)
    cnt = torch.zeros_like(vol)
    pos = positions(volume.shape, patch)
    pz, py, px = patch
    for s in range(0, len(pos), batch):
        chunk = pos[s:s + batch]
        x = torch.stack([vol[z:z + pz, y:y + py, q:q + px] for z, y, q in chunk])[:, None]
        pred = net(x)[:, 0]
        for (z, y, q), p in zip(chunk, pred):
            acc[z:z + pz, y:y + py, q:q + px] += p * w
            cnt[z:z + pz, y:y + py, q:q + px] += w
    out = torch.where(cnt > 0, acc / torch.where(cnt > 0, cnt, torch.ones_like(cnt)), acc)
    return out.cpu().numpy()
