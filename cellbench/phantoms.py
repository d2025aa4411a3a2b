"""Synthetic whole-body PET phantoms, frozen for the benchmark.

A copy of ``light_unet_tpu_torch/tools/synthetic.py:make_phantom`` as it
stood when the benchmark was defined: a bright body ellipsoid over an air
background and hot spherical lesions.  The benchmark's inputs must not
follow later edits of the program, so the generator lives here.  Every
seed gives volumes of the same shape and the same number of lesions; only
the voxel values and the lesion places change.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def body_ellipsoid(shape: Tuple[int, int, int]):
    """((zz, yy, xx) open grids, bool body ellipsoid) of ``shape``."""
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    cz, cy, cx = shape[0] / 2, shape[1] / 2, shape[2] / 2
    body = ((zz - cz) ** 2 / (0.42 * shape[0]) ** 2 + (yy - cy) ** 2 / (0.42 * shape[1]) ** 2
            + (xx - cx) ** 2 / (0.45 * shape[2]) ** 2) <= 1.0
    return (zz, yy, xx), body


def make_phantom(rng: np.random.Generator, shape: Tuple[int, int, int], n_lesions: int = 2,
                 lesion_radius: Tuple[int, int] = (2, 3)) -> Tuple[np.ndarray, np.ndarray]:
    """(float32 image, float32 {0,1} label) of one phantom."""
    (zz, yy, xx), body = body_ellipsoid(shape)
    image = body * (2.0 + 0.4 * rng.random(shape)) + 0.01 * rng.random(shape)
    label = np.zeros(shape, np.float32)
    for _ in range(n_lesions):
        r = int(rng.integers(lesion_radius[0], lesion_radius[1] + 1))
        c = [int(rng.integers(int(d * 0.3), int(d * 0.7))) for d in shape]  # inside the body
        lesion = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r**2
        image[lesion] = 8.0 + rng.random()
        label[lesion] = 1.0
    return image.astype(np.float32), label
