"""Masks for the CCL tests (``tests/test_torch_ccl.py`` on the CPU,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 13 on the card):
adversarial cases of the labelling.  Imports numpy only, so that the card's
tests, which run without JAX, can use it."""

import numpy as np


def serpentine(depth: int, height: int, width: int) -> np.ndarray:
    """Rows along the last axis at even y, joined at alternating ends by one
    voxel at odd y, in every z-plane: the label of the last row reaches the
    first one row a sweep round."""
    m = np.zeros((depth, height, width), np.uint8)
    m[:, 0::2, :] = 1
    for y in range(1, height - 1, 2):
        m[:, y, width - 1 if (y // 2) % 2 == 0 else 0] = 1
    return m


def adversarial_masks() -> dict:
    rng = np.random.default_rng(5)
    blob = np.zeros((12, 14, 16), np.uint8)
    zz, yy, xx = np.mgrid[:12, :14, :16]
    blob[((zz - 6) / 5.0) ** 2 + ((yy - 7) / 6.0) ** 2 + ((xx - 8) / 7.0) ** 2 <= 1.0] = 1
    checker = ((zz + yy + xx) % 2 == 0).astype(np.uint8)  # every voxel its own component
    return {
        "serpentine": serpentine(2, 48, 16),
        "one_large": blob,
        "many_single_voxels": checker,
        "empty": np.zeros((6, 7, 8), np.uint8),
        "full": np.ones((6, 7, 8), np.uint8),
        "random": (rng.random((10, 11, 12)) > 0.55).astype(np.uint8),
    }
