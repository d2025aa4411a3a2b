"""Synthetic PET phantoms (the port's copy of ``tests/synthetic.py:21-121``).

A bright body ellipsoid, hot spherical lesions and an air background,
written as a raw dataset tree ``images/{id}_0000.nii.gz`` +
``labels/{id}.nii.gz`` at 4x4x4 mm through the port's ``utils/nifti.py``.
The draws from ``rng`` are the JAX tests' draws, so one seed gives the same
arrays in both packages.  Used by ``light_unet_tpu_torch/bench.py``
(``build_raw_dataset``: the JAX bench's volumes), the port's measurement
scripts, ``scripts/synthetic_training_run_torch.py`` and
``scripts/full_scale_rehearsal_torch.py``.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from light_unet_tpu_torch.utils import nifti

SPACING = (4.0, 4.0, 4.0)


def _body(shape: Tuple[int, int, int]):
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    cz, cy, cx = shape[0] / 2, shape[1] / 2, shape[2] / 2
    body = ((zz - cz) ** 2 / (0.42 * shape[0]) ** 2 + (yy - cy) ** 2 / (0.42 * shape[1]) ** 2
            + (xx - cx) ** 2 / (0.45 * shape[2]) ** 2) <= 1.0
    return (zz, yy, xx), body


def make_phantom(rng: np.random.Generator, shape: Tuple[int, int, int] = (32, 32, 40),
                 n_lesions: int = 2,
                 lesion_radius: Tuple[int, int] = (2, 3)) -> Tuple[np.ndarray, np.ndarray]:
    """(image, label) float32 phantom volumes."""
    (zz, yy, xx), body = _body(shape)
    image = body * (2.0 + 0.4 * rng.random(shape)) + 0.01 * rng.random(shape)
    label = np.zeros(shape, np.float32)
    for _ in range(n_lesions):
        r = int(rng.integers(lesion_radius[0], lesion_radius[1] + 1))
        c = [int(rng.integers(int(d * 0.3), int(d * 0.7))) for d in shape]  # inside the body
        lesion = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r**2
        image[lesion] = 8.0 + rng.random()
        label[lesion] = 1.0
    return image.astype(np.float32), label


def make_phantom_hard(rng: np.random.Generator, shape: Tuple[int, int, int] = (32, 32, 40),
                      n_lesions: Tuple[int, int] = (1, 4),
                      lesion_radius: Tuple[float, float] = (1.0, 2.0),
                      contrast: Tuple[float, float] = (1.2, 1.5),
                      noise_sigma: float = 0.35) -> Tuple[np.ndarray, np.ndarray]:
    """Low-contrast phantom: lesions only 1.2-1.5x the body mean, radii of
    1-2 voxels, body texture noise (sigma 0.35) comparable to the absolute
    contrast, so that validation recall starts well below 1.0 and has to be
    learned, and the threshold sweep, recall-first model selection, early
    stopping and ReduceLROnPlateau act on real signal."""
    (zz, yy, xx), body = _body(shape)
    body_mean = 2.0
    image = body * (body_mean + noise_sigma * rng.standard_normal(shape)) + 0.01 * rng.random(shape)
    image = np.maximum(image, 0.0)
    label = np.zeros(shape, np.float32)
    for _ in range(int(rng.integers(n_lesions[0], n_lesions[1] + 1))):
        r = float(rng.uniform(lesion_radius[0], lesion_radius[1]))
        c = [int(rng.integers(int(d * 0.3), int(d * 0.7))) for d in shape]
        lesion = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r**2
        factor = float(rng.uniform(contrast[0], contrast[1]))
        # an additive bump over the noisy body, so lesion voxels keep the
        # texture and their edges stay ambiguous
        image[lesion] += body_mean * (factor - 1.0)
        label[lesion] = 1.0
    return image.astype(np.float32), label


def write_case(raw_dir: Path, case_id: str, image: np.ndarray, label: np.ndarray) -> None:
    raw_dir = Path(raw_dir)
    (raw_dir / "images").mkdir(parents=True, exist_ok=True)
    (raw_dir / "labels").mkdir(parents=True, exist_ok=True)
    affine = np.diag([*SPACING, 1.0])
    nifti.save(nifti.Nifti1Image(image, affine), raw_dir / "images" / f"{case_id}_0000.nii.gz")
    nifti.save(nifti.Nifti1Image(label.astype(np.uint8), affine),
               raw_dir / "labels" / f"{case_id}.nii.gz")


def build_raw_dataset(raw_dir: Path, case_ids: Sequence[str],
                      shape: Tuple[int, int, int] = (32, 32, 40), seed: int = 0,
                      hard: bool = False) -> List[str]:
    """One phantom a case id, drawn in order from one generator of ``seed``
    (``tests/synthetic.py:101-113``), written as a raw dataset tree."""
    rng = np.random.default_rng(seed)
    make = make_phantom_hard if hard else make_phantom
    for cid in case_ids:
        image, label = make(rng, shape=shape)
        write_case(raw_dir, cid, image, label)
    return list(case_ids)


def write_split_files(splits_dir: Path, train, val, test=()) -> None:
    splits_dir = Path(splits_dir)
    splits_dir.mkdir(parents=True, exist_ok=True)
    for name, ids in (("train", train), ("val", val), ("test", test)):
        with open(splits_dir / f"{name}_list.txt", "w") as f:
            f.write("\n".join(ids) + ("\n" if ids else ""))
