"""Class-balanced 3D patch sampling for training (port of
``light_unet_tpu/datasets/patch_sampler.py``: ``PatchSampler`` and the
FL/DLBCL mixture ``MixedPatchSampler``).

* at construction, pre-sample candidate centers per case: one per 1000
  lesion voxels (min 10) and one per 5000 background voxels (min 10),
  background optionally restricted to the body mask;
* each draw picks lesion-vs-background with ``lesion_patch_ratio``, then a
  uniformly random center;
* patches are clamped at volume borders and zero-padded.

Randomness is the JAX package's numpy stream (``default_rng(seed)``, the
same call sequence), so both packages draw the same patches.  The mixture
draws its domain from its own stream (``seed``) and then calls the FL
sampler (``seed``) or the DLBCL sampler (``seed + 1``); both share one
volume cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from light_unet_tpu_torch.datasets.index import (
    CaseRecord,
    DEFAULT_FL_DOMAIN_CONFIG,
    build_case_index,
    check_body_masks,
)
from light_unet_tpu_torch.datasets.volume_cache import VolumeCache


class PatchSampler:
    """Draws class-balanced [patch]^3 image/label pairs from a split."""

    def __init__(
        self,
        data_dir,
        split_file,
        patch_size: Sequence[int] = (48, 48, 48),
        lesion_patch_ratio: float = 0.5,
        seed: int = 42,
        domain_config: Optional[dict] = None,
        body_mask_config=None,
        cache: Optional[VolumeCache] = None,
    ):
        self.patch_size = tuple(int(p) for p in patch_size)
        self.lesion_patch_ratio = float(lesion_patch_ratio)
        self.rng = np.random.default_rng(seed)
        self.cache = cache if cache is not None else VolumeCache()

        get = (
            body_mask_config.get
            if isinstance(body_mask_config, dict)
            else (lambda k, d=None: getattr(body_mask_config, k, d))
        ) if body_mask_config is not None else (lambda k, d=None: d)
        self.body_mask_enabled = bool(get("enabled", False))
        self.body_mask_required = self.body_mask_enabled and bool(
            get("apply_to_training_sampling", False)
        )

        if domain_config is None:
            domain_config = dict(DEFAULT_FL_DOMAIN_CONFIG)
        self.cases: List[CaseRecord] = build_case_index(data_dir, split_file, domain_config)
        if self.body_mask_required:
            check_body_masks(self.cases, True, "training")

        self.lesion_locations, self.background_locations = self._sample_locations()

    # ------------------------------------------------------------------
    def _sample_locations(self) -> Tuple[List[Tuple[int, np.ndarray]], List[Tuple[int, np.ndarray]]]:
        lesion_locs: List[Tuple[int, np.ndarray]] = []
        bg_locs: List[Tuple[int, np.ndarray]] = []
        for case_idx, case in enumerate(self.cases):
            label = self.cache.get(case.label_path)
            body_mask = None
            if case.body_mask_path is not None:
                body_mask = self.cache.get(case.body_mask_path) > 0.5

            lesion_coords = np.argwhere(label > 0)
            if len(lesion_coords) > 0:
                n = max(10, len(lesion_coords) // 1000)
                idx = self.rng.integers(len(lesion_coords), size=n)
                lesion_locs.extend((case_idx, lesion_coords[i]) for i in idx)

            if body_mask is not None:
                bg_coords = np.argwhere((label == 0) & body_mask)
            else:
                bg_coords = np.argwhere(label == 0)
            if len(bg_coords) > 0:
                n = max(10, len(bg_coords) // 5000)
                idx = self.rng.integers(len(bg_coords), size=n)
                bg_locs.extend((case_idx, bg_coords[i]) for i in idx)
            # the body mask's only reader is this pre-sampling pass (patch
            # extraction never masks), so it leaves the cache here
            if case.body_mask_path is not None:
                self.cache.drop((case.body_mask_path,))
        return lesion_locs, bg_locs

    def __len__(self) -> int:
        """Epoch size: number of pre-sampled locations (reference __len__)."""
        return len(self.lesion_locations) + len(self.background_locations)

    # ------------------------------------------------------------------
    def _extract_patch(self, image: np.ndarray, label: np.ndarray, center: np.ndarray):
        pz, py, px = self.patch_size
        z, y, x = (int(c) for c in center)
        z0 = max(0, z - pz // 2)
        y0 = max(0, y - py // 2)
        x0 = max(0, x - px // 2)
        z1 = min(image.shape[0], z0 + pz)
        y1 = min(image.shape[1], y0 + py)
        x1 = min(image.shape[2], x0 + px)

        img = image[z0:z1, y0:y1, x0:x1]
        lbl = label[z0:z1, y0:y1, x0:x1]
        if img.shape != self.patch_size:
            pad = [(0, pz - img.shape[0]), (0, py - img.shape[1]), (0, px - img.shape[2])]
            img = np.pad(img, pad)
            lbl = np.pad(lbl, pad)
        return img, lbl

    def draw_index(self) -> Tuple[int, int, np.ndarray]:
        """One draw WITHOUT touching pixel data: ``(0, case_idx, center)``.

        Exactly the rng-call sequence of ``draw()`` (one ``random()`` for the
        lesion/background choice, one ``integers()`` for the location pick),
        so a device-corpus run consumes the stream identically to a host
        run: same seed, same patch sequence on either path.  The leading 0
        is the sub-sampler id (a mixed-domain sampler would use it)."""
        use_lesion = self.rng.random() < self.lesion_patch_ratio and self.lesion_locations
        if use_lesion:
            case_idx, center = self.lesion_locations[self.rng.integers(len(self.lesion_locations))]
        elif self.background_locations:
            case_idx, center = self.background_locations[
                self.rng.integers(len(self.background_locations))
            ]
        else:
            case_idx, center = self.lesion_locations[self.rng.integers(len(self.lesion_locations))]
        return 0, case_idx, center

    def draw(self) -> Tuple[np.ndarray, np.ndarray]:
        """One (image, label) patch pair, float32 [pz,py,px]."""
        _, case_idx, center = self.draw_index()
        case = self.cases[case_idx]
        image = self.cache.get(case.image_path)
        label = self.cache.get(case.label_path)
        img, lbl = self._extract_patch(image, label, center)
        return img.astype(np.float32), lbl.astype(np.float32)

    def sample_batch(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Batched draw: ([B,pz,py,px,1] images, labels) float32."""
        imgs, lbls = zip(*(self.draw() for _ in range(batch_size)))
        return (
            np.stack(imgs)[..., None],
            np.stack(lbls)[..., None],
        )


class MixedPatchSampler:
    """Probabilistic FL/DLBCL mixture: FL with probability ``fl_ratio``, else
    DLBCL (FL again when the DLBCL split is empty); per-domain sample counts
    for the ``Domain/*`` TensorBoard scalars."""

    def __init__(
        self,
        data_dir,
        split_file,
        patch_size=(48, 48, 48),
        lesion_patch_ratio: float = 0.5,
        seed: int = 42,
        domain_config: Optional[dict] = None,
        fl_ratio: float = 0.5,
        body_mask_config=None,
        cache: Optional[VolumeCache] = None,
    ):
        self.fl_ratio = float(fl_ratio)
        self.rng = np.random.default_rng(seed)
        base = {**DEFAULT_FL_DOMAIN_CONFIG, **(domain_config or {})}
        prefixes = {k: base[k] for k in ("fl_prefix_max", "dlbcl_prefix_min", "dlbcl_prefix_max")}
        shared_cache = cache if cache is not None else VolumeCache()
        self.fl_sampler = PatchSampler(
            data_dir, split_file, patch_size, lesion_patch_ratio, seed,
            {"domain": "fl", **prefixes}, body_mask_config, shared_cache,
        )
        self.dlbcl_sampler = PatchSampler(
            data_dir, split_file, patch_size, lesion_patch_ratio, seed + 1,
            {"domain": "dlbcl", **prefixes}, body_mask_config, shared_cache,
        )
        self.reset_sample_counts()

    def __len__(self) -> int:
        return len(self.fl_sampler) + len(self.dlbcl_sampler)

    @property
    def patch_size(self):
        return self.fl_sampler.patch_size

    def draw_index(self) -> Tuple[int, int, np.ndarray]:
        """``(sub_sampler, case_idx, center)``, sub-sampler 0 = FL, 1 = DLBCL:
        one ``random()`` for the domain, then the sub-sampler's two calls."""
        if self.rng.random() < self.fl_ratio and len(self.fl_sampler) > 0:
            self.fl_sample_count += 1
            return (0, *self.fl_sampler.draw_index()[1:])
        if len(self.dlbcl_sampler) > 0:
            self.dlbcl_sample_count += 1
            return (1, *self.dlbcl_sampler.draw_index()[1:])
        self.fl_sample_count += 1
        return (0, *self.fl_sampler.draw_index()[1:])

    def draw(self) -> Tuple[np.ndarray, np.ndarray]:
        which, case_idx, center = self.draw_index()
        sampler = self.fl_sampler if which == 0 else self.dlbcl_sampler
        case = sampler.cases[case_idx]
        img, lbl = sampler._extract_patch(sampler.cache.get(case.image_path),
                                          sampler.cache.get(case.label_path), center)
        return img.astype(np.float32), lbl.astype(np.float32)

    def sample_batch(self, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        imgs, lbls = zip(*(self.draw() for _ in range(batch_size)))
        return np.stack(imgs)[..., None], np.stack(lbls)[..., None]

    def reset_sample_counts(self) -> None:
        self.fl_sample_count = 0
        self.dlbcl_sample_count = 0

    def get_sample_counts(self) -> Dict[str, int]:
        return {
            "fl_samples": self.fl_sample_count,
            "dlbcl_samples": self.dlbcl_sample_count,
            "total_samples": self.fl_sample_count + self.dlbcl_sample_count,
        }
