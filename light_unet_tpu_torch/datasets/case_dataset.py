"""Whole-volume case iteration for validation (port of
``light_unet_tpu/datasets/case_dataset.py``).

Yields the full image/label volumes, case id, header spacing, and optionally
the body mask (an all-ones mask when absent and not required).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from light_unet_tpu_torch.datasets.index import (
    CaseRecord,
    build_case_index,
    check_body_masks,
)
from light_unet_tpu_torch.datasets.volume_cache import VolumeCache


@dataclass
class CaseSample:
    case_id: str
    image: np.ndarray  # [D,H,W] f32
    label: np.ndarray  # [D,H,W] f32
    spacing: Tuple[float, float, float]
    body_mask: Optional[np.ndarray] = None  # [D,H,W] f32 or None


class CaseDataset:
    """Full-case dataset over a split file."""

    def __init__(
        self,
        data_dir,
        split_file,
        domain_config: Optional[dict] = None,
        return_body_mask: bool = False,
        body_mask_required: bool = False,
        cache: Optional[VolumeCache] = None,
    ):
        self.return_body_mask = return_body_mask
        self.body_mask_required = body_mask_required
        self.cases: List[CaseRecord] = build_case_index(data_dir, split_file, domain_config)
        self.cache = cache if cache is not None else VolumeCache()
        if body_mask_required:
            check_body_masks(self.cases, True, "validation/inference")

    def __len__(self) -> int:
        return len(self.cases)

    def load_case(self, idx: int) -> CaseSample:
        case = self.cases[idx]
        image, header = self.cache.get_with_header(case.image_path)
        label = self.cache.get(case.label_path)
        spacing = tuple(float(s) for s in header.get_zooms()[:3])

        body_mask = None
        if self.return_body_mask:
            if case.body_mask_path is not None:
                try:
                    body_mask = self.cache.get(case.body_mask_path)
                except Exception as e:  # noqa: BLE001
                    if self.body_mask_required:
                        raise RuntimeError(
                            f"Failed to load required body mask for {case.case_id}: {e}"
                        ) from e
                    warnings.warn(
                        f"Failed to load body mask for {case.case_id}: {e}. Using full volume."
                    )
            if body_mask is None:
                if self.body_mask_required:
                    raise FileNotFoundError(
                        f"Body mask required but missing for {case.case_id}"
                    )
                body_mask = np.ones_like(label, dtype=np.float32)
        return CaseSample(case.case_id, image, label, spacing, body_mask)

    def __iter__(self) -> Iterator[CaseSample]:
        return self.iter_prefetch(depth=2)

    def iter_prefetch(self, depth: int = 2) -> Iterator[CaseSample]:
        """Iterate with a bounded decode-ahead window: case ``i+1..i+depth``
        decode in a worker thread while the consumer (device compute) works
        on case ``i``.  Decode errors surface on the consuming side."""
        from concurrent.futures import ThreadPoolExecutor

        n = len(self.cases)
        if n == 0:
            return
        with ThreadPoolExecutor(max_workers=1) as pool:
            window = [pool.submit(self.load_case, i) for i in range(min(depth, n))]
            nxt = len(window)
            while window:
                fut = window.pop(0)
                if nxt < n:
                    window.append(pool.submit(self.load_case, nxt))
                    nxt += 1
                yield fut.result()
