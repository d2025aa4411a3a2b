"""Data-loader factory + host-side prefetching (port of
``light_unet_tpu/datasets/loader.py``).

``get_data_loader(data_dir, split_file, config, is_train)`` returns a
mode-tagged dict:

* ``standard``    one ``PatchSampler`` behind a ``PrefetchLoader``;
* ``validation``  a ``CaseDataset`` (FL only when mixed training is on).

The mixed-domain training modes (``probabilistic``,
``fl_epoch_plus_dlbcl``) raise ``NotImplementedError`` naming their ROADMAP
item.  One background thread assembles whole numpy batches from the volume
cache ahead of the consumer (queue depth ``prefetch_depth``).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from light_unet_tpu_torch.datasets.case_dataset import CaseDataset
from light_unet_tpu_torch.datasets.patch_sampler import PatchSampler
from light_unet_tpu_torch.datasets.volume_cache import VolumeCache

MIXED_NOT_PORTED = ("training.mixed_domains (probabilistic, fl_epoch_plus_dlbcl) is not ported "
                    "to PyTorch yet: ROADMAP queue 1, item 14 (mixed-domain training)")


class PrefetchLoader:
    """Iterable over ``len(sampler) // batch_size`` prefetched (image, label)
    batches of shape [B, pz, py, px, 1]: float32, or uint16 images and uint8
    labels with ``quantize``."""

    def __init__(self, sampler, batch_size: int, prefetch_depth: int = 3,
                 quantize: bool = False):
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.prefetch_depth = int(prefetch_depth)
        # images (normalized [0,1]) -> uint16 (error <= 1/(2*65535)), binary
        # labels -> uint8 (exact); the train step dequantizes on the device
        self.quantize = bool(quantize)

    def __len__(self) -> int:
        return max(1, len(self.sampler) // self.batch_size)

    @staticmethod
    def _quantize_batch(batch: Tuple[np.ndarray, np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
        images, labels = batch
        q = np.clip(images, 0.0, 1.0)
        q *= np.float32(65535.0)
        q += np.float32(0.5)  # round-to-nearest under the truncating cast
        return q.astype(np.uint16), (labels > 0.5).astype(np.uint8)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        steps = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_depth)
        stop = threading.Event()

        def producer():
            try:
                for _ in range(steps):
                    if stop.is_set():
                        return
                    batch = self.sampler.sample_batch(self.batch_size)
                    if self.quantize:
                        batch = self._quantize_batch(batch)
                    q.put(batch)
            except Exception as e:  # surface producer errors to the consumer
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for _ in range(steps):
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


def _domains_dict(config) -> dict:
    d = config.data.domains
    return {
        "fl_prefix_max": d.fl_prefix_max,
        "dlbcl_prefix_min": d.dlbcl_prefix_min,
        "dlbcl_prefix_max": d.dlbcl_prefix_max,
    }


def get_data_loader(data_dir, split_file, config, is_train: bool = True,
                    cache: Optional[VolumeCache] = None,
                    batch_size: Optional[int] = None) -> Dict:
    """The loader factory; ``batch_size`` overrides ``training.batch_size``."""
    mixed = config.training.mixed_domains
    if not is_train:
        bm = config.data.body_mask
        apply_val = bm.apply_to_validation and bm.enabled
        domain_config = {"domain": "fl", **_domains_dict(config)} if mixed.enabled else None
        dataset = CaseDataset(
            data_dir, split_file, domain_config,
            return_body_mask=apply_val, body_mask_required=apply_val, cache=cache,
        )
        return {"mode": "validation", "val_loader": dataset}

    if mixed.enabled:
        raise NotImplementedError(MIXED_NOT_PORTED)
    if batch_size is None:
        batch_size = config.training.batch_size
    # batch quantization maps [0,1] -> uint16; another normalization range
    # would be clipped, so it engages only for [0,1] data
    quantize = (
        getattr(config.tpu, "transfer_dtype", "float32") == "uint16"
        and list(config.data.intensity.normalization_range) == [0.0, 1.0]
    )
    sampler = PatchSampler(
        data_dir, split_file, tuple(config.data.patch_size),
        config.training.class_balanced_sampling.lesion_patch_ratio,
        config.experiment.seed, None, config.data.body_mask, cache,
    )
    return {"mode": "standard",
            "train_loader": PrefetchLoader(sampler, batch_size, config.tpu.prefetch_depth, quantize)}
