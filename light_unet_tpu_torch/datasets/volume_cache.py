"""Decode-once volume cache (port of ``light_unet_tpu/datasets/volume_cache.py``).

Volumes are decoded once (the native host library, ``utils/fastio.py``)
and kept as float32 numpy arrays, so patch extraction is a memory slice; an
LRU bound is available for larger-than-RAM datasets.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional

import numpy as np

from light_unet_tpu_torch.utils import fastio


class VolumeCache:
    """Thread-safe LRU cache: path -> (float32 ndarray, NIfTI header)."""

    def __init__(self, max_items: Optional[int] = None):
        self.max_items = max_items
        self._store: "OrderedDict[str, tuple]" = OrderedDict()  # path -> (data, header)
        self._lock = threading.Lock()

    def get_with_header(self, path: str, dtype=np.float32):
        """(decoded volume, parsed header), one decode per path."""
        path = str(path)
        with self._lock:
            if path in self._store:
                self._store.move_to_end(path)
                data, header = self._store[path]
                return (data if dtype == np.float32 else data.astype(dtype)), header
        data, header = fastio.load_f32(path)
        with self._lock:
            self._store[path] = (data, header)
            self._store.move_to_end(path)
            if self.max_items is not None:
                while len(self._store) > self.max_items:
                    self._store.popitem(last=False)
        return (data if dtype == np.float32 else data.astype(dtype)), header

    def get(self, path: str, dtype=np.float32) -> np.ndarray:
        return self.get_with_header(path, dtype)[0]

    def drop(self, paths) -> int:
        """Evict specific entries (train volumes once the device corpus
        serves every pixel read).  Returns the number of bytes freed."""
        freed = 0
        with self._lock:
            for path in paths:
                entry = self._store.pop(str(path), None)
                if entry is not None:
                    freed += int(entry[0].nbytes)
        return freed

    def clear(self) -> None:
        with self._lock:
            self._store.clear()

    def __len__(self) -> int:
        return len(self._store)
