"""Joint device-memory accounting (port of ``light_unet_tpu/utils/hbm_ledger.py``).

``HbmLedger`` is the single accounting point for what the trainer and the
validation sweep keep resident on the device.  Priority order (who degrades
first):

1. parameters + optimizer state — charged unconditionally,
2. the training corpus — capped at the ledger remainder, so it falls back
   to host streaming before anything runs out of memory,
3. validation GT id maps + padded variants — ``try_charge``d per case,
4. the validation input cache — ``try_charge``d per case.

A ``reserve_frac`` slice of the capacity is held back for what the ledger
cannot see per allocation: activations, the sliding-window accumulators and
the caching allocator's own slack.

Capacity: the ``LIGHT_UNET_HBM_GB`` environment variable when set, else the
CUDA device's total memory, else a 16 GiB default (the CPU).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Optional

import torch

_DEFAULT_CAPACITY_GB = 16.0


def detect_hbm_capacity_bytes(device=None) -> int:
    """Device memory capacity: env override > the CUDA device's total > default."""
    env = os.environ.get("LIGHT_UNET_HBM_GB")
    if env:
        return int(float(env) * (1 << 30))
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return int(torch.cuda.get_device_properties(dev).total_memory)
    return int(_DEFAULT_CAPACITY_GB * (1 << 30))


class HbmLedger:
    """Tracks named device-memory reservations against a joint capacity."""

    def __init__(self, capacity_bytes: Optional[int] = None, reserve_frac: float = 0.15,
                 device=None):
        self.capacity = int(capacity_bytes if capacity_bytes is not None
                            else detect_hbm_capacity_bytes(device))
        self.reserve = int(self.capacity * float(reserve_frac))
        self.entries: "OrderedDict[str, int]" = OrderedDict()
        self.denied: "OrderedDict[str, int]" = OrderedDict()  # name -> bytes refused

    # -- accounting --------------------------------------------------------
    def used(self) -> int:
        return sum(self.entries.values())

    def remaining(self) -> int:
        return max(0, self.capacity - self.reserve - self.used())

    def remaining_gb(self) -> float:
        return self.remaining() / (1 << 30)

    def charge(self, name: str, nbytes: int) -> None:
        """Unconditional reservation (an overshoot still shows in the summary)."""
        self.entries[name] = self.entries.get(name, 0) + int(nbytes)

    def try_charge(self, name: str, nbytes: int) -> bool:
        """Reserve only if it fits the remainder; refusals are recorded."""
        nbytes = int(nbytes)
        if nbytes <= self.remaining():
            self.charge(name, nbytes)
            return True
        self.denied[name] = self.denied.get(name, 0) + nbytes
        return False

    def release(self, name: str) -> None:
        self.entries.pop(name, None)

    # -- reporting ----------------------------------------------------------
    def summary(self) -> str:
        gb = 1 << 30
        parts = [f"{k}={v / gb:.2f}" for k, v in self.entries.items()]
        line = (
            f"HBM ledger [GB]: capacity={self.capacity / gb:.2f} "
            f"reserve={self.reserve / gb:.2f} used={self.used() / gb:.2f} "
            f"remaining={self.remaining() / gb:.2f}"
        )
        if parts:
            line += " | " + " ".join(parts)
        if self.denied:
            line += " | degraded: " + " ".join(
                f"{k}(-{v / gb:.2f})" for k, v in self.denied.items()
            )
        return line

    def log(self) -> None:
        print(self.summary())


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors (or arrays) in a state dict, list or nest of them."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))
