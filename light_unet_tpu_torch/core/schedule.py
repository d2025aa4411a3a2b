"""Epoch-indexed learning-rate schedules (port of
``light_unet_tpu/core/schedule.py``, the package's own copy).

* ``CosineAnnealingLR``: lr_e = eta_min + (lr0 - eta_min) * (1 + cos(pi*e/T_max)) / 2
* ``ReduceLROnPlateau`` (mode "max"): multiply by ``factor`` after
  ``patience`` epochs without metric improvement, floored at ``min_lr``.

``use_warmup`` performs linear warmup over ``warmup_epochs``.
"""

from __future__ import annotations

import math
from typing import Optional


class LRScheduler:
    """Stateful per-epoch LR computation; serializable via state_dict."""

    def __init__(self, scheduler_cfg, base_lr: float, use_warmup: bool = False, warmup_epochs: int = 0):
        self.cfg = scheduler_cfg
        self.base_lr = float(base_lr)
        self.use_warmup = bool(use_warmup)
        self.warmup_epochs = int(warmup_epochs) if use_warmup else 0
        self.epoch = 0  # number of completed scheduler steps
        # plateau state
        self._scale = 1.0
        self._best: Optional[float] = None
        self._stale = 0

    @property
    def is_plateau(self) -> bool:
        return self.cfg.name == "ReduceLROnPlateau"

    def current_lr(self) -> float:
        if self.use_warmup and self.epoch < self.warmup_epochs:
            return self.base_lr * (self.epoch + 1) / self.warmup_epochs
        if self.cfg.name == "CosineAnnealingLR":
            eta_min = self.cfg.eta_min
            t = min(self.epoch, self.cfg.T_max)
            return eta_min + (self.base_lr - eta_min) * (1 + math.cos(math.pi * t / self.cfg.T_max)) / 2
        # plateau: scaled base lr
        return max(self.cfg.min_lr, self.base_lr * self._scale)

    def step(self, metric: Optional[float] = None) -> float:
        """Advance one epoch (pass the monitored metric for plateau mode);
        returns the lr for the NEXT epoch."""
        if self.is_plateau:
            if metric is not None:
                better = self._best is None or (
                    metric > self._best if self.cfg.mode == "max" else metric < self._best
                )
                if better:
                    self._best = metric
                    self._stale = 0
                else:
                    self._stale += 1
                    if self._stale > self.cfg.patience:
                        self._scale *= self.cfg.factor
                        self._stale = 0
        self.epoch += 1
        return self.current_lr()

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "scale": self._scale,
            "best": self._best,
            "stale": self._stale,
        }

    def load_state_dict(self, d: dict) -> None:
        self.epoch = int(d.get("epoch", 0))
        self._scale = float(d.get("scale", 1.0))
        self._best = d.get("best")
        self._stale = int(d.get("stale", 0))
