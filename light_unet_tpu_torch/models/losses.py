"""Segmentation losses (port of ``light_unet_tpu/models/losses.py``).

* Focal Tversky loss — FN weight ``alpha`` (0.7), FP weight ``beta`` (0.3),
  focal ``gamma`` (0.75);
* combined loss — ``ftl_weight`` * FTL + ``bce_weight`` * BCE;
* Dice loss.

All losses take **probabilities** (the sigmoid is inside the model) and
flatten across the whole batch before reducing: TP/FP/FN are global sums.
Reductions run in float32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_BCE_EPS = 1e-7  # clamp for log() on probabilities


def _focal_pow(base: torch.Tensor, gamma: float) -> torch.Tensor:
    """``base ** gamma`` with a zero gradient at ``base == 0``.

    ``d/dx x**g`` diverges at 0 for g < 1, and a perfectly predicted batch
    (saturated bf16 sigmoids) hits base == 0 exactly.  The inner ``where``
    keeps the pow's input away from 0, so its gradient is finite and the
    outer ``where`` sends 0 to it; the value is unchanged."""
    pos = base > 0.0
    safe = torch.where(pos, base, torch.ones_like(base))
    return torch.where(pos, safe ** gamma, torch.zeros_like(base))


def focal_tversky_loss(pred, target, alpha=0.7, beta=0.3, gamma=0.75, smooth=1e-6):
    """Focal Tversky loss on probabilities; global flatten over the batch."""
    pred = pred.reshape(-1).float()
    target = target.reshape(-1).float()
    tp = torch.sum(pred * target)
    fp = torch.sum(pred * (1.0 - target))
    fn = torch.sum((1.0 - pred) * target)
    tversky = (tp + smooth) / (tp + alpha * fn + beta * fp + smooth)
    return _focal_pow(1.0 - tversky, gamma)


def bce_loss(pred, target):
    """Binary cross-entropy on probabilities (``nn.BCELoss`` mean)."""
    pred = torch.clamp(pred.reshape(-1).float(), _BCE_EPS, 1.0 - _BCE_EPS)
    target = target.reshape(-1).float()
    return -torch.mean(target * torch.log(pred) + (1.0 - target) * torch.log(1.0 - pred))


def combined_loss(pred, target, ftl_weight=0.8, bce_weight=0.2, alpha=0.7, beta=0.3, gamma=0.75):
    """ftl_weight * FocalTversky + bce_weight * BCE."""
    ftl = focal_tversky_loss(pred, target, alpha=alpha, beta=beta, gamma=gamma)
    return ftl_weight * ftl + bce_weight * bce_loss(pred, target)


def dice_loss(pred, target, smooth=1e-6):
    """1 - soft Dice, global flatten over the batch."""
    pred = pred.reshape(-1).float()
    target = target.reshape(-1).float()
    intersection = torch.sum(pred * target)
    union = torch.sum(pred) + torch.sum(target)
    return 1.0 - (2.0 * intersection + smooth) / (union + smooth)


def masked_loss(pred, target, valid_mask, *, name, alpha, beta, gamma,
                use_combined, ftl_weight, bce_weight):
    """The configured loss restricted to ``valid_mask``: equals the plain
    loss on the cropped arrays, so bucket-padded device maps need no crop.
    BCE's mean divides by the masked voxel count."""
    pred = pred.reshape(-1).float()
    target = target.reshape(-1).float()
    m = valid_mask.reshape(-1).float()
    pred = pred * m
    target = target * m

    def ftl():
        tp = torch.sum(pred * target)
        fp = torch.sum(pred * (1.0 - target) * m)
        fn = torch.sum((1.0 - pred) * target)
        tversky = (tp + 1e-6) / (tp + alpha * fn + beta * fp + 1e-6)
        return _focal_pow(1.0 - tversky, gamma)

    def bce():
        p = torch.clamp(pred, _BCE_EPS, 1.0 - _BCE_EPS)
        terms = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
        return torch.sum(terms * m) / torch.clamp(torch.sum(m), min=1.0)

    if use_combined:
        return ftl_weight * ftl() + bce_weight * bce()
    if name == "FocalTverskyLoss":
        return ftl()
    if name == "DiceLoss":
        intersection = torch.sum(pred * target)
        union = torch.sum(pred) + torch.sum(target)
        return 1.0 - (2.0 * intersection + 1e-6) / (union + 1e-6)
    raise ValueError(f"Unknown loss function: {name}")


def get_masked_loss_function(loss_cfg) -> Callable:
    """``fn(pred, target, valid_mask)`` for the configured loss."""
    w = loss_cfg.combined_loss_weights if loss_cfg.use_combined_loss else {}

    def _fn(pred, target, valid_mask):
        return masked_loss(
            pred, target, valid_mask,
            name=loss_cfg.name, alpha=loss_cfg.alpha, beta=loss_cfg.beta,
            gamma=loss_cfg.gamma, use_combined=loss_cfg.use_combined_loss,
            ftl_weight=w.get("focal_tversky", 0.8),
            bce_weight=w.get("bce", 0.2),
        )

    return _fn


def host_val_loss(pred, target, loss_cfg) -> float:
    """Numpy mirror of the configured loss (float32 math) for the validation
    host fallback, where the map is already on the host."""
    pred = np.asarray(pred, np.float32).reshape(-1)
    target = np.asarray(target, np.float32).reshape(-1)

    def ftl():
        tp = np.float32((pred * target).sum(dtype=np.float32))
        fp = np.float32((pred * (1.0 - target)).sum(dtype=np.float32))
        fn = np.float32(((1.0 - pred) * target).sum(dtype=np.float32))
        tversky = (tp + np.float32(1e-6)) / (
            tp + np.float32(loss_cfg.alpha) * fn + np.float32(loss_cfg.beta) * fp + np.float32(1e-6)
        )
        return float((1.0 - tversky) ** np.float32(loss_cfg.gamma))

    def bce():
        p = np.clip(pred, _BCE_EPS, 1.0 - _BCE_EPS).astype(np.float32)
        terms = -(target * np.log(p) + (1.0 - target) * np.log(1.0 - p))
        return float(terms.mean(dtype=np.float32))

    if loss_cfg.use_combined_loss:
        w = loss_cfg.combined_loss_weights
        return w["focal_tversky"] * ftl() + w["bce"] * bce()
    if loss_cfg.name == "FocalTverskyLoss":
        return ftl()
    if loss_cfg.name == "DiceLoss":
        inter = np.float32((pred * target).sum(dtype=np.float32))
        union = np.float32(pred.sum(dtype=np.float32)) + np.float32(target.sum(dtype=np.float32))
        return float(1.0 - (2.0 * inter + np.float32(1e-6)) / (union + np.float32(1e-6)))
    raise ValueError(f"Unknown loss function: {loss_cfg.name}")


def get_loss_function(loss_cfg) -> Callable:
    """``fn(pred, target)`` from a ``LossConfig``."""
    if loss_cfg.use_combined_loss:
        w = loss_cfg.combined_loss_weights

        def _combined(pred, target):
            return combined_loss(
                pred, target, ftl_weight=w["focal_tversky"], bce_weight=w["bce"],
                alpha=loss_cfg.alpha, beta=loss_cfg.beta, gamma=loss_cfg.gamma,
            )

        return _combined
    if loss_cfg.name == "FocalTverskyLoss":

        def _ftl(pred, target):
            return focal_tversky_loss(
                pred, target, alpha=loss_cfg.alpha, beta=loss_cfg.beta, gamma=loss_cfg.gamma
            )

        return _ftl
    if loss_cfg.name == "DiceLoss":
        return dice_loss
    raise ValueError(f"Unknown loss function: {loss_cfg.name}")
