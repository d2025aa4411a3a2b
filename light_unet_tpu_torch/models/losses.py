"""Segmentation losses (port of ``light_unet_tpu/models/losses.py``).

* Focal Tversky loss — FN weight ``alpha`` (0.7), FP weight ``beta`` (0.3),
  focal ``gamma`` (0.75);
* combined loss — ``ftl_weight`` * FTL + ``bce_weight`` * BCE;
* Dice loss.

All losses take **probabilities** (the sigmoid is inside the model) and
flatten across the whole batch before reducing: TP/FP/FN are global sums.
Reductions run in float32.

On a data-parallel mesh each rank holds some rows of the batch, and the
mean of per-rank losses is not the loss (FTL and Dice are ratios of sums
over the whole batch).  The training loss (``get_loss_function``) is
therefore formed from the batch sums: with a mesh they are summed over the
ranks first (``parallel/collectives.py:global_sum``, identity backward),
so every rank computes the scalar one process would.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from light_unet_tpu_torch.parallel.collectives import global_sum
from light_unet_tpu_torch.parallel.mesh import mesh_size

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


def _batch_sums(pred, target, with_bce: bool) -> torch.Tensor:
    """The sums a loss is formed from, over the flattened batch: tp, fp,
    fn, sum(pred), sum(target) and, ``with_bce``, the summed BCE terms."""
    p = pred.reshape(-1).float()
    t = target.reshape(-1).float()
    parts = [torch.sum(p * t), torch.sum(p * (1.0 - t)), torch.sum((1.0 - p) * t),
             torch.sum(p), torch.sum(t)]
    if with_bce:
        pc = torch.clamp(p, _BCE_EPS, 1.0 - _BCE_EPS)
        parts.append(-torch.sum(t * torch.log(pc) + (1.0 - t) * torch.log(1.0 - pc)))
    return torch.stack(parts)


def _ftl(tp, fp, fn, alpha, beta, gamma, smooth=1e-6):
    """Focal Tversky loss from the batch's tp, fp and fn."""
    tversky = (tp + smooth) / (tp + alpha * fn + beta * fp + smooth)
    return _focal_pow(1.0 - tversky, gamma)


def focal_tversky_loss(pred, target, alpha=0.7, beta=0.3, gamma=0.75, smooth=1e-6):
    """Focal Tversky loss on probabilities; global flatten over the batch."""
    tp, fp, fn = _batch_sums(pred, target, False)[:3].unbind()
    return _ftl(tp, fp, fn, alpha, beta, gamma, smooth)


def _dice(tp, p_sum, t_sum, smooth=1e-6):
    """1 - soft Dice from the batch's tp, sum(pred) and sum(target)."""
    return 1.0 - (2.0 * tp + smooth) / (p_sum + t_sum + smooth)


def bce_loss(pred, target):
    """Binary cross-entropy on probabilities (torch ``nn.BCELoss`` mean)."""
    return _batch_sums(pred, target, True)[5] / pred.numel()


def combined_loss(pred, target, ftl_weight=0.8, bce_weight=0.2, alpha=0.7, beta=0.3, gamma=0.75):
    """``ftl_weight`` * Focal Tversky + ``bce_weight`` * BCE."""
    tp, fp, fn, _, _, bce = _batch_sums(pred, target, True).unbind()
    return ftl_weight * _ftl(tp, fp, fn, alpha, beta, gamma) + bce_weight * (bce / pred.numel())


def dice_loss(pred, target, smooth=1e-6):
    """1 - soft Dice, global flatten over the batch."""
    tp, _, _, p_sum, t_sum = _batch_sums(pred, target, False).unbind()
    return _dice(tp, p_sum, t_sum, smooth)


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
        return _ftl(tp, fp, fn, alpha, beta, gamma)

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


def get_loss_function(loss_cfg, mesh=None) -> Callable:
    """``fn(pred, target)`` from a ``LossConfig``: the loss of a batch whose
    rows ``mesh``'s ranks hold between them (each passes its rows; without
    a mesh, the whole batch).  The batch sums go over the ranks before the
    loss is formed from them."""
    combined = loss_cfg.use_combined_loss
    if not combined and loss_cfg.name not in ("FocalTverskyLoss", "DiceLoss"):
        raise ValueError(f"Unknown loss function: {loss_cfg.name}")

    def _fn(pred, target):
        sums = global_sum(_batch_sums(pred, target, combined), mesh)
        tp, fp, fn, p_sum, t_sum, *bce = sums.unbind()
        ftl = _ftl(tp, fp, fn, loss_cfg.alpha, loss_cfg.beta, loss_cfg.gamma)
        if combined:
            w = loss_cfg.combined_loss_weights
            n = pred.numel() * mesh_size(mesh)
            return w["focal_tversky"] * ftl + w["bce"] * (bce[0] / n)
        if loss_cfg.name == "FocalTverskyLoss":
            return ftl
        return _dice(tp, p_sum, t_sum)

    return _fn
