"""Device-resident validation metrics: the threshold sweep on the device
(port of ``light_unet_tpu/ops/val_metrics.py``).

* the ground truth is labeled once per case (host scipy, the reference's
  numbering) and its id map uploaded once as uint8;
* per threshold the device runs threshold -> ``ops.ccl.label_propagate`` ->
  dense ids by seed identity (each component's seed is its voxel whose
  label equals its own flat index + 1; ranks in flat order come from a
  cumulative sum, no sort) -> component sizes, split coordinate sums,
  first flat index (``scatter_reduce_`` "amin") and the (pred, gt) pair
  table (one ``bincount``);
* only ``[T, C+1, 8]`` + ``[T, C+1, G+1]`` tables cross to the host, where
  the greedy one-to-one matcher of ``models/metrics.py`` runs on them.

Everything is integer (int64 on the device), and the decisions are the JAX
package's, so the same cases fall back to the exact host path: more than
``max_components`` components ("components"), a volume outside the int32
envelope of the JAX tables ("envelope"), a component of 2^23 voxels or more
("component_size"), more than ``min(n_gt_cap, 255)`` GT lesions, or a
ledger refusal.  Coordinate sums keep the JAX split into low 7 bits and
high bits, so the tables are the JAX package's tables.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.ops.ccl import label_propagate
from light_unet_tpu_torch.ops.sliding_window import _u16_to_f32
from light_unet_tpu_torch.utils.device import resolve_device

# table columns (per pred component row): sum(coord) == 128 * hi + lo per axis
_COL_SIZE = 0
_COL_ZLO, _COL_ZHI = 1, 2
_COL_YLO, _COL_YHI = 3, 4
_COL_XLO, _COL_XHI = 5, 6
_COL_FIRST = 7
_N_COLS = 8

# per-component size bound of the JAX package's exact int32 split sums
_MAX_EXACT_COMPONENT = 1 << 23
_INT32_MAX = 2**31 - 1


def dequantize_prob(prob: torch.Tensor) -> torch.Tensor:
    """A uint16-quantized map (int16 bits) -> float32 probabilities, as the
    JAX package computes them (float32 level times float32 1/65535)."""
    if prob.dtype == torch.int16:
        return _u16_to_f32(prob) * torch.tensor(np.float32(1.0 / 65535.0), device=prob.device)
    return prob.float()


@torch.no_grad()
def sweep_tables_device(prob: torch.Tensor, gt_ids: torch.Tensor, thresholds: Sequence[float],
                        *, max_components: int = 4096,
                        n_gt_cap: int = 64) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-threshold pred component tables + pair intersections on ``prob``'s device.

    Returns ``(tables [T, C+1, 8], inter [T, C+1, G+1], n_components [T])``
    (int64) with C = ``max_components``, G = ``n_gt_cap``.  Row 0 is
    background; rows are in seed (flat-index) order: sort by column
    ``_COL_FIRST`` on the host for scipy numbering.  ``n_components`` is
    exact, so an overflow (> C) is detectable."""
    prob = dequantize_prob(prob)
    dev = prob.device
    shape = prob.shape
    n = prob.numel()
    n_rows = max_components + 1
    gt_flat = torch.clamp(gt_ids.reshape(-1).long(), max=n_gt_cap)
    seeds = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    flat_idx = seeds - 1
    coords = [torch.arange(s, device=dev) for s in shape]
    coord_flat = [
        coords[0][:, None, None].expand(shape).reshape(-1),
        coords[1][None, :, None].expand(shape).reshape(-1),
        coords[2][None, None, :].expand(shape).reshape(-1),
    ]
    sum_cols = torch.stack([torch.ones(n, dtype=torch.int64, device=dev)]
                           + [part for c in coord_flat for part in (c & 127, c >> 7)], dim=1)
    tables, inters, counts = [], [], []
    for t in thresholds:
        mask = prob >= torch.tensor(np.float32(t), device=dev)
        labels = label_propagate(mask).reshape(-1)
        mask_flat = mask.reshape(-1)
        seed_mask = (labels == seeds) & mask_flat
        # rank of each seed in flat order; components past the cap get id 0
        # (they only pollute row 0, and the count says the case overflowed)
        rank = torch.cumsum(seed_mask, 0)
        rank = torch.where(seed_mask & (rank <= max_components), rank, torch.zeros_like(rank))
        ids = torch.where(mask_flat, rank[torch.clamp(labels - 1, min=0)], torch.zeros_like(rank))
        sums = torch.zeros((n_rows, _N_COLS - 1), dtype=torch.int64, device=dev)
        sums.index_add_(0, ids, sum_cols)
        first = torch.full((n_rows,), _INT32_MAX, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, ids, torch.where(mask_flat, flat_idx, _INT32_MAX), "amin")
        joint = ids * (n_gt_cap + 1) + gt_flat
        inter = torch.bincount(joint, minlength=n_rows * (n_gt_cap + 1))
        tables.append(torch.cat([sums, first[:, None]], dim=1))
        inters.append(inter.reshape(n_rows, n_gt_cap + 1))
        counts.append(seed_mask.sum())
    return torch.stack(tables), torch.stack(inters), torch.stack(counts)


def prepare_gt(label_volume: np.ndarray) -> Dict:
    """Host-side one-time GT prep (scipy numbering): dense labeled map plus
    per-component sizes and centers."""
    from light_unet_tpu_torch.models.metrics import _component_centers, get_connected_components

    target_bin = (np.asarray(label_volume) >= 0.5).astype(np.int32)
    labeled, n_gt = get_connected_components(target_bin)
    sizes = np.bincount(labeled.ravel(), minlength=n_gt + 1).astype(np.int64)
    centers = _component_centers(labeled, n_gt)  # [n_gt, 3] voxel coords
    return {
        "labeled": labeled.astype(np.int32),
        "n_gt": int(n_gt),
        "sizes": sizes,
        "centers": centers,
        "gt_sum": int(target_bin.sum()),
    }


def metrics_from_tables(table: np.ndarray, inter: np.ndarray, n_components: int, gt: Dict,
                        spacing: Sequence[float], iou_threshold: float = 0.1,
                        distance_threshold_mm: float = 10.0) -> Dict:
    """Per-case (one threshold) lesion TP/FP/FN + voxel sums from the device
    tables, with ``models.metrics._match_against``'s greedy matcher."""
    n_gt = gt["n_gt"]
    rows = np.flatnonzero(table[:, _COL_SIZE] > 0)
    rows = rows[rows != 0]  # background row
    rows = rows[np.argsort(table[rows, _COL_FIRST], kind="stable")]
    n_pred = len(rows)

    pred_sum = int(table[rows, _COL_SIZE].sum()) if n_pred else 0
    inter_total = int(inter[rows, 1 : n_gt + 1].sum()) if (n_pred and n_gt) else 0
    out = {"pred_sum": pred_sum, "gt_sum": gt["gt_sum"], "inter_sum": inter_total}
    if n_gt == 0:
        out.update({"tp": 0, "fp": n_pred, "fn": 0})
        return out
    if n_pred == 0:
        out.update({"tp": 0, "fp": 0, "fn": n_gt})
        return out

    pred_sizes = table[rows, _COL_SIZE].astype(np.int64)
    pair_inter = inter[rows, 1 : n_gt + 1].astype(np.int64)  # [n_pred, n_gt]
    union = pred_sizes[:, None] + gt["sizes"][None, 1 : n_gt + 1] - pair_inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(union > 0, pair_inter / np.maximum(union, 1), 0.0)

    sp = np.asarray(spacing, dtype=np.float64)
    # recombine the split coordinate sums exactly and divide in float64:
    # scipy.ndimage.center_of_mass of the same component
    coord_sums = np.stack(
        [
            128.0 * table[rows, hi].astype(np.int64) + table[rows, lo].astype(np.int64)
            for lo, hi in ((_COL_ZLO, _COL_ZHI), (_COL_YLO, _COL_YHI), (_COL_XLO, _COL_XHI))
        ],
        axis=1,
    ).astype(np.float64)
    pc = coord_sums / pred_sizes[:, None].astype(np.float64) * sp
    tc = np.asarray(gt["centers"], dtype=np.float64) * sp
    dist = np.linalg.norm(pc[:, None, :] - tc[None, :, :], axis=2)

    taken = np.zeros(n_gt, dtype=bool)
    tp = 0
    for i in range(n_pred):
        ok = (~taken) & ((iou[i] >= iou_threshold) | (dist[i] <= distance_threshold_mm))
        if not ok.any():
            continue
        best = int(np.argmax(np.where(ok, iou[i], -np.inf)))
        taken[best] = True
        tp += 1
    out.update({"tp": tp, "fp": n_pred - tp, "fn": n_gt - int(taken.sum())})
    return out


class DeviceValidationSweep:
    """Per-epoch validation metrics with device-resident cases.

    ``add_case`` uploads the GT id map once; ``case_metrics`` consumes a map
    on the device (the un-fetched sliding-window output) and returns
    per-threshold count dicts, or None when the case must take the exact
    host path (``last_overflow_reason`` says why)."""

    def __init__(self, thresholds: Sequence[float], max_components: int = 4096,
                 n_gt_cap: int = 64, ledger=None, device="cuda"):
        self.thresholds = [float(t) for t in thresholds]
        self.max_components = int(max_components)
        self.n_gt_cap = int(n_gt_cap)
        self.device = resolve_device(device)
        self._gt: Dict[str, Dict] = {}
        # "components" (a bigger cap would fix it), "envelope" /
        # "component_size" (cap-independent), or None after a success
        self.last_overflow_reason = None
        self.ledger = ledger

    def add_case(self, case_id: str, label_volume: np.ndarray) -> bool:
        """Label the GT once and keep its uint8 id map on the device.  False
        (case not added) when n_gt exceeds the cap or the ledger has no room."""
        gt = prepare_gt(label_volume)
        if gt["n_gt"] > min(self.n_gt_cap, 255):
            return False
        ids_u8 = gt.pop("labeled").astype(np.uint8)
        if self.ledger is not None and not self.ledger.try_charge("val_gt_ids", int(ids_u8.nbytes)):
            return False
        gt["device_ids"] = {}  # padded variants keyed by shape
        gt["base_ids"] = torch.from_numpy(np.ascontiguousarray(ids_u8)).to(self.device)
        self._gt[case_id] = gt
        return True

    def has_case(self, case_id: str) -> bool:
        return case_id in self._gt

    def release_case(self, case_id: str) -> None:
        """Drop a case's device GT (id map + padded variants)."""
        self._gt.pop(case_id, None)

    def gt_ids_padded(self, case_id: str, shape):
        """The case's device GT id map zero-padded to ``shape``; the padded
        variant is cached per shape only while the ledger has room."""
        gt = self._gt[case_id]
        gt_ids = gt["base_ids"]
        shape = tuple(int(s) for s in shape)
        if shape == tuple(gt_ids.shape):
            return gt_ids
        cached = gt["device_ids"].get(shape)
        if cached is None:
            cached = torch.zeros(shape, dtype=gt_ids.dtype, device=gt_ids.device)
            cached[tuple(slice(0, s) for s in gt_ids.shape)] = gt_ids
            if self.ledger is None or self.ledger.try_charge("val_gt_ids_padded", cached.numel()):
                gt["device_ids"][shape] = cached
        return cached

    def case_metrics(self, case_id: str, prob_dev: torch.Tensor, spacing: Sequence[float],
                     iou_threshold: float = 0.1, distance_threshold_mm: float = 10.0):
        """[{tp, fp, fn, pred_sum, gt_sum, inter_sum} per threshold] or None.
        ``prob_dev`` may be bucket-padded (float32, or uint16 levels as int16):
        padding is zero, so it stays background at every threshold > 0."""
        gt = self._gt[case_id]
        gt_ids = self.gt_ids_padded(case_id, prob_dev.shape)
        if prob_dev.numel() >= 2**31 or max(prob_dev.shape) >= 4096:
            self.last_overflow_reason = "envelope"
            return None
        tables, inters, counts = sweep_tables_device(
            prob_dev, gt_ids, self.thresholds,
            max_components=self.max_components, n_gt_cap=self.n_gt_cap)
        counts = counts.cpu().numpy()
        if (counts > self.max_components).any():
            self.last_overflow_reason = "components"
            return None
        tables = tables.cpu().numpy()
        if tables[:, 1:, _COL_SIZE].max(initial=0) >= _MAX_EXACT_COMPONENT:
            self.last_overflow_reason = "component_size"
            return None
        inters = inters.cpu().numpy()
        self.last_overflow_reason = None
        return [
            metrics_from_tables(tables[i], inters[i], int(counts[i]), gt, spacing,
                                iou_threshold, distance_threshold_mm)
            for i in range(len(self.thresholds))
        ]
