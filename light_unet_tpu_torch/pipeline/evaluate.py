"""Stage 5: evaluation of probability maps against labels (port of
``light_unet_tpu/pipeline/evaluate.py``).

Per case and threshold (the sweep = ``threshold_sensitivity_range`` plus the
default): voxel DSC and lesion metrics, TP/FP/FN summed over cases per
threshold, a console table with the best-recall / best-F1 thresholds,
``metrics.csv`` and ``detailed_results.json``.

The sweep runs on ``device`` through one split-scoped
``DeviceValidationSweep`` (on a card one CUDA graph replay a case per
padded shape); a case takes the exact host path only where the
JAX package's sweep returns None too (component count, envelope, component
size, GT cap, ledger).  An error of the device path is raised, not hidden.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.datasets.index import find_case_files, read_split_file
from light_unet_tpu_torch.models.metrics import SMOOTH, calculate_dsc, lesion_metrics_sweep
from light_unet_tpu_torch.ops.intensity import pad_volume
from light_unet_tpu_torch.utils import nifti
from light_unet_tpu_torch.utils.device import resolve_device

CSV_COLUMNS = ("recall", "precision", "f1", "dsc", "fp_per_case", "tp", "fp", "fn", "num_cases")


def _device_case_results(prob_map, label, thresholds, spacing, sweep,
                         z_bucket: int = 1) -> Optional[Dict]:
    """The threshold sweep of one case on ``sweep``'s device: the map goes up
    once as float32 (exact thresholding for maps of any origin), its last
    axis zero-padded to a ``z_bucket`` multiple when every threshold is
    positive (padding is background then), so that cases of one bucket share
    the sweep's graph.  None when the case must take the host path.  The
    case's GT leaves the device after scoring, so a split's residency stays
    one case."""
    if not sweep.add_case("case", label):
        return None
    try:
        prob_map = np.asarray(prob_map, dtype=np.float32)
        if z_bucket > 1 and min(thresholds) > 0:
            prob_map = pad_volume(prob_map, z_bucket)
        prob = torch.from_numpy(np.ascontiguousarray(prob_map)).to(sweep.device)
        res = sweep.case_metrics("case", prob, spacing)
    finally:
        sweep.release_case("case")
        if sweep.ledger is not None:
            sweep.ledger.release("val_gt_ids")
            sweep.ledger.release("val_gt_ids_padded")
    if res is None:
        return None
    results = {}
    for threshold, r in zip(thresholds, res):
        tp, fp, fn = r["tp"], r["fp"], r["fn"]
        if tp + fp + fn == 0:  # no GT and no predictions: vacuous success
            recall = precision = f1 = 1.0
        else:
            recall = tp / (tp + fn) if tp + fn else 0.0
            precision = tp / (tp + fp) if tp + fp else 0.0
            f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        results[threshold] = {
            "dsc": (2.0 * r["inter_sum"] + SMOOTH) / (r["pred_sum"] + r["gt_sum"] + SMOOTH),
            "recall": recall, "precision": precision, "f1": f1,
            "tp": tp, "fp": fp, "fn": fn,
        }
    return results


def evaluate_case(case_id: str, prob_maps_dir, data_dir, thresholds, spacing=(4.0, 4.0, 4.0),
                  use_device: bool = True, sweep=None, device="cuda",
                  z_bucket: int = 1) -> Optional[Dict]:
    """Per-threshold metrics of one case, or None when its map or label is missing."""
    prob_path = Path(prob_maps_dir) / f"{case_id}_prob.nii.gz"
    if not prob_path.exists():
        return None
    prob_map = nifti.load(prob_path).get_fdata()
    label_files = find_case_files(Path(data_dir), case_id, "label")
    if not label_files:
        return None
    label = nifti.load(label_files[0]).get_fdata()

    if use_device:
        if sweep is None:  # standalone single-case use
            from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep

            sweep = DeviceValidationSweep(thresholds, device=device)
        results = _device_case_results(prob_map, label, thresholds, spacing, sweep, z_bucket)
        if results is not None:
            return results

    results = {}
    # ground truth labeled/centered once for the whole threshold sweep
    lm_sweep = lesion_metrics_sweep(
        prob_map, label, thresholds,
        min_size_voxels=0, iou_threshold=0.1, distance_threshold_mm=10.0, spacing=spacing,
    )
    for threshold in thresholds:
        pred_binary = (prob_map >= threshold).astype(np.float32)
        lm = lm_sweep[threshold]
        results[threshold] = {
            "dsc": calculate_dsc(pred_binary, label),
            "recall": lm["recall"], "precision": lm["precision"], "f1": lm["f1"],
            "tp": lm["tp"], "fp": lm["fp"], "fn": lm["fn"],
        }
    return results


def evaluate_split(split_file, prob_maps_dir, data_dir, config: Config,
                   device="cuda") -> Tuple[Dict, Dict]:
    """(summary per threshold, per-case results) over a split file."""
    case_ids = read_split_file(split_file)
    thresholds = list(config.validation.threshold_sensitivity_range)
    default_threshold = config.validation.default_threshold
    if default_threshold not in thresholds:
        thresholds = sorted(thresholds + [default_threshold])

    print(f"Evaluating {len(case_ids)} cases at {len(thresholds)} thresholds...")
    t0 = time.time()
    spacing = tuple(config.data.spacing.target)
    use_device = bool(getattr(config.tpu, "device_val_metrics", True))
    sweep = None
    if use_device:  # one engine and one ledger for the whole split
        from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
        from light_unet_tpu_torch.utils.hbm_ledger import HbmLedger

        device = resolve_device(device)
        sweep = DeviceValidationSweep(thresholds, ledger=HbmLedger(device=device), device=device)
    all_results = {}
    for cid in case_ids:
        res = evaluate_case(cid, prob_maps_dir, data_dir, thresholds, spacing=spacing,
                            use_device=use_device, sweep=sweep, z_bucket=config.tpu.z_bucket)
        if res is not None:
            all_results[cid] = res

    summary = {}
    for threshold in thresholds:
        tp = fp = fn = 0
        dscs = []
        for res in all_results.values():
            if threshold in res:
                tp += res[threshold]["tp"]
                fp += res[threshold]["fp"]
                fn += res[threshold]["fn"]
                dscs.append(res[threshold]["dsc"])
        recall = tp / (tp + fn) if tp + fn else 0.0
        precision = tp / (tp + fp) if tp + fp else 0.0
        f1 = 2 * precision * recall / (precision + recall) if precision + recall else 0.0
        summary[threshold] = {
            "recall": recall,
            "precision": precision,
            "f1": f1,
            "dsc": float(np.mean(dscs)) if dscs else 0.0,
            "fp_per_case": fp / len(all_results) if all_results else 0.0,
            "tp": tp,
            "fp": fp,
            "fn": fn,
            "num_cases": len(all_results),
        }
    print(f"Evaluation took {time.time() - t0:.1f}s")
    return summary, all_results


def print_summary(summary: Dict, default_threshold: float) -> None:
    print("\n" + "=" * 80)
    print("EVALUATION SUMMARY")
    print("=" * 80)
    thresholds = sorted(summary.keys())
    print(f"\n{'Threshold':>10} {'Recall':>10} {'Precision':>10} {'F1':>10} {'DSC':>10} {'FP/case':>10}")
    print("-" * 70)
    for t in thresholds:
        m = summary[t]
        marker = " *" if t == default_threshold else ""
        print(
            f"{t:>10.2f} {m['recall']:>10.4f} {m['precision']:>10.4f} "
            f"{m['f1']:>10.4f} {m['dsc']:>10.4f} {m['fp_per_case']:>10.2f}{marker}"
        )
    print("\n* = default threshold")
    best_recall_t = max(thresholds, key=lambda t: summary[t]["recall"])
    best_f1_t = max(thresholds, key=lambda t: summary[t]["f1"])
    print(f"\nBest Recall: {summary[best_recall_t]['recall']:.4f} at threshold {best_recall_t:.2f}")
    print(f"Best F1: {summary[best_f1_t]['f1']:.4f} at threshold {best_f1_t:.2f}")
    d = summary[default_threshold]
    print(f"\nMetrics at default threshold ({default_threshold:.2f}):")
    print(f"  Lesion-wise Recall: {d['recall']:.4f}")
    print(f"  Lesion-wise Precision: {d['precision']:.4f}")
    print(f"  Voxel-wise DSC: {d['dsc']:.4f}")
    print(f"  FP per case: {d['fp_per_case']:.2f}")


def metrics_csv(summary: Dict) -> str:
    """The summary as CSV, one row per threshold: what pandas writes for
    ``DataFrame(summary).T`` (every column float64, so counts read ``3.0``)."""
    lines = [",".join(("threshold",) + CSV_COLUMNS)]
    for t, m in summary.items():
        lines.append(",".join([repr(float(t))] + [repr(float(m[k])) for k in CSV_COLUMNS]))
    return "\n".join(lines) + "\n"


def save_results(summary: Dict, per_case_results: Dict, output_dir) -> None:
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    csv_path = output_dir / "metrics.csv"
    csv_path.write_text(metrics_csv(summary))
    print(f"\nSummary saved to {csv_path}")
    json_path = output_dir / "detailed_results.json"
    with open(json_path, "w") as f:
        json.dump({"summary": summary, "per_case": per_case_results}, f, indent=2)
    print(f"Detailed results saved to {json_path}")


def run_evaluate(config: Config, split_file, prob_maps_dir, data_dir, output_dir,
                 device="cuda") -> Dict:
    summary, per_case = evaluate_split(split_file, prob_maps_dir, data_dir, config, device=device)
    print_summary(summary, config.validation.default_threshold)
    save_results(summary, per_case, output_dir)
    return summary
