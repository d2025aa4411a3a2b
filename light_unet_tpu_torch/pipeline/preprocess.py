"""Stage 2: preprocessing, Path B (port of
``light_unet_tpu/pipeline/preprocess.py``).

Parity with ``scripts/preprocess_data.py`` of the reference:

* spacing *verification* against the 4 mm target: warn, never resample
  (``:239-241``);
* percentile clip + min-max normalization to [0, 1] (``:21-59``), on the
  device;
* body-mask generation with staged voxel counts and bbox metadata
  (``:91-174``), on the device in the same pass (``ops/fused.py``);
* the voxel-threshold table for the train/inference cc thresholds
  (``:62-88``);
* processed images saved float32, labels copied verbatim, per-case metadata
  JSON, and a summary JSON (``:271-308, 421-427``).

Decode uses the port's NIfTI codec; ``device`` (default ``"cuda"``) is where
the normalize and body-mask pass runs.  ``preprocess_dataset`` owns one
``utils/graphs.GraphRunner`` for its cases on a card, so that the pass is
one graph replay a volume per bucketed shape after the first; a case
preprocessed alone runs it eagerly.
"""

from __future__ import annotations

import json
import time
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.datasets.index import read_split_file
from light_unet_tpu_torch.ops.fused import normalize_and_body_mask
from light_unet_tpu_torch.ops.intensity import clip_and_normalize
from light_unet_tpu_torch.utils import fastio, nifti
from light_unet_tpu_torch.utils.device import resolve_device
from light_unet_tpu_torch.utils.graphs import runner_for


def calculate_voxel_thresholds(spacing, volume_cc_list) -> Dict:
    """cc -> voxel-count table (``preprocess_data.py:62-88``)."""
    voxel_volume_cc = (spacing[0] * spacing[1] * spacing[2]) / 1000.0
    out = {}
    for cc in volume_cc_list:
        out[f"{cc}cc"] = {
            "volume_cc": cc,
            "voxel_count": int(np.ceil(cc / voxel_volume_cc)),
            "formula": f"ceil({cc}cc / {voxel_volume_cc:.6f}cc/voxel)",
        }
    return out


def preprocess_case(case_id: str, raw_dir, processed_dir, config: Config,
                    device="cuda", runner=None) -> Tuple[bool, Optional[Dict]]:
    raw_dir = Path(raw_dir)
    images_dir = raw_dir / "images"
    labels_dir = raw_dir / "labels"

    image_files, label_files = [], []
    if images_dir.exists():
        for pattern in (f"{case_id}_*.nii.gz", f"{case_id}_*.nii"):
            image_files.extend(images_dir.glob(pattern))
    if labels_dir.exists():
        for pattern in (f"{case_id}.nii.gz", f"{case_id}.nii"):
            label_files.extend(labels_dir.glob(pattern))
    if not image_files or not label_files:
        print(
            f"Warning: Case {case_id} missing files "
            f"(images: {len(image_files)}, labels: {len(label_files)}), skipping..."
        )
        return False, None

    processed_dir = Path(processed_dir)
    dirs = {
        name: processed_dir / name for name in ("images", "labels", "metadata", "body_masks")
    }
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)

    data_cfg = config.data
    z_bucket = config.tpu.z_bucket
    metadata_list = []
    for img_file in sorted(image_files):
        img_data, header = fastio.load_f32(img_file)
        affine = header.affine()
        spacing = [float(s) for s in header.get_zooms()[:3]]

        expected = data_cfg.spacing.target
        if not np.allclose(spacing, expected, atol=0.1):
            print(f"Warning: Case {case_id} has spacing {spacing}, expected {expected}")

        body_mask_meta = None
        if data_cfg.body_mask.enabled:
            normalized, body_mask, intensity_meta, body_mask_meta = normalize_and_body_mask(
                img_data, data_cfg.intensity, data_cfg.body_mask, z_bucket=z_bucket,
                device=device, runner=runner)
            nifti.save(
                nifti.Nifti1Image(body_mask.astype(np.uint8), affine, header),
                dirs["body_masks"] / f"{case_id}.nii.gz",
            )
        else:
            normalized, intensity_meta = clip_and_normalize(
                img_data,
                low_percentile=data_cfg.intensity.clip_percentile_low,
                high_percentile=data_cfg.intensity.clip_percentile_high,
                target_range=tuple(data_cfg.intensity.normalization_range),
                z_bucket=z_bucket,
                device=device,
            )

        voxel_thresholds = calculate_voxel_thresholds(
            spacing, [data_cfg.volume_threshold.train_cc, data_cfg.volume_threshold.inference_cc]
        )

        nifti.save(
            nifti.Nifti1Image(normalized.astype(np.float32), affine, header),
            dirs["images"] / img_file.name,
        )

        case_meta = {
            "case_id": case_id,
            "orig_spacing": spacing,
            "image_size": list(img_data.shape),
            "suv_calculated": True,
            "clip_values": intensity_meta["clip_values"],
            "normalization_range": intensity_meta["normalization_range"],
            "patch_size": list(data_cfg.patch_size),
            "voxel_thresholds": voxel_thresholds,
            "processing_timestamp": datetime.now().isoformat(),
            "processing_path": "B",
            "seed": config.experiment.seed,
            "bbox_expansion_mm": data_cfg.bbox_expansion_mm,
            "bbox_expansion_voxels": data_cfg.bbox_expansion_voxels,
        }
        if body_mask_meta is not None:
            case_meta["body_mask"] = body_mask_meta
        metadata_list.append(case_meta)

    for label_file in sorted(label_files):
        nifti.save(nifti.load(label_file), dirs["labels"] / label_file.name)

    if metadata_list:
        meta = metadata_list[0] if len(metadata_list) == 1 else metadata_list
        with open(dirs["metadata"] / f"{case_id}.json", "w") as f:
            json.dump(meta, f, indent=2)
        return True, meta
    return False, None


def preprocess_dataset(split_file, raw_dir, processed_dir, config: Config,
                       device="cuda") -> Dict:
    case_ids = read_split_file(split_file)
    print(f"Processing {len(case_ids)} cases from {split_file}")
    t0 = time.time()
    successful, failed, all_meta = 0, [], []
    runner = runner_for(resolve_device(device), True, "preprocess")
    for cid in case_ids:
        ok, meta = preprocess_case(cid, raw_dir, processed_dir, config, device=device,
                                   runner=runner)
        if ok:
            successful += 1
            all_meta.append(meta)
        else:
            failed.append(cid)
    dt = time.time() - t0
    print(f"Preprocessing: {successful}/{len(case_ids)} ok in {dt:.1f}s")
    return {
        "total": len(case_ids),
        "successful": successful,
        "failed": len(failed),
        "failed_cases": failed,
        "metadata": all_meta,
        "seconds": dt,
    }


def run_preprocess(config: Config, raw_dir, processed_dir, splits_dir, split: str = "all",
                   allow_test: bool = False, device="cuda") -> Dict:
    """Preprocess the requested split(s); 'all' means train + val (the test
    set is black-box, ``preprocess_data.py:394-403``, gated by
    ``allow_test`` instead of an interactive prompt)."""
    if split == "all":
        splits = ["train", "val"]
    else:
        if split == "test" and not allow_test:
            raise PermissionError(
                "Test set is black box and should not be processed at this stage "
                "(pass allow_test=True / --allow_test to override)"
            )
        splits = [split]

    summaries = {}
    for name in splits:
        split_file = Path(splits_dir) / f"{name}_list.txt"
        if not split_file.exists():
            print(f"Warning: Split file {split_file} not found, skipping...")
            continue
        summaries[name] = preprocess_dataset(split_file, raw_dir, processed_dir, config,
                                             device=device)

    summary_path = Path(processed_dir) / "preprocessing_summary.json"
    with open(summary_path, "w") as f:
        json.dump(
            {
                "config": {
                    "spacing": {"target": config.data.spacing.target},
                    "intensity": {
                        "clip_percentile_low": config.data.intensity.clip_percentile_low,
                        "clip_percentile_high": config.data.intensity.clip_percentile_high,
                        "normalization_range": config.data.intensity.normalization_range,
                    },
                    "body_mask": {"enabled": config.data.body_mask.enabled},
                    "seed": config.experiment.seed,
                },
                "summaries": summaries,
                "timestamp": datetime.now().isoformat(),
            },
            f,
            indent=2,
        )
    print(f"Preprocessing summary saved to {summary_path}")
    return summaries
