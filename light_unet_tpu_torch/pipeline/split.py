"""Stage 1: dataset splitting (port of ``light_unet_tpu/pipeline/split.py``,
host only).

Parity with ``scripts/split_dataset.py:15-154``: case ids discovered from
label files with image-existence verification, placeholder 123-case list
when the raw tree is empty, seeded shuffle, 70/15/15 split with sorted
lists, ``{train,val,test}_list.txt`` plus ``split_manifest.json`` (with the
same notes about the black-box test set / Path B / pre-calculated SUV).
"""

from __future__ import annotations

import json
import random
from datetime import datetime
from pathlib import Path
from typing import Dict


def split_dataset(
    data_root,
    output_dir,
    train_ratio: float = 0.70,
    val_ratio: float = 0.15,
    test_ratio: float = 0.15,
    seed: int = 42,
) -> Dict:
    random.seed(seed)
    if not abs(train_ratio + val_ratio + test_ratio - 1.0) < 1e-6:
        raise ValueError(
            f"Split ratios must sum to 1.0, got {train_ratio + val_ratio + test_ratio}")

    data_root = Path(data_root)
    labels_dir = data_root / "labels"
    case_ids = set()
    if labels_dir.exists():
        for pattern in ("*.nii.gz", "*.nii"):
            for label_file in labels_dir.glob(pattern):
                name = label_file.name
                if name.endswith(".nii.gz"):
                    case_ids.add(name[:-7])
                elif name.endswith(".nii"):
                    case_ids.add(name[:-4])

    images_dir = data_root / "images"
    valid_cases = []
    if images_dir.exists() and case_ids:
        for cid in sorted(case_ids):
            found = []
            for pattern in (f"{cid}_*.nii.gz", f"{cid}_*.nii"):
                found.extend(images_dir.glob(pattern))
            if found:
                valid_cases.append(cid)

    if not valid_cases:
        print(f"Warning: No valid cases found in {data_root}")
        print("Creating placeholder case list for 123 FL cases...")
        valid_cases = [f"{i:04d}" for i in range(1, 124)]

    total = len(valid_cases)
    print(f"Total cases found: {total}")
    random.shuffle(valid_cases)
    n_train = int(total * train_ratio)
    n_val = int(total * val_ratio)
    train_cases = sorted(valid_cases[:n_train])
    val_cases = sorted(valid_cases[n_train : n_train + n_val])
    test_cases = sorted(valid_cases[n_train + n_val :])

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for name, cases in (("train", train_cases), ("val", val_cases), ("test", test_cases)):
        with open(output_dir / f"{name}_list.txt", "w") as f:
            f.write("\n".join(cases) + "\n")

    manifest = {
        "dataset": "Follicular_Lymphoma",
        "total_cases": total,
        "split_date": datetime.now().isoformat(),
        "seed": seed,
        "split_ratios": {"train": train_ratio, "val": val_ratio, "test": test_ratio},
        "split_sizes": {"train": len(train_cases), "val": len(val_cases), "test": len(test_cases)},
        "splits": {"train": train_cases, "val": val_cases, "test": test_cases},
        "processing_path": "B",
        "spacing": [4.0, 4.0, 4.0],
        "notes": [
            "Test set is black-box and should not be used for training or validation",
            "All cases preserve original 4×4×4mm spacing (Path B)",
            "SUV values are pre-calculated and should not be recomputed",
        ],
    }
    manifest_path = output_dir.parent / "split_manifest.json"
    with open(manifest_path, "w") as f:
        json.dump(manifest, f, indent=2)
    print(
        f"Split: train {len(train_cases)}, val {len(val_cases)}, test {len(test_cases)}"
        f" -> {output_dir}"
    )
    return manifest
