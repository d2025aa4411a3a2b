"""Case file resolution (port of ``light_unet_tpu/datasets/index.py:32,99``).

Images are ``images/{case_id}_*.nii[.gz]``, labels ``labels/{case_id}.nii[.gz]``;
split files list one case id per line.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Union


def find_case_files(base_dir: Union[str, Path], case_id: str, file_type: str = "image") -> List[Path]:
    """Resolve image/label files for a case (sorted for determinism)."""
    base_dir = Path(base_dir)
    if file_type == "image":
        subdir = base_dir / "images"
        patterns = [f"{case_id}_*.nii.gz", f"{case_id}_*.nii"]
    elif file_type == "label":
        subdir = base_dir / "labels"
        patterns = [f"{case_id}.nii.gz", f"{case_id}.nii"]
    else:
        raise ValueError(f"Invalid file_type: {file_type}. Must be 'image' or 'label'")
    files: List[Path] = []
    if subdir.exists():
        for pattern in patterns:
            files.extend(subdir.glob(pattern))
    return sorted(files)


def read_split_file(split_file: Union[str, Path]) -> List[str]:
    with open(split_file, "r") as f:
        return [line.strip() for line in f if line.strip()]
