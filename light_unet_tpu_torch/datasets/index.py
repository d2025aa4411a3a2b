"""Case discovery, file resolution and domain filtering (port of
``light_unet_tpu/datasets/index.py``, the package's own copy).

* images ``{case_id}_*.nii[.gz]`` under ``images/``, labels
  ``{case_id}.nii[.gz]`` under ``labels/``;
* optional ``body_masks/{case_id}.nii.gz`` and ``metadata/{case_id}.json``;
* domain by 4-digit case-id prefix: FL <= 122, DLBCL 1000-1422; non-numeric
  ids pass through with a warning.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

DEFAULT_FL_PREFIX_MAX = 122
DEFAULT_DLBCL_PREFIX_MIN = 1000
DEFAULT_DLBCL_PREFIX_MAX = 1422

DEFAULT_FL_DOMAIN_CONFIG = {
    "domain": "fl",
    "fl_prefix_max": DEFAULT_FL_PREFIX_MAX,
    "dlbcl_prefix_min": DEFAULT_DLBCL_PREFIX_MIN,
    "dlbcl_prefix_max": DEFAULT_DLBCL_PREFIX_MAX,
}


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


def filter_cases_by_domain(case_ids: Sequence[str], domain_config: Optional[dict]) -> List[str]:
    """Keep case ids belonging to the configured domain (by numeric prefix)."""
    if domain_config is None or domain_config.get("domain") is None:
        return list(case_ids)
    domain = str(domain_config.get("domain", "")).lower()
    fl_max = domain_config.get("fl_prefix_max", DEFAULT_FL_PREFIX_MAX)
    dl_min = domain_config.get("dlbcl_prefix_min", DEFAULT_DLBCL_PREFIX_MIN)
    dl_max = domain_config.get("dlbcl_prefix_max", DEFAULT_DLBCL_PREFIX_MAX)

    kept: List[str] = []
    for cid in case_ids:
        try:
            prefix = int(cid[:4])
        except (ValueError, IndexError):
            warnings.warn(f"Case ID {cid} doesn't match expected format, skipping filter")
            kept.append(cid)
            continue
        if domain == "fl":
            if prefix <= fl_max:
                kept.append(cid)
        elif domain == "dlbcl":
            if dl_min <= prefix <= dl_max:
                kept.append(cid)
        else:
            kept.append(cid)
    return kept


def missing_body_mask_error(missing: int, total: int, missing_cases: Sequence[str], context: str = "") -> FileNotFoundError:
    """Standardized missing-body-mask error (datasets/utils.py:36-45)."""
    shown = ", ".join(f"'{c}'" for c in missing_cases[:5])
    if len(missing_cases) > 5:
        shown += "..."
    ctx = f" for {context}" if context else ""
    return FileNotFoundError(
        f"Body mask is required{ctx} but missing for {missing}/{total} cases: [{shown}]. "
        f"Please ensure body masks are generated for all cases or disable body mask enforcement."
    )


@dataclass
class CaseRecord:
    case_id: str
    image_path: str
    label_path: str
    metadata_path: Optional[str] = None
    body_mask_path: Optional[str] = None


def read_split_file(split_file: Union[str, Path]) -> List[str]:
    with open(split_file, "r") as f:
        return [line.strip() for line in f if line.strip()]


def build_case_index(
    data_dir: Union[str, Path],
    split_file: Union[str, Path],
    domain_config: Optional[dict] = None,
    warn_missing: bool = True,
) -> List[CaseRecord]:
    """Resolve all files for the cases of a split (skips incomplete cases)."""
    data_dir = Path(data_dir)
    case_ids = filter_cases_by_domain(read_split_file(split_file), domain_config)
    records: List[CaseRecord] = []
    for cid in case_ids:
        images = find_case_files(data_dir, cid, "image")
        labels = find_case_files(data_dir, cid, "label")
        if not images or not labels:
            if warn_missing:
                warnings.warn(f"Case {cid} missing files, skipping.", UserWarning)
            continue
        meta = data_dir / "metadata" / f"{cid}.json"
        mask = data_dir / "body_masks" / f"{cid}.nii.gz"
        records.append(
            CaseRecord(
                case_id=cid,
                image_path=str(images[0]),
                label_path=str(labels[0]),
                metadata_path=str(meta) if meta.exists() else None,
                body_mask_path=str(mask) if mask.exists() else None,
            )
        )
    return records


def check_body_masks(records: List[CaseRecord], required: bool, context: str) -> None:
    if not required:
        return
    missing = [r.case_id for r in records if r.body_mask_path is None]
    if missing:
        raise missing_body_mask_error(len(missing), len(records), missing, context)
