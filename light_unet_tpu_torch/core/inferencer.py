"""Inference engine: checkpoint load, sliding window, bbox extraction (port
of ``light_unet_tpu/core/inferencer.py``).

Per case: NIfTI load + header spacing, optional body-mask multiply, the
sliding-window probability map saved as ``{case_id}_prob.nii.gz`` with the
original header, and candidate extraction (threshold -> connected
components filtered at ``min_volume_cc`` -> voxel + mm bboxes expanded by
``bbox_expansion_voxels``, volume_cc, confidence = max prob) written to
``{case_id}_bboxes.json``.  Per-case failures are collected, not fatal.

The model runs on ``device`` (``"cuda"`` by default; raises when CUDA is
absent and the CPU was not asked for).  ``tpu.fused_block`` sends every
residual block through the fused block kernel; ``tpu.use_pallas`` sends
every InstanceNorm through the fused norm kernel.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.checkpoint import load_checkpoint
from light_unet_tpu_torch.datasets.index import find_case_files, read_split_file
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.metrics import get_connected_components
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.ops.components import bboxes_from_table, component_table_device
from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer, _u16_to_f32, on_device
from light_unet_tpu_torch.utils import nifti
from light_unet_tpu_torch.utils.device import resolve_device

MAX_DEVICE_COMPONENTS = 64  # device candidate-table cap; host fallback beyond

COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def extract_bboxes(
    prob_map: np.ndarray,
    threshold: float = 0.3,
    min_volume_cc: float = 0.5,
    spacing: Sequence[float] = (4.0, 4.0, 4.0),
    expansion_voxels: int = 3,
) -> List[Dict]:
    """Lesion-candidate bounding boxes from a probability map (host path)."""
    binary = (prob_map >= threshold).astype(np.int32)
    voxel_volume_cc = (spacing[0] * spacing[1] * spacing[2]) / 1000.0
    min_voxels = int(np.ceil(min_volume_cc / voxel_volume_cc))
    labeled, n = get_connected_components(binary, min_size=min_voxels)

    bboxes: List[Dict] = []
    for cid in range(1, n + 1):
        component = labeled == cid
        coords = np.argwhere(component)
        if len(coords) == 0:
            continue
        mins = coords.min(axis=0)
        maxs = coords.max(axis=0)
        lo = np.maximum(0, mins - expansion_voxels)
        hi = np.minimum(np.array(prob_map.shape) - 1, maxs + expansion_voxels)
        bboxes.append(
            {
                "mask_id": int(cid),
                "bbox_voxel": [int(lo[0]), int(hi[0]), int(lo[1]), int(hi[1]), int(lo[2]), int(hi[2])],
                "bbox_mm": [
                    float(lo[0] * spacing[0]),
                    float(hi[0] * spacing[0]),
                    float(lo[1] * spacing[1]),
                    float(hi[1] * spacing[1]),
                    float(lo[2] * spacing[2]),
                    float(hi[2] * spacing[2]),
                ],
                "volume_cc": float(component.sum() * voxel_volume_cc),
                "confidence": float(prob_map[component].max()),
            }
        )
    return bboxes


class Inferencer:
    """Generate probability maps + candidate bboxes for cases of a split."""

    def __init__(self, config_or_path, model_path, workdir: Optional[str] = None,
                 save_prob_maps: bool = True, device="cuda"):
        self.save_prob_maps = save_prob_maps
        self.device = resolve_device(device)
        if isinstance(config_or_path, Config):
            self.config = config_or_path
        elif isinstance(config_or_path, dict):
            self.config = Config.from_dict(config_or_path)
        else:
            self.config = Config.load(config_or_path)
        cfg = self.config
        self.workdir = Path(workdir) if workdir else Path(".")

        self.model = build_model(cfg.model, COMPUTE_DTYPES[cfg.tpu.compute_dtype], inference=True,
                                 use_pallas=cfg.tpu.use_pallas)
        state, meta = load_checkpoint(model_path)
        self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        print(f"Loaded model from {model_path}")
        print(f"Best epoch: {meta.get('best_epoch', 'N/A')}")
        if isinstance(meta.get("best_metric"), (int, float)):
            print(f"Best metric: {meta['best_metric']:.4f}")

        apply_fn = make_fused_apply(self.model) if cfg.tpu.fused_block else self.model
        self.sw = SlidingWindowInferencer(
            apply_fn,
            patch_size=tuple(cfg.data.patch_size),
            overlap=0.5,
            patch_batch=cfg.tpu.patch_batch,
            z_bucket=cfg.tpu.z_bucket,
            transfer_dtype=cfg.tpu.transfer_dtype,
            fetch_dtype=cfg.tpu.fetch_dtype,
            # block-sparse fetch only pays off when the map is fetched at all
            sparse_fetch=bool(cfg.tpu.sparse_fetch) and self.save_prob_maps,
            sparse_fetch_frac=cfg.tpu.sparse_fetch_frac,
            mesh_shape=cfg.tpu.mesh_shape,
            spatial_shard=bool(cfg.tpu.spatial_shard),
            # the copy back starts at dispatch only when the map is saved
            host_prefetch=self.save_prob_maps,
            device=self.device,
        )

        self.prob_maps_dir = Path(self._resolve(cfg.output.prob_maps_dir))
        self.bboxes_dir = Path(self._resolve(cfg.output.bboxes_dir))
        self.prob_maps_dir.mkdir(parents=True, exist_ok=True)
        self.bboxes_dir.mkdir(parents=True, exist_ok=True)

    def _resolve(self, p) -> str:
        p = Path(p)
        return str(p if p.is_absolute() else self.workdir / p)

    def _load_case_inputs(self, case_id: str, data_dir: Path):
        """Decode + prepare one case (runs on a worker thread)."""
        image_files = find_case_files(data_dir, case_id, "image")
        if not image_files:
            print(f"Warning: No image files found for {case_id}")
            return None
        img = nifti.load(image_files[0])
        header = img.header
        spacing = [float(s) for s in header.get_zooms()[:3]]

        bm = self.config.data.body_mask
        body_mask = None
        if bm.apply_to_inference and bm.enabled:
            mask_path = data_dir / "body_masks" / f"{case_id}.nii.gz"
            if mask_path.exists():
                body_mask = (nifti.load(mask_path).get_fdata(np.float32) > 0.5).astype(np.float32)
            else:
                print(f"Warning: Body mask not found for {case_id}")
        prepared = self.sw.prepare(img.get_fdata(np.float32), post_mask=body_mask)
        return {"prepared": prepared, "header": header, "spacing": spacing}

    @torch.no_grad()
    def _finalize_case(self, case_id: str, inputs, dispatched, threshold: float) -> bool:
        """Candidate table on the device; fetch + save the map unless
        ``save_prob_maps=False``; write the bboxes JSON."""
        cfg = self.config
        prob_dev, vol_shape = dispatched
        prob_dev = on_device(prob_dev)  # the dense map stays on the device
        if prob_dev.dtype == torch.int16:  # uint16 levels -> probabilities
            prob_dev = _u16_to_f32(prob_dev) * (1.0 / 65535.0)
        table, n_comp = component_table_device(prob_dev, threshold,
                                               max_components=MAX_DEVICE_COMPONENTS)

        prob_map = None
        if self.save_prob_maps:
            prob_map = self.sw.fetch(dispatched)
            header = inputs["header"]
            nifti.save(
                nifti.Nifti1Image(prob_map.astype(np.float32), header.affine(), header),
                self.prob_maps_dir / f"{case_id}_prob.nii.gz",
            )

        bboxes = bboxes_from_table(
            table.cpu().numpy(),
            int(n_comp),
            vol_shape,
            min_volume_cc=cfg.data.volume_threshold.inference_cc,
            spacing=inputs["spacing"],
            expansion_voxels=cfg.data.bbox_expansion_voxels,
            max_components=MAX_DEVICE_COMPONENTS,
        )
        if bboxes is None:  # > MAX_DEVICE_COMPONENTS candidates: host fallback
            if prob_map is None:
                prob_map = self.sw.fetch(dispatched)
            bboxes = extract_bboxes(
                prob_map,
                threshold=threshold,
                min_volume_cc=cfg.data.volume_threshold.inference_cc,
                spacing=inputs["spacing"],
                expansion_voxels=cfg.data.bbox_expansion_voxels,
            )
        bbox_json = {
            "case_id": case_id,
            "processing_path": "B",
            "orig_spacing": inputs["spacing"],
            "threshold": threshold,
            "num_candidates": len(bboxes),
            "candidates": bboxes,
        }
        with open(self.bboxes_dir / f"{case_id}_bboxes.json", "w") as f:
            json.dump(bbox_json, f, indent=2)
        return True

    def infer_case(self, case_id: str, data_dir, threshold: float = 0.3) -> bool:
        data_dir = Path(data_dir)
        try:
            inputs = self._load_case_inputs(case_id, data_dir)
            if inputs is None:
                return False
            dispatched = self.sw.dispatch(inputs["prepared"])
            return self._finalize_case(case_id, inputs, dispatched, threshold)
        except Exception as e:  # noqa: BLE001 - per-case isolation like the reference
            print(f"Error during inference execution for {case_id}: {e}")
            return False

    def infer_split(self, split_file, data_dir) -> Dict:
        """Pipelined split inference: a worker thread decodes case i+1 while
        the device computes case i and the host post-processes case i-1."""
        from concurrent.futures import ThreadPoolExecutor

        case_ids = read_split_file(split_file)
        data_dir = Path(data_dir)
        threshold = self.config.validation.default_threshold
        print(f"Performing inference on {len(case_ids)} cases...")
        t0 = time.time()
        successful, failed = 0, []

        def safe_load(cid):
            # decode failures stay per-case: an exception raised inside
            # pool.map would abort the whole split
            try:
                return self._load_case_inputs(cid, data_dir)
            except Exception as e:  # noqa: BLE001 - per-case isolation
                print(f"Error loading inputs for {cid}: {e}")
                return None

        def finalize(case_id, inputs, dispatched):
            nonlocal successful
            try:
                if self._finalize_case(case_id, inputs, dispatched, threshold):
                    successful += 1
            except Exception as e:  # noqa: BLE001 - per-case isolation
                print(f"Error finalizing {case_id}: {e}")
                failed.append(case_id)

        pending = None  # (case_id, inputs, dispatched)
        with ThreadPoolExecutor(max_workers=2) as pool:
            decoded = pool.map(safe_load, case_ids)
            for case_id, inputs in zip(case_ids, decoded):
                if inputs is None:
                    failed.append(case_id)
                    continue
                try:
                    dispatched = self.sw.dispatch(inputs["prepared"])
                except Exception as e:  # noqa: BLE001 - per-case isolation
                    print(f"Error during inference execution for {case_id}: {e}")
                    failed.append(case_id)
                    continue
                if pending is not None:
                    finalize(*pending)
                pending = (case_id, inputs, dispatched)
            if pending is not None:
                finalize(*pending)

        dt = time.time() - t0
        if dt > 0:
            print(
                f"\nInference complete: {successful}/{len(case_ids)} cases in {dt:.1f}s "
                f"({successful / dt:.2f} volumes/sec)"
            )
        return {"successful": successful, "failed": failed, "seconds": dt}
