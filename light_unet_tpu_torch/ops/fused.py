"""Per-volume device programs (port of ``light_unet_tpu/ops/fused.py``).

* ``normalize_and_body_mask``: the preprocess stage's device work for one
  volume (clip + rescale, threshold, closing, largest component, dilation)
  in one pass, one upload and one fetch;
* ``preprocess_and_infer`` and ``FusedVolumePipeline``: raw volume in,
  body-masked probability map out.  The volume is uploaded once (float32,
  or uint16 quantized into the clip range, or bfloat16); normalization,
  the sliding window, the body mask, the output quantization and the
  block-sparse packing all run on the device.

The network is whatever ``apply_fn`` the caller passes: the model itself,
a model built with ``use_pallas`` (the fused norm kernel), or
``models/fused_forward.make_fused_apply`` (the fused block kernel).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.ops.body_mask import (
    body_mask_core,
    body_mask_settings,
    mask_metadata,
)
from light_unet_tpu_torch.ops.gaussian import gaussian_importance_map
from light_unet_tpu_torch.ops.intensity import (
    clip_normalize_device,
    compute_clip_values,
    intensity_metadata,
    pad_volume,
)
from light_unet_tpu_torch.ops.sliding_window import (
    _finalize_output,
    _u16_to_f32,
    _valid_mask,
    bucketed_shape,
    choose_chunks,
    compute_positions,
    fetch_host,
    sliding_window_core,
    start_host_copy,
)
from light_unet_tpu_torch.ops.sparse_fetch import block_cap
from light_unet_tpu_torch.utils.device import resolve_device


def normalize_volume(volume: torch.Tensor, true_dims: Sequence[int], lo: float, hi: float, *,
                     range_min: float, range_max: float,
                     dequant: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalized float32 volume, valid mask) of an uploaded padded volume.

    With ``dequant`` the volume holds uint16 levels (as int16 bits) quantized
    on the host into the clip range [lo, hi], not into the volume's own
    [min, max] as ``SlidingWindowInferencer`` does; everything outside the
    clip range is clipped away anyway."""
    if dequant:
        lo32, hi32 = np.float32(lo), np.float32(hi)
        volume = _u16_to_f32(volume) * float((hi32 - lo32) / np.float32(65535.0))
        volume = volume + float(lo32)
    else:
        volume = volume.float()
    valid = _valid_mask(volume.shape, true_dims, volume.device)
    normalized = clip_normalize_device(volume, valid, lo, hi, range_min=range_min,
                                       range_max=range_max)
    return normalized, valid


@torch.no_grad()
def normalize_and_body_mask(image: np.ndarray, intensity_cfg, body_mask_cfg, z_bucket: int = 1,
                            device="cuda") -> Tuple[np.ndarray, np.ndarray, dict, dict]:
    """The preprocess stage of one volume on ``device``: (normalized,
    bool body mask, intensity metadata, mask metadata), with the same
    metadata schemas as ``clip_and_normalize`` and ``generate_body_mask``."""
    dev = resolve_device(device)
    image = np.asarray(image, dtype=np.float32)
    low, high = intensity_cfg.clip_percentile_low, intensity_cfg.clip_percentile_high
    lo, hi = compute_clip_values(image, low, high)
    rng_min, rng_max = intensity_cfg.normalization_range
    settings = body_mask_settings(body_mask_cfg)
    volume = torch.from_numpy(pad_volume(image, z_bucket)).to(dev)
    normalized, valid = normalize_volume(volume, image.shape, lo, hi, range_min=float(rng_min),
                                         range_max=float(rng_max))
    mask, counts = body_mask_core(normalized, valid, *settings)
    sl = tuple(slice(0, s) for s in image.shape)
    normalized_np = normalized.cpu().numpy()[sl]
    mask_np = mask.cpu().numpy()[sl] > 0.5
    return (normalized_np, mask_np,
            intensity_metadata(lo, hi, low, high, intensity_cfg.normalization_range),
            mask_metadata(mask_np, counts.cpu().numpy(), *settings))


@torch.no_grad()
def preprocess_and_infer(volume: torch.Tensor, true_dims, lo: float, hi: float,
                         positions: np.ndarray, n_real: int, imp_map: torch.Tensor, *,
                         apply_fn: Callable, patch_size, chunk: int, tail_chunk: int = 0,
                         range_min: float, range_max: float, threshold: float,
                         closing_voxels: int, keep_largest: bool, dilate_voxels: int,
                         apply_mask: bool, dequant: bool = False, quantize_out: bool = False,
                         sparse_cap: int = 0, sparse_block: int = 8):
    """One volume: dequantize, normalize, sliding window, body mask, output
    quantization and block-sparse packing.  Returns the padded map (float32,
    or uint16 levels as int16 bits) or a ``SparsePack``, on the device."""
    normalized, valid = normalize_volume(volume, true_dims, lo, hi, range_min=range_min,
                                         range_max=range_max, dequant=dequant)
    prob = sliding_window_core(normalized, positions, n_real, imp_map, apply_fn, patch_size,
                               chunk, tail_chunk)
    if apply_mask:
        body, _ = body_mask_core(normalized, valid, threshold, closing_voxels, keep_largest,
                                 dilate_voxels)
        prob = prob * body
    return _finalize_output(prob, quantize_out, sparse_cap, sparse_block)


class FusedVolumePipeline:
    """Raw volume -> body-masked probability map, one device program per volume.

    ``prepare`` (percentiles, quantize, pad, upload) is host work meant for a
    worker thread, so the decode and preparation of case i+1 overlap the
    device's work on case i; ``dispatch`` enqueues the program and returns
    at once; ``fetch`` waits for the map and returns it on the host."""

    def __init__(self, apply_fn: Callable, config, patch_batch: int = 96, transfer_dtype=None,
                 fetch_dtype=None, host_prefetch: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.host_prefetch = bool(host_prefetch)
        self.apply_fn = apply_fn
        self.cfg = config
        self.patch_size = tuple(config.data.patch_size)
        self.patch_batch = patch_batch
        self.z_bucket = config.tpu.z_bucket
        self.imp_map = torch.as_tensor(gaussian_importance_map(self.patch_size), device=self.device)
        # float32; uint16 quantized into the clip range [lo, hi] (max error
        # (hi - lo) / 65535 / 2); or bfloat16.  Unknown names are float32.
        name = str(transfer_dtype or getattr(config.tpu, "transfer_dtype", "float32"))
        self.transfer_dtype = name if name in ("uint16", "bfloat16") else "float32"
        fname = str(fetch_dtype or getattr(config.tpu, "fetch_dtype", "float32"))
        self.quantize_out = fname == "uint16"
        self.sparse_fetch = bool(getattr(config.tpu, "sparse_fetch", False))
        self.sparse_frac = float(getattr(config.tpu, "sparse_fetch_frac", 1.0))
        self.sparse_block = 8

    def prepare(self, image: np.ndarray) -> tuple:
        """Host side of one volume: clip values, quantize or cast, pad, patch
        grid, and the upload (``non_blocking``)."""
        intensity = self.cfg.data.intensity
        image = np.asarray(image, dtype=np.float32)
        lo, hi = compute_clip_values(image, intensity.clip_percentile_low,
                                     intensity.clip_percentile_high)
        shape = image.shape
        pshape = bucketed_shape(shape, self.patch_size, self.z_bucket)
        region = tuple(slice(0, s) for s in shape)
        if self.transfer_dtype == "uint16":
            padded = np.zeros(pshape, np.uint16)
            scale = np.float32(65535.0 / (hi - lo)) if hi > lo else np.float32(0.0)
            tmp = np.clip(image, lo, hi)
            tmp -= np.float32(lo)
            tmp *= scale
            tmp += np.float32(0.5)  # round to nearest under the truncating cast
            padded[region] = tmp
            host = torch.from_numpy(padded.view(np.int16))
        else:
            padded = np.zeros(pshape, np.float32)
            padded[region] = image
            host = torch.from_numpy(padded)
            if self.transfer_dtype == "bfloat16":
                host = host.to(torch.bfloat16)
        positions = compute_positions(shape, self.patch_size, 0.5)
        n = len(positions)
        chunk, tail, n_pad = choose_chunks(n, self.patch_batch)
        posp = np.zeros((n_pad, 3), np.int32)
        posp[:n] = positions
        return host.to(self.device, non_blocking=True), shape, lo, hi, posp, n, (chunk, tail)

    @torch.no_grad()
    def dispatch(self, image_or_prepared):
        """Enqueue the program for one volume (an image or a ``prepare()``
        result); returns (result on the device, original shape)."""
        prep = (image_or_prepared if isinstance(image_or_prepared, tuple)
                else self.prepare(image_or_prepared))
        volume, shape, lo, hi, positions, n_real, (chunk, tail) = prep
        rng = self.cfg.data.intensity.normalization_range
        bm = self.cfg.data.body_mask
        threshold, closing, keep_largest, dilate = body_mask_settings(bm)
        cap = block_cap(volume.shape, self.sparse_block, self.sparse_frac) if self.sparse_fetch else 0
        out = preprocess_and_infer(
            volume, shape, lo, hi, positions, n_real, self.imp_map,
            apply_fn=self.apply_fn, patch_size=self.patch_size, chunk=chunk, tail_chunk=tail,
            range_min=float(rng[0]), range_max=float(rng[1]), threshold=threshold,
            closing_voxels=closing, keep_largest=keep_largest, dilate_voxels=dilate,
            apply_mask=bool(bm.enabled and bm.apply_to_inference),
            dequant=self.transfer_dtype == "uint16", quantize_out=self.quantize_out,
            sparse_cap=cap, sparse_block=self.sparse_block)
        if self.host_prefetch and self.device.type == "cuda":
            out = start_host_copy(out)  # fetch() waits on its event
        return out, shape

    @staticmethod
    def fetch(dispatched) -> np.ndarray:
        """The map of one ``dispatch()`` on the host, float32, original shape."""
        out, shape = dispatched
        host = fetch_host(out)[: shape[0], : shape[1], : shape[2]]
        if host.dtype == np.uint16:  # quantized fetch -> dequantize on the host
            host = host.astype(np.float32)
            host *= np.float32(1.0 / 65535.0)
        return host

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return self.fetch(self.dispatch(image))
