"""Per-volume device programs (port of ``light_unet_tpu/ops/fused.py``).

* ``normalize_and_body_mask``: the preprocess stage's device work for one
  volume (clip + rescale, threshold, closing, largest component, dilation)
  in one pass, one upload and one fetch;
* ``fused_unit`` and ``FusedVolumePipeline``: raw volume in,
  body-masked probability map out.  The volume is uploaded once (float32,
  or uint16 quantized into the clip range, or bfloat16); normalization,
  the sliding window, the body mask, the output quantization and the
  block-sparse packing all run on the device.

Each is one unit, as each is one ``jax.jit`` program in the JAX package
(``preprocess_unit``, ``fused_unit``): the true extents, clip values, window
origins and weights are device data, and nothing inside reads a value on
the host (the CCL kernel, sized compactions), so on a card each is one CUDA
graph replay per key, the JAX program's static arguments with the bucketed
shape (``utils/graphs.py``); ``graphs=False`` runs the same unit eagerly, as
does the preprocess pass when its caller passes no runner.

The network is whatever ``apply_fn`` the caller passes: the model itself
(in eval mode it runs every norm on the fused norm kernel), or
``models/fused_forward.make_fused_apply`` (the fused block kernel).
"""

from __future__ import annotations

import functools
import itertools
from typing import Callable, NamedTuple, Tuple

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
    _upload,
    _valid_mask,
    as_result,
    bucketed_shape,
    choose_chunks,
    compute_positions,
    host_map,
    sliding_window_core,
    start_host_copy,
)
from light_unet_tpu_torch.ops.sparse_fetch import block_cap
from light_unet_tpu_torch.utils import fastio, tracing
from light_unet_tpu_torch.utils.device import resolve_device
from light_unet_tpu_torch.utils.graphs import run_unit, runner_for, unit_key


def normalize_volume(volume: torch.Tensor, true_dims, lo, hi, *, range_min: float,
                     range_max: float, dequant: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(normalized float32 volume, valid mask) of an uploaded padded volume;
    ``true_dims``, ``lo`` and ``hi`` are host values or tensors on the
    volume's device.

    With ``dequant`` the volume holds uint16 levels (as int16 bits) quantized
    on the host into the clip range [lo, hi], not into the volume's own
    [min, max] as ``SlidingWindowInferencer`` does; everything outside the
    clip range is clipped away anyway."""
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=volume.device) for v in (lo, hi))
    if dequant:
        volume = _u16_to_f32(volume) * ((hi - lo) / 65535.0) + lo
    else:
        volume = volume.float()
    valid = _valid_mask(volume.shape, true_dims, volume.device)
    normalized = clip_normalize_device(volume, valid, lo, hi, range_min=range_min,
                                       range_max=range_max)
    return normalized, valid


def preprocess_unit(volume, true_dims, lohi, *, range_min: float, range_max: float,
                    threshold: float, closing_voxels: int, keep_largest: bool,
                    dilate_voxels: int) -> tuple:
    """The preprocess pass of one volume (the port of
    ``_normalize_and_body_mask_jit``): (normalized, body mask, counts)."""
    normalized, valid = normalize_volume(volume, true_dims, lohi[0], lohi[1],
                                         range_min=range_min, range_max=range_max)
    mask, counts = body_mask_core(normalized, valid, threshold, closing_voxels, keep_largest,
                                  dilate_voxels)
    return normalized, mask, counts


class PreprocessPrep(NamedTuple):
    """One volume's upload for ``dispatch_preprocess``: the padded float32
    volume, its true shape and clip values, and both as device data."""

    volume: torch.Tensor
    shape: Tuple[int, int, int]
    lo: float
    hi: float
    dims: torch.Tensor
    lohi: torch.Tensor


def prepare_preprocess(image: np.ndarray, intensity_cfg, z_bucket: int = 1,
                       device="cuda") -> PreprocessPrep:
    """Host side of the preprocess pass: exact clip percentiles, the pad to
    the bucket and the uploads (without blocking)."""
    dev = resolve_device(device)
    image = np.asarray(image, dtype=np.float32)
    lo, hi = compute_clip_values(image, intensity_cfg.clip_percentile_low,
                                 intensity_cfg.clip_percentile_high)
    return PreprocessPrep(_upload(pad_volume(image, z_bucket), dev), image.shape, lo, hi,
                          _upload(np.asarray(image.shape, np.int32), dev),
                          _upload(np.asarray([lo, hi], np.float32), dev))


@torch.no_grad()
def dispatch_preprocess(prep: PreprocessPrep, intensity_cfg, body_mask_cfg, runner=None):
    """(normalized, body mask, counts) on the device: one unit, one replay of
    ``runner``'s graph per (bucketed shape, settings) when the caller gives
    a ``utils/graphs.GraphRunner`` (``pipeline/preprocess.py`` owns one for
    a run), else eagerly (the reference path).  No host sync."""
    rng_min, rng_max = intensity_cfg.normalization_range
    threshold, closing, keep_largest, dilate = body_mask_settings(body_mask_cfg)
    static = dict(range_min=float(rng_min), range_max=float(rng_max), threshold=threshold,
                  closing_voxels=closing, keep_largest=keep_largest, dilate_voxels=dilate)
    return run_unit(runner, unit_key("preprocess", **static),
                    functools.partial(preprocess_unit, **static),
                    prep.volume, prep.dims, prep.lohi)


def normalize_and_body_mask(image: np.ndarray, intensity_cfg, body_mask_cfg, z_bucket: int = 1,
                            device="cuda", runner=None
                            ) -> Tuple[np.ndarray, np.ndarray, dict, dict]:
    """The preprocess stage of one volume on ``device``: (normalized,
    bool body mask, intensity metadata, mask metadata), with the same
    metadata schemas as ``clip_and_normalize`` and ``generate_body_mask``.
    One upload, one unit (``dispatch_preprocess``, graphed by ``runner``),
    one fetch."""
    prep = prepare_preprocess(image, intensity_cfg, z_bucket, device)
    normalized, mask, counts = dispatch_preprocess(prep, intensity_cfg, body_mask_cfg, runner)
    sl = tuple(slice(0, s) for s in prep.shape)
    normalized_np = normalized.cpu().numpy()[sl]  # the fetch
    mask_np = mask.cpu().numpy()[sl] > 0.5
    low, high = intensity_cfg.clip_percentile_low, intensity_cfg.clip_percentile_high
    return (normalized_np, mask_np,
            intensity_metadata(prep.lo, prep.hi, low, high, intensity_cfg.normalization_range),
            mask_metadata(mask_np, counts.cpu().numpy(), *body_mask_settings(body_mask_cfg)))


def fused_unit(volume, true_dims, lohi, positions, mask, *, imp_map, apply_fn, patch_size,
               chunk: int, tail_chunk: int, range_min: float, range_max: float,
               threshold: float, closing_voxels: int, keep_largest: bool, dilate_voxels: int,
               apply_mask: bool, dequant: bool, quantize_out: bool, sparse_cap: int,
               sparse_block: int) -> tuple:
    """One volume, raw in and map out (the port of ``_preprocess_and_infer_jit``):
    dequantize, normalize, sliding window, body mask, output quantization
    and block-sparse packing; ``_finalize_output``'s tuple."""
    normalized, valid = normalize_volume(volume, true_dims, lohi[0], lohi[1],
                                         range_min=range_min, range_max=range_max,
                                         dequant=dequant)
    prob = sliding_window_core(normalized, positions, mask, imp_map, apply_fn, patch_size, chunk,
                               tail_chunk)
    if apply_mask:
        body, _ = body_mask_core(normalized, valid, threshold, closing_voxels, keep_largest,
                                 dilate_voxels)
        prob = prob * body
    return _finalize_output(prob, quantize_out, sparse_cap, sparse_block)


class FusedPrep(NamedTuple):
    """One volume's ``FusedVolumePipeline.prepare``: the uploaded padded
    volume, its true shape, clip values, window schedule, what differs
    per volume as device data, and the volume's sequence number (the
    request id of its spans)."""

    volume: torch.Tensor
    shape: Tuple[int, int, int]
    lo: float
    hi: float
    chunks: Tuple[int, int]
    dims: torch.Tensor
    lohi: torch.Tensor
    positions: torch.Tensor
    weights: torch.Tensor
    req: int


class FusedDispatch(NamedTuple):
    """One volume's ``FusedVolumePipeline.dispatch``: the result on the
    device, the original shape, and the volume's sequence number."""

    out: object
    shape: Tuple[int, int, int]
    req: int


class FusedVolumePipeline:
    """Raw volume -> body-masked probability map, one device program per volume.

    ``prepare`` (percentiles, quantize, pad, upload) is host work meant for a
    worker thread, so the decode and preparation of case i+1 overlap the
    device's work on case i; ``dispatch`` enqueues the program and returns
    at once (no host sync); ``fetch`` waits for the map and returns it on
    the host.  On a card the program is one CUDA graph replay per key (the
    JAX program's static arguments, the bucketed shape and the network);
    ``graphs=False`` runs it eagerly (the reference path)."""

    def __init__(self, apply_fn: Callable, config, patch_batch: int = 96, transfer_dtype=None,
                 fetch_dtype=None, host_prefetch: bool = True, graphs: bool = True,
                 device="cuda"):
        self.device = resolve_device(device)
        self.graphs = runner_for(self.device, graphs, "fused")
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
        self._seq = itertools.count()  # volumes' sequence numbers (next() is atomic)

    def prepare(self, image: np.ndarray) -> FusedPrep:
        """Host side of one volume: clip values and the uint16 quantize + pad
        (native host library, ``utils/fastio.py``) or a cast and pad, patch
        grid, and the uploads (``non_blocking``).  Spans ``prepare`` with
        ``prepare.clip``, ``prepare.quantize`` and ``prepare.upload``, under
        the volume's new sequence number."""
        req = next(self._seq)
        with tracing.span("prepare", req):
            intensity = self.cfg.data.intensity
            image = np.asarray(image, dtype=np.float32)
            with tracing.span("prepare.clip"):
                lo, hi = compute_clip_values(image, intensity.clip_percentile_low,
                                             intensity.clip_percentile_high)
            shape = image.shape
            pshape = bucketed_shape(shape, self.patch_size, self.z_bucket)
            with tracing.span("prepare.quantize"):
                if self.transfer_dtype == "uint16":  # one native pass: clip, scale, round, pad
                    padded = fastio.quantize_pad(image, pshape, lo, hi)
                    host = torch.from_numpy(padded.view(np.int16))
                else:
                    padded = np.zeros(pshape, np.float32)
                    padded[tuple(slice(0, s) for s in shape)] = image
                    host = torch.from_numpy(padded)
                    if self.transfer_dtype == "bfloat16":
                        host = host.to(torch.bfloat16)
            positions = compute_positions(shape, self.patch_size, 0.5)
            n = len(positions)
            chunk, tail, n_pad = choose_chunks(n, self.patch_batch)
            posp = np.zeros((n_pad, 3), np.int64)
            posp[:n] = positions
            weights = np.zeros(n_pad, np.float32)
            weights[:n] = 1.0
            dev = self.device
            with tracing.span("prepare.upload"):
                return FusedPrep(_upload(host, dev), shape, lo, hi, (chunk, tail),
                                 _upload(np.asarray(shape, np.int32), dev),
                                 _upload(np.asarray([lo, hi], np.float32), dev),
                                 _upload(posp, dev), _upload(weights, dev), req)

    def sparse_cap(self, padded_shape) -> int:
        """The block-sparse fetch's tile capacity (0: a dense fetch)."""
        return block_cap(padded_shape, self.sparse_block, self.sparse_frac) if self.sparse_fetch else 0

    def unit(self, prep: FusedPrep) -> tuple:
        """(key, function, inputs) of one prepared volume's program."""
        chunk, tail = prep.chunks
        rng = self.cfg.data.intensity.normalization_range
        bm = self.cfg.data.body_mask
        threshold, closing, keep_largest, dilate = body_mask_settings(bm)
        cap = self.sparse_cap(prep.volume.shape)
        static = dict(
            chunk=chunk, tail_chunk=tail, range_min=float(rng[0]), range_max=float(rng[1]),
            threshold=threshold, closing_voxels=closing, keep_largest=keep_largest,
            dilate_voxels=dilate, apply_mask=bool(bm.enabled and bm.apply_to_inference),
            dequant=self.transfer_dtype == "uint16", quantize_out=self.quantize_out,
            sparse_cap=cap, sparse_block=self.sparse_block)
        fn = functools.partial(fused_unit, imp_map=self.imp_map, apply_fn=self.apply_fn,
                               patch_size=self.patch_size, **static)
        inputs = (prep.volume, prep.dims, prep.lohi, prep.positions, prep.weights)
        return unit_key("fused", self.apply_fn, **static), fn, inputs

    @torch.no_grad()
    def dispatch(self, image_or_prepared) -> FusedDispatch:
        """Enqueue the program for one volume (an image or a ``prepare()``
        result); returns (result on the device, original shape, sequence
        number)."""
        prep = (image_or_prepared if isinstance(image_or_prepared, tuple)
                else self.prepare(image_or_prepared))
        with tracing.span("dispatch", prep.req):
            key, fn, inputs = self.unit(prep)
            out = as_result(run_unit(self.graphs, key, fn, *inputs),
                            self.sparse_cap(prep.volume.shape), self.sparse_block)
            if self.host_prefetch and self.device.type == "cuda":
                out = start_host_copy(out)  # fetch() waits on its event
            return FusedDispatch(out, prep.shape, prep.req)

    @staticmethod
    def fetch(dispatched: FusedDispatch) -> np.ndarray:
        """The map of one ``dispatch()`` on the host, float32, original shape."""
        with tracing.span("fetch", dispatched.req):
            return host_map(dispatched.out, dispatched.shape)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        return self.fetch(self.dispatch(image))
