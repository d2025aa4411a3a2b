"""Batched sliding-window 3D inference on one device (port of
``light_unet_tpu/ops/sliding_window.py:52-257, 421-731``).

48^3 windows at overlap 0.5 with tail windows snapped to the volume edge,
zero padding for volumes smaller than a patch, Gaussian importance blending
(sigma = len/6).  All patches are gathered on the device in one indexing
op, run through the network in chunks of ``patch_batch`` (plus one smaller
power-of-two tail chunk), and scatter-added in patch order ``i = 0..n-1``
(the order of the JAX package's ``fori_loop``) before the divide by the
summed weights.  The volume's last axis is padded to a ``z_bucket``
multiple; positions come from the original dims.

Transfers follow the JAX package: the volume is uploaded as uint16 over its
own [min, max] range (``tpu.transfer_dtype``), the body mask as bit-packed
uint8, and the map is quantized to uint16 for the fetch
(``tpu.fetch_dtype``), optionally block-sparse (``tpu.sparse_fetch``).  A
uint16 array travels as int16 holding the same bits.  With ``host_prefetch``
(default on, as in the JAX package) ``dispatch`` starts the map's copy into
pinned host memory behind a CUDA event, so ``fetch`` finds it there.

One device only: a mesh of more than one device, or ``spatial_shard``,
raises ``NotImplementedError`` (ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.ops.gaussian import gaussian_importance_map
from light_unet_tpu_torch.ops.sparse_fetch import (
    SparsePack,
    block_cap,
    fetch_maybe_sparse,
    pack_blocks,
    to_numpy,
)
from light_unet_tpu_torch.utils.device import resolve_device


def compute_positions(shape: Sequence[int], patch_size: Sequence[int],
                      overlap: float = 0.5) -> np.ndarray:
    """Window origins per axis (stride + edge snap).  Returns [N, 3] int32."""
    per_axis = []
    for dim, p in zip(shape, patch_size):
        stride = max(1, int(p * (1.0 - overlap)))
        if dim >= p:
            pos = list(range(0, dim - p + 1, stride))
            if dim > p and (not pos or pos[-1] + p < dim):
                pos.append(dim - p)
        else:
            pos = [0]
        if not pos:
            pos = [0]
        per_axis.append(pos)
    grid = np.stack(np.meshgrid(*per_axis, indexing="ij"), axis=-1).reshape(-1, 3)
    return grid.astype(np.int32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucketed_shape(shape: Sequence[int], patch_size: Sequence[int],
                   z_bucket: int = 48) -> Tuple[int, int, int]:
    """Padded shape: every axis at least the patch size, the last axis
    rounded up to a multiple of ``z_bucket``."""
    out = [max(int(d), int(p)) for d, p in zip(shape, patch_size)]
    out[2] = _round_up(out[2], z_bucket)
    return tuple(out)  # type: ignore[return-value]


def choose_chunk(n_patches: int, patch_batch: int) -> int:
    """Smallest power-of-two bucket (>= 8) covering ``n_patches``, capped at
    ``patch_batch``."""
    c = 8
    while c < min(n_patches, patch_batch):
        c *= 2
    return min(c, patch_batch)


def choose_chunks(n_patches: int, patch_batch: int) -> Tuple[int, int, int]:
    """(chunk, tail_chunk, n_pad): full ``chunk`` forwards plus at most one
    smaller power-of-two tail (275 patches at 192 -> 192 + 128)."""
    n_patches = max(1, n_patches)
    chunk = choose_chunk(n_patches, patch_batch)
    rem = n_patches % chunk
    if n_patches <= chunk or rem == 0:
        return chunk, 0, _round_up(n_patches, chunk)
    tail = choose_chunk(rem, patch_batch)
    if tail == chunk:
        return chunk, 0, _round_up(n_patches, chunk)
    return chunk, tail, (n_patches // chunk) * chunk + tail


def quantize_u16(volume: np.ndarray, out: np.ndarray, region) -> Tuple[float, float]:
    """Quantize ``volume`` (f32) into ``out[region]`` (uint16, zero-filled)
    over the volume's own [min, max]; returns (vlo, vhi)."""
    vlo = float(volume.min()) if volume.size else 0.0
    vhi = float(volume.max()) if volume.size else 0.0
    scale = np.float32(65535.0 / (vhi - vlo)) if vhi > vlo else np.float32(0.0)
    tmp = volume - np.float32(vlo)
    tmp *= scale
    tmp += np.float32(0.5)  # round-to-nearest under the truncating cast
    out[region] = tmp
    return vlo, vhi


def _u16_to_f32(t: torch.Tensor) -> torch.Tensor:
    """int16 tensor holding uint16 bits -> float32 values 0..65535."""
    return (t.to(torch.int32) & 0xFFFF).float()


def _valid_mask(shape, true_dims, device) -> torch.Tensor:
    """1.0 inside the true extents of a zero-padded volume, built on the device."""
    axes = [torch.arange(s, device=device) < int(t) for s, t in zip(shape, true_dims)]
    return (axes[0][:, None, None] & axes[1][None, :, None] & axes[2][None, None, :]).float()


def _dequant_volume(volume: torch.Tensor, true_dims, vlo: float, vhi: float) -> torch.Tensor:
    """Invert ``quantize_u16`` in float32 and re-zero the bucket padding."""
    lo, hi = np.float32(vlo), np.float32(vhi)
    v = _u16_to_f32(volume) * ((hi - lo) / np.float32(65535.0)) + lo
    return v * _valid_mask(volume.shape, true_dims, volume.device)


def _apply_post_mask(out: torch.Tensor, post_mask: torch.Tensor, mask_packed: bool) -> torch.Tensor:
    """Multiply the binary post mask in; a packed mask is uint8 bit-planes
    along the last axis (np.packbits, little bit order)."""
    if mask_packed:
        shifts = torch.arange(8, dtype=torch.uint8, device=post_mask.device)
        bits = (post_mask[..., None] >> shifts) & 1
        post_mask = bits.reshape(post_mask.shape[0], post_mask.shape[1], -1)
    return out * post_mask.float()


def quantize_out(out: torch.Tensor) -> torch.Tensor:
    """[0, 1] map -> uint16 levels, held as int16 with the same bits."""
    q = torch.round(torch.clamp(out, 0.0, 1.0) * 65535.0).to(torch.int32)
    return torch.where(q > 32767, q - 65536, q).to(torch.int16)


def _finalize_output(out, quantize: bool, sparse_cap: int, sparse_block: int):
    if quantize:
        out = quantize_out(out)
    if sparse_cap > 0:
        return SparsePack(out, *pack_blocks(out, sparse_block, sparse_cap),
                          cap=sparse_cap, block=sparse_block)
    return out


def sliding_window_core_parts(volume, positions: np.ndarray, n_real: int, imp_map, apply_fn,
                              patch_size, chunk: int, tail_chunk: int = 0):
    """Raw (prob, count) accumulators: gather -> chunked forward -> scatter-add.

    ``positions`` is the padded [n_pad, 3] host array; its first ``n_real``
    rows are real windows.  Padding windows run through the forward (so the
    chunk schedule is the JAX package's) but carry zero weight, so they are
    not added."""
    n = positions.shape[0]
    pd, ph, pw = patch_size
    dev = volume.device
    pos = torch.as_tensor(positions, dtype=torch.int64, device=dev)
    ar = [torch.arange(s, device=dev) for s in patch_size]
    patches = volume[
        (pos[:, 0, None] + ar[0])[:, :, None, None],
        (pos[:, 1, None] + ar[1])[:, None, :, None],
        (pos[:, 2, None] + ar[2])[:, None, None, :],
    ]

    def fwd(c):
        return apply_fn(c[..., None])[..., 0].float()

    n_main = n - tail_chunk
    preds = [fwd(patches[i:i + chunk]) for i in range(0, n_main, chunk)]
    if tail_chunk:
        preds.append(fwd(patches[n_main:]))
    preds = torch.cat(preds)
    weighted = preds * imp_map[None]

    prob = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    count = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    for i, (z, y, x) in enumerate(positions[:n_real].tolist()):
        prob[z:z + pd, y:y + ph, x:x + pw] += weighted[i]
        count[z:z + pd, y:y + ph, x:x + pw] += imp_map
    return prob, count


def sliding_window_core(volume, positions, n_real, imp_map, apply_fn, patch_size, chunk,
                        tail_chunk: int = 0):
    """Blended probability map of a zero-padded [Dp, Hp, Wp] volume."""
    prob, count = sliding_window_core_parts(
        volume, positions, n_real, imp_map, apply_fn, patch_size, chunk, tail_chunk)
    return torch.where(count > 0, prob / torch.where(count > 0, count, 1.0), prob)


class HostPrefetch(NamedTuple):
    """A dispatch result whose device-to-host copy is under way: ``host`` is
    pinned memory receiving the dense map (or, for a ``SparsePack``, only its
    tile count), and ``done`` is the CUDA event recorded after the copy."""

    out: Any
    host: torch.Tensor
    done: Any


def start_host_copy(out):
    """Start ``out``'s copy into pinned host memory; returns a ``HostPrefetch``.
    A ``SparsePack`` sends only its count: its tiles are sliced to the
    occupied bucket at fetch time, so copying all of them would move the
    bytes sparse fetch exists to avoid."""
    src = out.count if isinstance(out, SparsePack) else out
    host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    host.copy_(src, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return HostPrefetch(out, host, done)


def on_device(out):
    """The dense device map of a dispatch result (a tensor, a ``SparsePack``
    or a ``HostPrefetch`` of either)."""
    if isinstance(out, HostPrefetch):
        out = out.out
    return out.dense if isinstance(out, SparsePack) else out


def fetch_host(out) -> np.ndarray:
    """A dispatch result on the host, padded shape, in its fetch dtype."""
    if isinstance(out, HostPrefetch):
        out.done.synchronize()
        if isinstance(out.out, SparsePack):
            return fetch_maybe_sparse(out.out._replace(count=out.host))
        return to_numpy(out.host)
    return fetch_maybe_sparse(out)


class SlidingWindowInferencer:
    """Reusable sliding-window engine for one model on one device."""

    def __init__(
        self,
        apply_fn: Callable,
        patch_size: Sequence[int] = (48, 48, 48),
        overlap: float = 0.5,
        patch_batch: int = 32,
        z_bucket: int = 48,
        transfer_dtype: str = "float32",
        fetch_dtype: str = "float32",
        sparse_fetch: bool = False,
        sparse_fetch_frac: float = 1.0,
        mesh_shape: Optional[Sequence[int]] = None,
        spatial_shard: bool = False,
        host_prefetch: bool = True,
        device="cuda",
    ):
        if spatial_shard or (mesh_shape is not None and int(np.prod(mesh_shape)) > 1):
            raise NotImplementedError(
                "multi-device sliding window (tpu.mesh_shape with more than one device, "
                "tpu.spatial_shard) is not ported yet: ROADMAP queue 1, item 10")
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.patch_size = tuple(int(p) for p in patch_size)
        self.overlap = float(overlap)
        self.patch_batch = int(patch_batch)
        self.z_bucket = int(z_bucket)
        self.imp_map = torch.as_tensor(gaussian_importance_map(self.patch_size), device=self.device)
        self.quantize_in = str(transfer_dtype) == "uint16"
        self.quantize_out = str(fetch_dtype) == "uint16"
        self.sparse_fetch = bool(sparse_fetch)
        self.sparse_frac = float(sparse_fetch_frac)
        self.sparse_block = 8
        # callers that consume the map on the device (bbox-only serving, the
        # device validation sweep) turn this off: no copy rides the link
        self.host_prefetch = bool(host_prefetch)

    def prepare(self, volume: np.ndarray, post_mask: Optional[np.ndarray] = None):
        """Host-side prep of one case (patch grid, quantize/pad, mask pack) and
        the upload; run it on a worker thread to overlap the previous case."""
        volume = np.asarray(volume, dtype=np.float32)
        if volume.ndim == 4 and volume.shape[0] == 1:
            volume = volume[0]
        if volume.ndim != 3:
            raise ValueError(f"expected 3D volume, got shape {volume.shape}")
        shape = volume.shape
        positions = compute_positions(shape, self.patch_size, self.overlap)
        n = positions.shape[0]
        pshape = bucketed_shape(shape, self.patch_size, self.z_bucket)
        chunk, tail, n_pad = choose_chunks(n, self.patch_batch)
        pos_padded = np.zeros((n_pad, 3), dtype=np.int32)
        pos_padded[:n] = positions

        region = (slice(0, shape[0]), slice(0, shape[1]), slice(0, shape[2]))
        vlo = vhi = 0.0
        if self.quantize_in:
            vol_padded = np.zeros(pshape, dtype=np.uint16)
            vlo, vhi = quantize_u16(volume, vol_padded, region)
            vol_padded = vol_padded.view(np.int16)
        else:
            vol_padded = np.zeros(pshape, dtype=np.float32)
            vol_padded[region] = volume

        pm = None
        mask_packed = False
        if post_mask is not None:
            pm = np.zeros(pshape, dtype=np.uint8)
            pm[region] = np.asarray(post_mask) > 0
            if pshape[2] % 8 == 0:  # bit-pack along the last axis when it is byte-aligned
                pm = np.packbits(pm, axis=2, bitorder="little")
                mask_packed = True
            pm = torch.from_numpy(pm).to(self.device, non_blocking=True)
        return {
            "volume": torch.from_numpy(vol_padded).to(self.device, non_blocking=True),
            "shape": shape, "vlo": vlo, "vhi": vhi, "positions": pos_padded, "n_real": n,
            "chunks": (chunk, tail), "post_mask": pm, "mask_packed": mask_packed,
        }

    @torch.no_grad()
    def dispatch(self, prep: dict):
        """Run the device computation for one ``prepare()``d case; returns
        (out, orig_shape) where ``out`` is the padded map (or a SparsePack)
        still on the device."""
        vol = prep["volume"]
        if self.quantize_in:
            vol = _dequant_volume(vol, prep["shape"], prep["vlo"], prep["vhi"])
        chunk, tail = prep["chunks"]
        out = sliding_window_core(vol, prep["positions"], prep["n_real"], self.imp_map,
                                  self.apply_fn, self.patch_size, chunk, tail)
        if prep["post_mask"] is not None:
            out = _apply_post_mask(out, prep["post_mask"], prep["mask_packed"])
        cap = block_cap(vol.shape, self.sparse_block, self.sparse_frac) if self.sparse_fetch else 0
        out = _finalize_output(out, self.quantize_out, cap, self.sparse_block)
        if self.host_prefetch and self.device.type == "cuda":
            out = start_host_copy(out)
        return out, prep["shape"]

    @staticmethod
    def fetch(dispatched) -> np.ndarray:
        out, shape = dispatched
        host = fetch_host(out)[: shape[0], : shape[1], : shape[2]]
        if host.dtype == np.uint16:  # quantized fetch -> dequantize on the host
            host = host.astype(np.float32)
            host *= np.float32(1.0 / 65535.0)
        return host
