"""Batched sliding-window 3D inference (port of
``light_unet_tpu/ops/sliding_window.py``).

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

On a mesh of several ranks (``parallel/mesh.py``, one process per GPU)
there are two sharded paths, as in the JAX package:

* patch-sharded (``sliding_window_core_sharded``): every rank holds the
  whole volume and runs its contiguous share of the padded window list
  with the same (chunk, tail) schedule; ``prob`` and ``count`` are summed
  over the ranks (``psum``) before the divide, so every rank holds the map;
* slab-sharded (``spatial_shard``, ``sliding_window_core_slab_sharded``):
  z is padded to a multiple of the ranks, each rank uploads one z-slab
  (at least a patch wide, else it warns and takes the patch-sharded path)
  and runs the windows whose z origin it owns; the halo is the right
  neighbour's head (a left send), and what a rank accumulated past its
  slab is sent right and added onto the neighbour's head.  The output
  stays sharded: ``fetch`` gathers it, and the mesh's first rank holds
  the whole map.

The packed mask and the sparse fetch keep the JAX package's rules per
mode: neither in slab mode.  ``spatial_shard`` without a mesh of more than
one rank is a no-op.

A volume's window is one unit, as it is one program in the JAX package
(``window_unit``, on one device or patch-sharded, and
``sliding_window_core_slab_sharded``): the window origins, the real-window
weights, the true extents, the value range and the post mask are device
data (``prepare`` uploads them), and nothing inside reads a value on the
host, so on a card each unit is one CUDA graph replay (``utils/graphs.py``)
per key: the JAX program's static arguments (chunk, tail, flags, caps)
with the padded shapes, the network and its compute dtype.  Over an NCCL mesh the
graph holds the collectives; a gloo mesh (host-staged collectives) and
``graphs=False`` (the reference path) run the same unit eagerly, so
graphed and eager are equal by construction.  The CPU has no graphs.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.ops.gaussian import gaussian_importance_map
from light_unet_tpu_torch.parallel.collectives import gather_to_root, ppermute, psum
from light_unet_tpu_torch.parallel.mesh import Mesh, mesh_size
from light_unet_tpu_torch.ops.sparse_fetch import (
    SparsePack,
    block_cap,
    fetch_maybe_sparse,
    host_parts,
    pack_blocks,
    to_numpy,
    unpack_parts,
)
from light_unet_tpu_torch.utils import tracing
from light_unet_tpu_torch.utils.device import resolve_device
from light_unet_tpu_torch.utils.graphs import run_unit, runner_for, unit_key


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


def _valid_mask(shape, true_dims, device, zoff: int = 0) -> torch.Tensor:
    """1.0 inside the true extents of a zero-padded volume, built on the
    device; ``true_dims`` are host ints or an int tensor on ``device`` (the
    graphed units read them as device data); ``zoff`` is the global z of the
    first column (a z-slab)."""
    offs = (0, 0, zoff)
    axes = [torch.arange(s, device=device) + o < t for s, t, o in zip(shape, true_dims, offs)]
    return (axes[0][:, None, None] & axes[1][None, :, None] & axes[2][None, None, :]).float()


def _dequant_volume(volume: torch.Tensor, true_dims, vlo, vhi, zoff: int = 0) -> torch.Tensor:
    """Invert ``quantize_u16`` in float32 and re-zero the bucket padding;
    ``vlo`` and ``vhi`` are floats or float32 tensors on the volume's device."""
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=volume.device) for v in (vlo, vhi))
    v = _u16_to_f32(volume) * ((hi - lo) / 65535.0) + lo
    return v * _valid_mask(volume.shape, true_dims, volume.device, zoff)


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


def _finalize_output(out, quantize: bool, sparse_cap: int, sparse_block: int) -> tuple:
    """(map,) or, with a sparse cap, (map, count, idx, tiles): see ``as_result``."""
    if quantize:
        out = quantize_out(out)
    if sparse_cap > 0:
        return (out, *pack_blocks(out, sparse_block, sparse_cap))
    return (out,)


def as_result(parts: tuple, sparse_cap: int, sparse_block: int):
    """A unit's output tuple as a dispatch result: the map, or a ``SparsePack``."""
    if sparse_cap > 0:
        return SparsePack(*parts, cap=sparse_cap, block=sparse_block)
    return parts[0]


def _blend(prob: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.where(count > 0, prob / torch.where(count > 0, count, 1.0), prob)


def chunk_forward(apply_fn, chunk: torch.Tensor) -> torch.Tensor:
    """The network on a [n, pd, ph, pw] chunk of patches: float32
    probabilities of the same shape."""
    return apply_fn(chunk[..., None])[..., 0].float()


def sliding_window_core_parts(volume, positions: torch.Tensor, mask: torch.Tensor, imp_map,
                              apply_fn, patch_size, chunk: int, tail_chunk: int = 0):
    """Raw (prob, count) accumulators: gather -> chunked forward -> scatter-add.

    ``positions`` [n_pad, 3] (window origins) and ``mask`` [n_pad] (1 real,
    0 padding) are tensors on the volume's device, as the JAX package's are
    traced arrays: nothing here reads a value on the host, so a graph
    captured for one volume serves every volume of its bucket.  Every window
    runs through the forward in the (chunk, tail) schedule and is added with
    weight ``imp_map * mask``, padding windows with 0.  The scatter-add is
    one ``index_add_`` a window into the flattened accumulators, in window
    order (the JAX package's ``fori_loop`` order); a window's flat indices
    are distinct, so each voxel takes one add a window and the sums round as
    the JAX package's ordered slice updates do."""
    n = positions.shape[0]
    dev = volume.device
    d, h, w = volume.shape
    pos = positions.long()
    ar = [torch.arange(s, device=dev) for s in patch_size]
    patches = volume[
        (pos[:, 0, None] + ar[0])[:, :, None, None],
        (pos[:, 1, None] + ar[1])[:, None, :, None],
        (pos[:, 2, None] + ar[2])[:, None, None, :],
    ]

    n_main = n - tail_chunk
    sizes = [chunk] * (n_main // chunk) + ([tail_chunk] if tail_chunk else [])
    preds = torch.empty(patches.shape, dtype=torch.float32, device=dev)
    start = 0
    for size in sizes:
        preds[start:start + size] = chunk_forward(apply_fn, patches[start:start + size])
        start += size
    weights = imp_map[None] * mask[:, None, None, None]
    weighted = preds * weights

    prob = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    count = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    # flat index of a window's voxel: its origin's flat index + its offset
    offsets = (ar[0][:, None, None] * (h * w) + ar[1][None, :, None] * w
               + ar[2][None, None, :]).reshape(-1)
    origins = pos[:, 0] * (h * w) + pos[:, 1] * w + pos[:, 2]
    prob_flat, count_flat = prob.view(-1), count.view(-1)
    for i in range(n):
        idx = origins[i] + offsets
        prob_flat.index_add_(0, idx, weighted[i].reshape(-1))
        count_flat.index_add_(0, idx, weights[i].reshape(-1))
    return prob, count


def sliding_window_core(volume, positions, mask, imp_map, apply_fn, patch_size, chunk,
                        tail_chunk: int = 0):
    """Blended probability map of a zero-padded [Dp, Hp, Wp] volume."""
    return _blend(*sliding_window_core_parts(volume, positions, mask, imp_map, apply_fn,
                                             patch_size, chunk, tail_chunk))


def window_unit(volume, true_dims, vrange, positions, mask, post_mask=None, *, imp_map,
                apply_fn, patch_size, chunk: int, tail_chunk: int, use_post_mask: bool,
                dequant: bool, quantize_out: bool, sparse_cap: int, sparse_block: int,
                mask_packed: bool, mesh: Optional[Mesh] = None) -> tuple:
    """One volume (the port of ``_sliding_window_jit``, and with ``mesh`` of
    the JAX engine's patch-sharded ``_sharded_jit``): dequantize (``vrange``
    = [vlo, vhi]), window, post mask, quantize and pack.  A tuple of tensors
    (``_finalize_output``); one graph a key."""
    if dequant:
        volume = _dequant_volume(volume, true_dims, vrange[0], vrange[1])
    if mesh is None:
        out = sliding_window_core(volume, positions, mask, imp_map, apply_fn, patch_size, chunk,
                                  tail_chunk)
    else:
        out = sliding_window_core_sharded(volume, positions, mask, imp_map, apply_fn,
                                          patch_size, chunk, mesh, tail_chunk)
    if use_post_mask:
        out = _apply_post_mask(out, post_mask, mask_packed)
    return _finalize_output(out, quantize_out, sparse_cap, sparse_block)


def sliding_window_core_sharded(volume, positions, mask, imp_map, apply_fn, patch_size,
                                chunk: int, mesh: Mesh, tail_chunk: int = 0):
    """The patch axis sharded over ``mesh``: rank r takes rows
    ``[r * per, (r + 1) * per)`` of the padded [n_pad, 3] window list and
    its [n_pad] mask (``n_pad`` a multiple of the mesh size, the real
    windows first), runs the shared (chunk, tail) schedule on them into its
    own accumulators, and ``psum`` blends the partial maps before the
    divide: every rank ends with the whole map."""
    per = positions.shape[0] // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    prob, count = sliding_window_core_parts(volume, positions[mine], mask[mine], imp_map,
                                            apply_fn, patch_size, chunk, tail_chunk)
    psum(prob, mesh)
    psum(count, mesh)
    return _blend(prob, count)


def partition_positions_slab(positions: np.ndarray, n_dev: int, slab: int,
                             patch_batch: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Window origins bucketed by owning z-slab (owner = z // slab) into
    ``[n_dev, cap, 3]`` positions and a ``[n_dev, cap]`` validity mask, ``cap``
    the largest bucket rounded up to the chunk, so that every rank runs the
    same forward schedule."""
    owner = positions[:, 2] // slab
    buckets = [positions[owner == d] for d in range(n_dev)]
    cap = max(1, max(len(b) for b in buckets))
    chunk = choose_chunk(cap, patch_batch)
    cap = _round_up(cap, chunk)
    pos = np.zeros((n_dev, cap, 3), dtype=np.int32)
    msk = np.zeros((n_dev, cap), dtype=np.float32)
    for d, b in enumerate(buckets):
        pos[d, : len(b)] = b
        msk[d, : len(b)] = 1.0
    return pos, msk, chunk


def sliding_window_core_slab_sharded(vol, true_dims, vrange, positions, mask, post_mask=None, *,
                                     imp_map, apply_fn, patch_size, mesh: Mesh, chunk: int,
                                     slab: int, use_post_mask: bool, dequant: bool,
                                     quantize_out: bool) -> tuple:
    """The volume sharded in z-slabs over ``mesh`` (the port of the JAX
    engine's ``_slab_jit``): ``vol`` is this rank's ``[D, H, slab]`` slab
    (``post_mask`` likewise, unpacked), ``positions`` [n_dev, cap, 3] and
    ``mask`` [n_dev, cap] the ``partition_positions_slab`` buckets of every
    rank, on the device.

    One ``ppermute`` brings the right neighbour's first ``patch_z`` columns
    (the halo), the windows this rank owns run locally into a slab + halo
    accumulator, and a second pair of ``ppermute``s sends the part past the
    slab to the right neighbour, which adds it onto its head.  The wrap-around
    pairs are harmless: the last rank's windows end inside the volume, so
    its spill is zero, and no valid window reads the halo it receives.
    Returns (this rank's slab of the map,)."""
    n = mesh.size
    halo = int(patch_size[2])
    send_head_left = [(i, (i - 1) % n) for i in range(n)]
    send_spill_right = [(i, (i + 1) % n) for i in range(n)]
    zoff = mesh.rank * slab
    if dequant:
        vol = _dequant_volume(vol, true_dims, vrange[0], vrange[1], zoff)
    recv = ppermute(vol[:, :, :halo], mesh, send_head_left)
    vol_ext = torch.cat([vol, recv], dim=2)

    mine = mask[mesh.rank]
    pos = positions[mesh.rank]
    # global -> slab-local z origins; padding windows at the origin (weight 0)
    pos = torch.where(mine[:, None] > 0, torch.cat([pos[:, :2], pos[:, 2:] - zoff], dim=1), 0)
    prob, count = sliding_window_core_parts(vol_ext, pos, mine, imp_map, apply_fn,
                                            patch_size, chunk)
    spill_p = ppermute(prob[:, :, slab:], mesh, send_spill_right)
    spill_c = ppermute(count[:, :, slab:], mesh, send_spill_right)
    prob = prob[:, :, :slab].clone()
    count = count[:, :, :slab].clone()
    prob[:, :, :halo] += spill_p
    count[:, :, :halo] += spill_c
    out = _blend(prob, count)
    if use_post_mask:
        out = out * post_mask.float()
    return _finalize_output(out, quantize_out, 0, 8)


def _upload(a, device) -> torch.Tensor:
    """A host array (or CPU tensor) on ``device`` without blocking; counts
    ``upload.bytes``."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    tracing.count("upload.bytes", t.numel() * t.element_size())
    return t.to(device, non_blocking=True)


class SlabShards(NamedTuple):
    """A slab-mode dispatch result: this rank's z-slab of the padded map,
    still on the device, and the mesh it is sharded over."""

    out: torch.Tensor
    mesh: Mesh

    def gather(self) -> Optional[torch.Tensor]:
        """The padded map on the mesh's first rank (None elsewhere); every
        rank of the mesh must call it."""
        return gather_to_root(self.out, self.mesh, dim=2)


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
    with tracing.span("copy_start"):
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
    """A dispatch result on the host, padded shape, in its fetch dtype: the
    span ``fetch.sync`` (the prefetch's event, the tile count and the tile
    copies), then ``fetch.unpack`` for a packed result."""
    if not isinstance(out, HostPrefetch):
        return fetch_maybe_sparse(out)
    with tracing.span("fetch.sync"):
        out.done.synchronize()
        if not isinstance(out.out, SparsePack):
            return to_numpy(out.host)
        packed = out.out._replace(count=out.host)
        parts = host_parts(packed)
    return unpack_parts(parts, packed)


def host_map(out, shape) -> np.ndarray:
    """A dispatch result's map on the host, cropped to ``shape``, float32
    (a uint16 fetch dequantized: the span ``fetch.dequant``)."""
    host = fetch_host(out)[: shape[0], : shape[1], : shape[2]]
    if host.dtype == np.uint16:  # quantized fetch -> dequantize on the host
        with tracing.span("fetch.dequant"):
            host = host.astype(np.float32)
            host *= np.float32(1.0 / 65535.0)
    return host


class SlidingWindowInferencer:
    """Reusable sliding-window engine for one model, on one device or, with
    ``mesh``, on every rank of a mesh (patch-sharded, or slab-sharded with
    ``spatial_shard``)."""

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
        mesh: Optional[Mesh] = None,
        spatial_shard: bool = False,
        host_prefetch: bool = True,
        graphs: bool = True,
        ledger=None,
        use_gaussian: bool = True,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.patch_size = tuple(int(p) for p in patch_size)
        self.overlap = float(overlap)
        self.patch_batch = int(patch_batch)
        self.z_bucket = int(z_bucket)
        imp = (gaussian_importance_map(self.patch_size) if use_gaussian
               else np.ones(self.patch_size, np.float32))
        self.imp_map = torch.as_tensor(imp, device=self.device)
        self.quantize_in = str(transfer_dtype) == "uint16"
        self.quantize_out = str(fetch_dtype) == "uint16"
        self.sparse_fetch = bool(sparse_fetch)
        self.sparse_frac = float(sparse_fetch_frac)
        self.sparse_block = 8
        # callers that consume the map on the device (bbox-only serving, the
        # device validation sweep) turn this off: no copy rides the link
        self.host_prefetch = bool(host_prefetch)
        # a mesh of one rank is no mesh, and spatial_shard without one is a no-op
        self.n_devices = mesh_size(mesh)
        self.mesh = mesh if self.n_devices > 1 else None
        self.spatial_shard = bool(spatial_shard) and self.mesh is not None
        # on a card a volume's window is one CUDA graph replay per unit key
        # (over an NCCL mesh with its collectives; a gloo mesh and
        # ``graphs=False``, the eager reference, run the same unit eagerly)
        self.graphs = runner_for(self.device, graphs, "window", mesh=self.mesh, ledger=ledger)

    def prepare(self, volume: np.ndarray, post_mask: Optional[np.ndarray] = None):
        """Host-side prep of one case (patch grid, quantize/pad, mask pack) and
        the upload (of this rank's slab only, in slab mode); run it on a
        worker thread to overlap the previous case."""
        with tracing.span("prepare"):
            volume = np.asarray(volume, dtype=np.float32)
            if volume.ndim == 4 and volume.shape[0] == 1:
                volume = volume[0]
            if volume.ndim != 3:
                raise ValueError(f"expected 3D volume, got shape {volume.shape}")
            shape = volume.shape
            positions = compute_positions(shape, self.patch_size, self.overlap)
            n = positions.shape[0]
            pshape = bucketed_shape(shape, self.patch_size, self.z_bucket)

            slab = 0
            if self.spatial_shard:
                # z padded to a multiple of the ranks, with a slab at least one
                # patch wide so that one ppermute hop covers the halo
                pz = _round_up(pshape[2], self.n_devices)
                if pz // self.n_devices >= self.patch_size[2]:
                    pshape = (pshape[0], pshape[1], pz)
                    slab = pz // self.n_devices
                else:
                    import warnings

                    warnings.warn(
                        f"spatial_shard: padded z extent {pz} gives slab "
                        f"{pz // self.n_devices} < patch {self.patch_size[2]} on "
                        f"{self.n_devices} devices; falling back to the "
                        f"patch-sharded path",
                        stacklevel=2,
                    )
            if slab:
                pos_padded, weights, chunk = partition_positions_slab(
                    positions, self.n_devices, slab, self.patch_batch)
                tail = 0
            else:
                # every rank runs the same (chunk, tail) schedule on its share
                per_dev = -(-max(n, 1) // self.n_devices)
                chunk, tail, per_dev_pad = choose_chunks(per_dev, self.patch_batch)
                pos_padded = np.zeros((per_dev_pad * self.n_devices, 3), dtype=np.int32)
                pos_padded[:n] = positions
                weights = np.zeros(len(pos_padded), np.float32)
                weights[:n] = 1.0

            region = (slice(0, shape[0]), slice(0, shape[1]), slice(0, shape[2]))
            vlo = vhi = 0.0
            with tracing.span("prepare.quantize"):
                if self.quantize_in:
                    vol_padded = np.zeros(pshape, dtype=np.uint16)
                    vlo, vhi = quantize_u16(volume, vol_padded, region)
                    vol_padded = vol_padded.view(np.int16)
                else:
                    vol_padded = np.zeros(pshape, dtype=np.float32)
                    vol_padded[region] = volume
            mine = slice(None)
            if slab:
                mine = slice(self.mesh.rank * slab, (self.mesh.rank + 1) * slab)
                vol_padded = np.ascontiguousarray(vol_padded[:, :, mine])

            pm = None
            mask_packed = False
            if post_mask is not None:
                pm = np.zeros(pshape, dtype=np.uint8)
                pm[region] = np.asarray(post_mask) > 0
                # bit-pack along the last axis when it is byte-aligned; a slab
                # stays unpacked (a slab boundary could split a byte)
                if pshape[2] % 8 == 0 and not slab:
                    pm = np.packbits(pm, axis=2, bitorder="little")
                    mask_packed = True
                pm = pm[:, :, mine]
            # what differs per volume goes up as device data, which the unit's
            # graph reads from its static buffers
            up = functools.partial(_upload, device=self.device)
            with tracing.span("prepare.upload"):
                return {
                    "volume": up(vol_padded), "shape": shape,
                    "dims": up(np.asarray(shape, np.int32)),
                    "vrange": up(np.asarray([vlo, vhi], np.float32)),
                    "positions": up(pos_padded.astype(np.int64)), "weights": up(weights),
                    "chunks": (chunk, tail), "post_mask": None if pm is None else up(pm),
                    "mask_packed": mask_packed, "slab": slab,
                }

    def sparse_cap(self, padded_shape) -> int:
        """The block-sparse fetch's tile capacity (0: a dense fetch)."""
        return block_cap(padded_shape, self.sparse_block, self.sparse_frac) if self.sparse_fetch else 0

    def unit(self, prep: dict) -> tuple:
        """(key, function, inputs) of one ``prepare()``d case's unit: the
        single-device window, the patch-sharded one or this rank's slab.  The
        key is the JAX program's static arguments (``_sliding_window_jit``,
        ``_sharded_jit``, ``_slab_jit``) by name."""
        chunk, tail = prep["chunks"]
        use_post_mask = prep["post_mask"] is not None
        inputs = (prep["volume"], prep["dims"], prep["vrange"], prep["positions"],
                  prep["weights"]) + ((prep["post_mask"],) if use_post_mask else ())
        common = dict(imp_map=self.imp_map, apply_fn=self.apply_fn, patch_size=self.patch_size)
        if prep["slab"]:
            static = dict(chunk=chunk, slab=prep["slab"], use_post_mask=use_post_mask,
                          dequant=self.quantize_in, quantize_out=self.quantize_out)
            fn = functools.partial(sliding_window_core_slab_sharded, mesh=self.mesh, **common,
                                   **static)
            return unit_key("slab", self.apply_fn, **static), fn, inputs
        cap = self.sparse_cap(prep["volume"].shape)
        static = dict(chunk=chunk, tail_chunk=tail, use_post_mask=use_post_mask,
                      dequant=self.quantize_in, quantize_out=self.quantize_out, sparse_cap=cap,
                      sparse_block=self.sparse_block, mask_packed=prep["mask_packed"])
        fn = functools.partial(window_unit, mesh=self.mesh, **common, **static)
        return unit_key("window" if self.mesh is None else "sharded", self.apply_fn,
                        **static), fn, inputs

    @torch.no_grad()
    def dispatch(self, prep: dict):
        """Run the device computation for one ``prepare()``d case (one graph
        replay on a card, no host sync); returns (out, orig_shape) where
        ``out`` is the padded map (or a SparsePack) still on the device, or
        in slab mode a ``SlabShards``."""
        with tracing.span("dispatch"):
            key, fn, inputs = self.unit(prep)
            parts = run_unit(self.graphs, key, fn, *inputs)
            if prep["slab"]:
                return SlabShards(parts[0], self.mesh), prep["shape"]
            out = as_result(parts, self.sparse_cap(prep["volume"].shape), self.sparse_block)
            # on a mesh every rank holds the map; the first one fetches it
            fetches = self.mesh is None or self.mesh.is_root
            if self.host_prefetch and fetches and self.device.type == "cuda":
                out = start_host_copy(out)
            return out, prep["shape"]

    @staticmethod
    def fetch(dispatched) -> Optional[np.ndarray]:
        """The map on the host, cropped to the volume; in slab mode every
        rank must call it, and the mesh's first rank gets the map (None
        elsewhere)."""
        out, shape = dispatched
        with tracing.span("fetch"):
            if isinstance(out, SlabShards):
                out = out.gather()
                if out is None:
                    return None
            return host_map(out, shape)

    def __call__(self, volume: np.ndarray, post_mask: Optional[np.ndarray] = None):
        """volume [D, H, W] -> probability map [D, H, W] float32 on the host."""
        return self.fetch(self.dispatch(self.prepare(volume, post_mask)))


def sliding_window_inference_3d(volume: np.ndarray, apply_fn: Callable,
                                patch_size: Sequence[int] = (48, 48, 48), overlap: float = 0.5,
                                use_gaussian: bool = True, patch_batch: int = 32,
                                z_bucket: int = 48, device="cuda") -> np.ndarray:
    """One-shot convenience wrapper (the JAX package's, whose ``params`` the
    port's ``apply_fn`` holds itself)."""
    runner = SlidingWindowInferencer(apply_fn, patch_size, overlap, patch_batch, z_bucket,
                                     use_gaussian=use_gaussian, device=device)
    return runner(volume)
