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

On one device of a card each chunk's forward is one CUDA graph replay
(``forward_graphs``, a ``utils/graphs.py:GraphRunner``), keyed by chunk
shape, compute dtype and route (``fused_block``, ``use_pallas``, plain):
``choose_chunks`` makes powers of two from 8 to ``patch_batch``, so a
handful of keys.  The gather, the ordered scatter-add and the rest stay
eager: the positions follow each volume's true shape.  The sharded windows
run eagerly.  ``graphs=False`` runs every forward eagerly (the reference
path); the CPU has no graphs.
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
    pack_blocks,
    to_numpy,
)
from light_unet_tpu_torch.utils.device import resolve_device
from light_unet_tpu_torch.utils.graphs import runner_for


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
    device; ``zoff`` is the global z of the first column (a z-slab)."""
    offs = (0, 0, zoff)
    axes = [torch.arange(s, device=device) + o < int(t)
            for s, t, o in zip(shape, true_dims, offs)]
    return (axes[0][:, None, None] & axes[1][None, :, None] & axes[2][None, None, :]).float()


def _dequant_volume(volume: torch.Tensor, true_dims, vlo: float, vhi: float,
                    zoff: int = 0) -> torch.Tensor:
    """Invert ``quantize_u16`` in float32 and re-zero the bucket padding."""
    lo, hi = np.float32(vlo), np.float32(vhi)
    v = _u16_to_f32(volume) * ((hi - lo) / np.float32(65535.0)) + lo
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


def _finalize_output(out, quantize: bool, sparse_cap: int, sparse_block: int):
    if quantize:
        out = quantize_out(out)
    if sparse_cap > 0:
        return SparsePack(out, *pack_blocks(out, sparse_block, sparse_cap),
                          cap=sparse_cap, block=sparse_block)
    return out


def chunk_forward(apply_fn, chunk: torch.Tensor) -> torch.Tensor:
    """The network on a [n, pd, ph, pw] chunk of patches: float32
    probabilities of the same shape (the unit a graph captures)."""
    return apply_fn(chunk[..., None])[..., 0].float()


def chunk_key(apply_fn, chunk: torch.Tensor) -> tuple:
    """A chunk forward's graph key: the chunk's shape and dtype, the route
    and compute dtype of ``apply_fn`` (a ``models.unet3d.Lightweight3DUNet`` or
    ``make_fused_apply``'s function), the float32 convolutions' TF32 flag
    and the function itself."""
    return ("chunk", tuple(chunk.shape), chunk.dtype, getattr(apply_fn, "route", None),
            getattr(apply_fn, "compute_dtype", None), torch.backends.cudnn.allow_tf32,
            id(apply_fn))


def sliding_window_core_parts(volume, positions: np.ndarray, n_real: int, imp_map, apply_fn,
                              patch_size, chunk: int, tail_chunk: int = 0, forward_graphs=None):
    """Raw (prob, count) accumulators: gather -> chunked forward -> scatter-add.

    ``positions`` is the padded [n_pad, 3] host array; its first ``n_real``
    rows are real windows.  Padding windows run through the forward (so the
    chunk schedule is the JAX package's) but carry zero weight, so they are
    not added.  With ``forward_graphs`` (a ``GraphRunner``) each chunk's
    forward is one graph replay."""
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

    fwd = functools.partial(chunk_forward, apply_fn)
    n_main = n - tail_chunk
    starts = [(i, chunk) for i in range(0, n_main, chunk)]
    if tail_chunk:
        starts.append((n_main, tail_chunk))
    preds = torch.empty(patches.shape, dtype=torch.float32, device=dev)
    for i, size in starts:
        c = patches[i:i + size]
        if forward_graphs is None:
            preds[i:i + size] = fwd(c)
        else:  # copied out before the next replay overwrites the output
            preds[i:i + size] = forward_graphs(chunk_key(apply_fn, c), fwd, c)[0]
    weighted = preds * imp_map[None]

    prob = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    count = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    for i, (z, y, x) in enumerate(positions[:n_real].tolist()):
        prob[z:z + pd, y:y + ph, x:x + pw] += weighted[i]
        count[z:z + pd, y:y + ph, x:x + pw] += imp_map
    return prob, count


def sliding_window_core(volume, positions, n_real, imp_map, apply_fn, patch_size, chunk,
                        tail_chunk: int = 0, forward_graphs=None):
    """Blended probability map of a zero-padded [Dp, Hp, Wp] volume."""
    prob, count = sliding_window_core_parts(
        volume, positions, n_real, imp_map, apply_fn, patch_size, chunk, tail_chunk,
        forward_graphs)
    return torch.where(count > 0, prob / torch.where(count > 0, count, 1.0), prob)


def sliding_window_core_sharded(volume, positions: np.ndarray, n_real: int, imp_map, apply_fn,
                                patch_size, chunk: int, mesh: Mesh, tail_chunk: int = 0):
    """The patch axis sharded over ``mesh``: rank r takes rows
    ``[r * per, (r + 1) * per)`` of the padded [n_pad, 3] window list
    (``n_pad`` a multiple of the mesh size, the real windows first), runs
    the shared (chunk, tail) schedule on them into its own accumulators,
    and ``psum`` blends the partial maps before the divide: every rank
    ends with the whole map."""
    per = positions.shape[0] // mesh.size
    lo = mesh.rank * per
    n_mine = min(max(n_real - lo, 0), per)
    prob, count = sliding_window_core_parts(volume, positions[lo:lo + per], n_mine, imp_map,
                                            apply_fn, patch_size, chunk, tail_chunk)
    psum(prob, mesh)
    psum(count, mesh)
    return torch.where(count > 0, prob / torch.where(count > 0, count, 1.0), prob)


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


def sliding_window_core_slab_sharded(vol, true_dims, vlo: float, vhi: float, positions: np.ndarray,
                                     mask: np.ndarray, imp_map, post_mask, apply_fn, patch_size,
                                     chunk: int, mesh: Mesh, *, slab: int, dequant: bool,
                                     use_post_mask: bool, quantize: bool):
    """The volume sharded in z-slabs over ``mesh``: ``vol`` is this rank's
    ``[D, H, slab]`` slab (``post_mask`` likewise, unpacked), ``positions`` /
    ``mask`` the ``partition_positions_slab`` buckets of every rank.

    One ``ppermute`` brings the right neighbour's first ``patch_z`` columns
    (the halo), the windows this rank owns run locally into a slab + halo
    accumulator, and a second pair of ``ppermute``s sends the part past the
    slab to the right neighbour, which adds it onto its head.  The wrap-around
    pairs are harmless: the last rank's windows end inside the volume, so
    its spill is zero, and no valid window reads the halo it receives.
    Returns this rank's slab of the map."""
    n = mesh.size
    halo = int(patch_size[2])
    send_head_left = [(i, (i - 1) % n) for i in range(n)]
    send_spill_right = [(i, (i + 1) % n) for i in range(n)]
    zoff = mesh.rank * slab
    if dequant:
        vol = _dequant_volume(vol, true_dims, vlo, vhi, zoff)
    recv = ppermute(vol[:, :, :halo], mesh, send_head_left)
    vol_ext = torch.cat([vol, recv], dim=2)

    n_mine = int(mask[mesh.rank].sum())
    pos = positions[mesh.rank].copy()
    pos[:n_mine, 2] -= zoff  # global -> slab-local z origins
    pos[n_mine:] = 0  # padding windows: any in-bounds origin (their weight is 0)
    prob, count = sliding_window_core_parts(vol_ext, pos, n_mine, imp_map, apply_fn,
                                            patch_size, chunk)
    spill_p = ppermute(prob[:, :, slab:], mesh, send_spill_right)
    spill_c = ppermute(count[:, :, slab:], mesh, send_spill_right)
    prob = prob[:, :, :slab].clone()
    count = count[:, :, :slab].clone()
    prob[:, :, :halo] += spill_p
    count[:, :, :halo] += spill_c
    out = torch.where(count > 0, prob / torch.where(count > 0, count, 1.0), prob)
    if use_post_mask:
        out = out * post_mask.float()
    return quantize_out(out) if quantize else out


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
        device="cuda",
    ):
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
        # a mesh of one rank is no mesh, and spatial_shard without one is a no-op
        self.n_devices = mesh_size(mesh)
        self.mesh = mesh if self.n_devices > 1 else None
        self.spatial_shard = bool(spatial_shard) and self.mesh is not None
        # one device: each chunk's forward is a CUDA graph replay (the
        # sharded windows run eagerly); ``graphs=False`` is the eager reference
        self.forward_graphs = None if self.mesh is not None else runner_for(
            self.device, graphs, "window", ledger=ledger)

    def prepare(self, volume: np.ndarray, post_mask: Optional[np.ndarray] = None):
        """Host-side prep of one case (patch grid, quantize/pad, mask pack) and
        the upload (of this rank's slab only, in slab mode); run it on a
        worker thread to overlap the previous case."""
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
        mask = None
        if slab:
            pos_padded, mask, chunk = partition_positions_slab(
                positions, self.n_devices, slab, self.patch_batch)
            tail = 0
        else:
            # every rank runs the same (chunk, tail) schedule on its share
            per_dev = -(-max(n, 1) // self.n_devices)
            chunk, tail, per_dev_pad = choose_chunks(per_dev, self.patch_batch)
            pos_padded = np.zeros((per_dev_pad * self.n_devices, 3), dtype=np.int32)
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
            pm = torch.from_numpy(np.ascontiguousarray(pm[:, :, mine])).to(
                self.device, non_blocking=True)
        return {
            "volume": torch.from_numpy(vol_padded).to(self.device, non_blocking=True),
            "shape": shape, "vlo": vlo, "vhi": vhi, "positions": pos_padded, "n_real": n,
            "chunks": (chunk, tail), "post_mask": pm, "mask_packed": mask_packed,
            "slab": slab, "slab_mask": mask,
        }

    @torch.no_grad()
    def dispatch(self, prep: dict):
        """Run the device computation for one ``prepare()``d case; returns
        (out, orig_shape) where ``out`` is the padded map (or a SparsePack)
        still on the device, or in slab mode a ``SlabShards``."""
        vol = prep["volume"]
        chunk, tail = prep["chunks"]
        if prep["slab"]:
            out = sliding_window_core_slab_sharded(
                vol, prep["shape"], prep["vlo"], prep["vhi"], prep["positions"],
                prep["slab_mask"], self.imp_map, prep["post_mask"], self.apply_fn,
                self.patch_size, chunk, self.mesh, slab=prep["slab"], dequant=self.quantize_in,
                use_post_mask=prep["post_mask"] is not None, quantize=self.quantize_out)
            return SlabShards(out, self.mesh), prep["shape"]
        if self.quantize_in:
            vol = _dequant_volume(vol, prep["shape"], prep["vlo"], prep["vhi"])
        if self.mesh is not None:
            out = sliding_window_core_sharded(vol, prep["positions"], prep["n_real"], self.imp_map,
                                              self.apply_fn, self.patch_size, chunk, self.mesh,
                                              tail)
        else:
            out = sliding_window_core(vol, prep["positions"], prep["n_real"], self.imp_map,
                                      self.apply_fn, self.patch_size, chunk, tail,
                                      self.forward_graphs)
        if prep["post_mask"] is not None:
            out = _apply_post_mask(out, prep["post_mask"], prep["mask_packed"])
        cap = block_cap(vol.shape, self.sparse_block, self.sparse_frac) if self.sparse_fetch else 0
        out = _finalize_output(out, self.quantize_out, cap, self.sparse_block)
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
        if isinstance(out, SlabShards):
            out = out.gather()
            if out is None:
                return None
        host = fetch_host(out)[: shape[0], : shape[1], : shape[2]]
        if host.dtype == np.uint16:  # quantized fetch -> dequantize on the host
            host = host.astype(np.float32)
            host *= np.float32(1.0 / 65535.0)
        return host
