"""Block-sparse device->host fetch of probability maps (port of
``light_unet_tpu/ops/sparse_fetch.py``).

A body-masked probability map is exactly zero outside the dilated body, so
the device packs the occupied ``block``^3 tiles and only those (plus their
indices and a count) are copied to the host, which scatters them back.  The
result is bit-identical to fetching the dense map; when more than ``cap``
tiles are occupied the overflow is detected exactly and the dense map, which
stayed on the device, is fetched instead.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.utils import tracing


class SparsePack(NamedTuple):
    """Block-sparse dispatch result: ``dense`` stays on the device (fetched
    only on capacity overflow); ``count`` is the exact occupied-tile count,
    ``idx``/``tiles`` the packed tiles."""

    dense: Any
    count: Any
    idx: Any
    tiles: Any
    cap: int
    block: int


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def slice_bucket(n: int, cap: int) -> int:
    """Round ``n`` up to a 64-aligned geometric (~1.5x) bucket, capped at ``cap``."""
    b = 64
    while b < n:
        b = _ceil_div(b * 3 // 2, 64) * 64
    return min(b, cap)


def block_grid(padded_shape: Sequence[int], block: int) -> Tuple[int, int, int]:
    """Tile counts per axis for a volume of ``padded_shape``."""
    return tuple(_ceil_div(int(s), block) for s in padded_shape)  # type: ignore[return-value]


def block_cap(padded_shape: Sequence[int], block: int, frac: float) -> int:
    """Static tile capacity: ``frac`` of the grid, rounded up to 64 tiles."""
    nb = int(np.prod(block_grid(padded_shape, block)))
    cap = _ceil_div(max(1, int(np.ceil(nb * float(frac)))), 64) * 64
    return min(cap, nb)


def sized_nonzero(flags: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(flags, size=size, fill_value=len(flags))[0]`` of a 1-D
    bool tensor, without reading the count on the host: the ascending indices
    of the first ``size`` set flags, then ``len(flags)`` in every slot left.
    The k-th set flag is where the running count first reaches k + 1."""
    running = torch.cumsum(flags, 0)
    want = torch.arange(1, size + 1, dtype=running.dtype, device=flags.device)
    return torch.searchsorted(running, want)


def pack_blocks(vol: torch.Tensor, block: int, cap: int):
    """Pack occupied ``block``^3 tiles of ``vol`` [D, H, W].

    Returns ``(count, idx [cap], tiles [cap, block^3])``: ``count`` is a 0-d
    int32 tensor that may exceed ``cap`` (the overflow signal); ``idx`` slots
    beyond ``count`` hold ``nb`` (out of range) and their tiles are zero.
    No host sync: the indices are a sized compaction (``sized_nonzero``)."""
    d, h, w = vol.shape
    nd, nh, nw = block_grid(vol.shape, block)
    pad = (0, nw * block - w, 0, nh * block - h, 0, nd * block - d)
    if any(pad):
        vol = torch.nn.functional.pad(vol, pad)  # zero pad: never occupied
    nb = nd * nh * nw
    tiles = (
        vol.reshape(nd, block, nh, block, nw, block)
        .permute(0, 2, 4, 1, 3, 5)
        .reshape(nb, block ** 3)
    )
    occupied = (tiles != 0).any(dim=1)
    count = occupied.sum(dtype=torch.int32)
    idx = sized_nonzero(occupied, cap)
    tiles_all = torch.cat([tiles, tiles.new_zeros((1, tiles.shape[1]))])
    return count, idx.to(torch.int32), tiles_all[idx]


def unpack_blocks(idx: np.ndarray, tiles: np.ndarray, padded_shape: Sequence[int],
                  block: int) -> np.ndarray:
    """Host: scatter packed tiles back into a dense [padded_shape] volume
    (exact inverse of ``pack_blocks`` when ``count <= cap``)."""
    idx = np.asarray(idx)
    tiles = np.asarray(tiles)
    nd, nh, nw = block_grid(padded_shape, block)
    nb = nd * nh * nw
    flat = np.zeros((nb, block * block * block), tiles.dtype)
    valid = idx < nb
    flat[idx[valid]] = tiles[valid]
    vol = (
        flat.reshape(nd, nh, nw, block, block, block)
        .transpose(0, 3, 1, 4, 2, 5)
        .reshape(nd * block, nh * block, nw * block)
    )
    return vol[: padded_shape[0], : padded_shape[1], : padded_shape[2]]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy; int16 tensors carry uint16 bits (see ``sliding_window.quantize_out``).
    Counts ``fetch.bytes``."""
    a = t.cpu().numpy()
    tracing.count("fetch.bytes", a.nbytes)
    return a.view(np.uint16) if a.dtype == np.int16 else a


def host_parts(out):
    """A dispatch result's bytes on the host: the dense map, or for a
    SparsePack within its cap the occupied bucket's ``(idx, tiles)``."""
    if isinstance(out, SparsePack):
        n = int(out.count)
        if n > out.cap:
            return to_numpy(out.dense)  # exact overflow -> dense fallback
        b = slice_bucket(n, out.cap)
        return to_numpy(out.idx[:b]), to_numpy(out.tiles[:b])
    return to_numpy(out)


def unpack_parts(parts, out) -> np.ndarray:
    """The dense map of ``host_parts(out)`` (span ``fetch.unpack`` when packed)."""
    if not isinstance(parts, tuple):
        return parts
    with tracing.span("fetch.unpack"):
        return unpack_blocks(*parts, out.dense.shape, out.block)


def fetch_maybe_sparse(out) -> np.ndarray:
    """Materialize a dispatch result (dense tensor or SparsePack) on the host —
    bit-identical either way.  The copies are the span ``fetch.sync``."""
    with tracing.span("fetch.sync"):
        parts = host_parts(out)
    return unpack_parts(parts, out)
