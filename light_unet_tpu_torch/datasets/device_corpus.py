"""Device-resident training corpus: patches are gathered on the device (port
of ``light_unet_tpu/datasets/device_corpus.py``).

The training volumes are uploaded once, uint16-quantized with the host
loader's mapping, and stay resident; each step the host sends a ``[B, 4]``
corner array (case row + patch corner) and ``gather_patches`` cuts the
patch batch out of the stacks in one indexing kernel.

Exactness: ``quantize_u16_01`` is the loader's ``_quantize_batch`` mapping
and ``corner_for`` is the sampler's border clamp, so a gathered batch is
bit-identical to the host-quantized batch for the same draws.  Volumes are
padded to one bucket shape whose margin keeps every clamped corner inside
it: border patches read genuine zero padding, like the host's ``np.pad``.
A corpus over ``budget_gb`` falls back to host streaming, all or nothing.

The uint16 image stack is held as int16 with the same bits (the port's
convention for uint16 on the device).

On a mesh (``parallel/mesh.py``) the corpus is either replicated (every rank
builds the same stacks from the same files; nothing is broadcast) or, with
``shard=True`` (``tpu.shard_corpus``), case-sharded: the rows are padded to
a multiple of the ranks with all-zero rows (no sampler draws
them), rank r holds rows ``[r * N/D, (r + 1) * N/D)``, and the budget is per
rank.  ``gather_patches_sharded`` then takes the whole corner batch on every
rank, gathers the patches whose rows it holds (the others exactly zero),
and one reduce-scatter sums the partials and leaves each rank its rows of
the batch.  Each case lives on one rank, so the sum is exact; the image
stack is reduced as its uint8 byte view (NCCL has no 16-bit integer sum),
which is exact for the same reason.  The result is bit-identical to
``gather_patches`` on a replicated corpus.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.datasets.volume_cache import VolumeCache
from light_unet_tpu_torch.parallel.collectives import psum_scatter
from light_unet_tpu_torch.parallel.mesh import Mesh, mesh_size
from light_unet_tpu_torch.utils.device import resolve_device


def corpus_bucket_shape(
    shapes: Sequence[Tuple[int, int, int]], patch_size: Sequence[int], z_bucket: int = 8
) -> Tuple[int, int, int]:
    """Common padded shape: per axis ``max(patch, max_dim + patch - patch//2 - 1)``
    (so ``corner + patch <= bucket`` for every clamped corner), the last
    axis rounded up to ``z_bucket``."""
    out = []
    for axis in range(3):
        p = int(patch_size[axis])
        m = max(int(s[axis]) for s in shapes)
        out.append(max(p, m + p - p // 2 - 1))
    out[2] = ((out[2] + z_bucket - 1) // z_bucket) * z_bucket
    return tuple(out)  # type: ignore[return-value]


def quantize_u16_01(volume: np.ndarray, out: np.ndarray) -> None:
    """[0,1]-range uint16 quantization, bit-identical to the loader's batch
    quantization; zeros stay exactly zero."""
    q = np.clip(volume, 0.0, 1.0)
    q = q * np.float32(65535.0)
    q += np.float32(0.5)  # round-to-nearest under the truncating cast
    out[...] = q.astype(np.uint16)


class DeviceCorpus:
    """Device-resident (images, labels) stacks + per-case true shapes.

    ``images``: [N, Db, Hb, Wb] int16 holding uint16 levels of [0,1]
    ``labels``: [N, Db, Hb, Wb] uint8 (binary)
    """

    def __init__(self, images, labels, shapes: np.ndarray, case_keys: List[str],
                 sharded: bool = False):
        self.images = images            # this rank's rows when sharded
        self.labels = labels
        self.shapes = shapes            # [N, 3] int32 true extents (host)
        self.case_keys = case_keys      # image paths, for identity checks
        self.n_cases = len(case_keys)
        self.sharded = sharded          # case axis sharded over the mesh
        self.per_chip_bytes = (images.numel() * images.element_size()
                               + labels.numel() * labels.element_size())

    @classmethod
    def estimate_bytes(cls, shapes, patch_size, z_bucket: int = 8) -> int:
        db, hb, wb = corpus_bucket_shape(shapes, patch_size, z_bucket)
        return len(shapes) * db * hb * wb * 3  # uint16 + uint8

    @classmethod
    def build(cls, cases, cache: Optional[VolumeCache], patch_size: Sequence[int],
              budget_gb: float = 6.0, z_bucket: int = 8, evict: bool = False,
              device="cuda", mesh: Optional[Mesh] = None,
              shard: bool = False) -> Optional["DeviceCorpus"]:
        """Decode (through the cache), quantize, stack and upload.

        Returns None (host streaming) when the bytes per rank exceed
        ``budget_gb`` or there are no cases.  With ``evict`` each case's
        float32 volumes leave the cache as soon as they are quantized into
        the stack.  With ``shard`` and a mesh of several ranks, this rank
        stacks and uploads only its rows."""
        device = resolve_device(device)
        if not cases:
            return None
        n_dev = mesh_size(mesh) if shard else 1
        shard = n_dev > 1
        cache = cache if cache is not None else VolumeCache()
        shapes = [tuple(int(s) for s in cache.get(case.label_path).shape) for case in cases]
        est = cls.estimate_bytes(shapes, patch_size, z_bucket)
        n = len(cases)
        rows = -(-n // n_dev)  # rows per rank: N padded to a mesh multiple
        per_chip = (est // n) * rows if shard else est
        if per_chip > budget_gb * (1 << 30):
            print(
                f"device_corpus: corpus needs {per_chip / (1 << 30):.2f} GB/chip "
                f"(> budget {budget_gb:.2f} GB) - streaming batches from host "
                f"instead. Raise tpu.device_corpus_budget_gb to force it"
                + ("." if shard else " or shard it with tpu.shard_corpus.")
            )
            return None

        bucket = corpus_bucket_shape(shapes, patch_size, z_bucket)
        lo = mesh.rank * rows if shard else 0
        n_rows = rows if shard else n
        img_stack = np.zeros((n_rows, *bucket), dtype=np.uint16)
        lbl_stack = np.zeros((n_rows, *bucket), dtype=np.uint8)
        keys = []
        for i, case in enumerate(cases):
            keys.append(str(case.image_path))
            if lo <= i < lo + n_rows:
                img = cache.get(case.image_path)
                lbl = cache.get(case.label_path)
                region = tuple(slice(0, s) for s in img.shape)
                quantize_u16_01(img, img_stack[(i - lo, *region)])
                lbl_stack[(i - lo, *region)] = lbl > 0.5
                del img, lbl
            if evict:
                cache.drop((case.image_path, case.label_path))
        # one stack at a time: the host copy goes before the next upload
        img_dev = torch.from_numpy(img_stack.view(np.int16)).to(device)
        del img_stack
        lbl_dev = torch.from_numpy(lbl_stack).to(device)
        del lbl_stack
        corpus = cls(img_dev, lbl_dev, np.asarray(shapes, np.int32), keys, sharded=shard)
        print(f"device_corpus: {n} cases resident on {device} "
              f"({est / (1 << 20):.0f} MB as uint16+uint8, bucket {bucket}"
              + (f", case-sharded over {n_dev} ranks at "
                 f"{corpus.per_chip_bytes / (1 << 20):.0f} MB/rank)" if shard else ")"))
        return corpus


def gather_patches(corpus_img: torch.Tensor, corpus_lbl: torch.Tensor, corners: torch.Tensor,
                   patch_size) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, 4] (case, z0, y0, x0) on the stacks' device -> ([B, *patch, 1]
    int16 uint16-bits, [B, *patch, 1] uint8), one indexing gather each."""
    c = corners.long()
    ar = [torch.arange(int(p), device=c.device) for p in patch_size]
    idx = (c[:, 0, None, None, None],
           (c[:, 1, None] + ar[0])[:, :, None, None],
           (c[:, 2, None] + ar[1])[:, None, :, None],
           (c[:, 3, None] + ar[2])[:, None, None, :])
    return corpus_img[idx][..., None], corpus_lbl[idx][..., None]


def gather_patches_sharded(corpus_img: torch.Tensor, corpus_lbl: torch.Tensor,
                           corners: torch.Tensor, patch_size, mesh: Mesh):
    """Corner-routing gather for a case-sharded corpus: ``corners`` is the
    whole [B, 4] batch (the same on every rank), the stacks are this rank's
    rows; returns this rank's [B/D, *patch, 1] rows of the batch, equal bit
    for bit to ``gather_patches`` on the whole corpus."""
    rows = corpus_img.shape[0]
    c = corners.long()
    local = c[:, 0] - mesh.rank * rows
    is_local = (local >= 0) & (local < rows)
    c = torch.cat([torch.where(is_local, local, torch.zeros_like(local))[:, None], c[:, 1:]], 1)
    imgs, lbls = gather_patches(corpus_img, corpus_lbl, c, patch_size)
    keep = is_local.reshape(-1, *([1] * (imgs.ndim - 1)))
    imgs = torch.where(keep, imgs, torch.zeros((), dtype=imgs.dtype, device=imgs.device))
    lbls = torch.where(keep, lbls, torch.zeros((), dtype=lbls.dtype, device=lbls.device))
    # one contributor per element: the byte-wise sum is exact
    imgs = psum_scatter(imgs.contiguous().view(torch.uint8), mesh).view(torch.int16)
    return imgs, psum_scatter(lbls.contiguous(), mesh)


class CornerLoader:
    """Epoch iterable of [B, 4] int32 corner arrays (device-corpus mode), with
    ``PrefetchLoader``'s length (``len(sampler) // batch_size``)."""

    def __init__(self, sampler, corpus: DeviceCorpus, batch_size: int, case_offset_of=None):
        self.sampler = sampler
        self.corpus = corpus
        self.batch_size = int(batch_size)
        # (sub-sampler id, case idx) -> corpus row; identity for one sampler
        self._offset = case_offset_of or (lambda which, idx: idx)

    def __len__(self) -> int:
        return max(1, len(self.sampler) // self.batch_size)

    def __iter__(self):
        for _ in range(len(self)):
            yield self.sample_corners()

    def sample_corners(self) -> np.ndarray:
        out = np.empty((self.batch_size, 4), np.int32)
        for b in range(self.batch_size):
            which, case_idx, center = self.sampler.draw_index()
            out[b, 0] = self._offset(which, case_idx)
            out[b, 1:] = corner_for(center, self.sampler.patch_size)
        return out


def corner_for(center, patch_size) -> Tuple[int, int, int]:
    """The sampler's border clamp: corner = max(0, center - patch//2); voxels
    past the true extent are zeros (host ``np.pad``, corpus padding)."""
    return tuple(max(0, int(c) - int(p) // 2) for c, p in zip(center, patch_size))
