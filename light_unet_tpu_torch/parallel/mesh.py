"""The data-parallel mesh (port of ``light_unet_tpu/parallel/mesh.py:22-127``).

The JAX package drives every device of a host from one controller; the
torch idiom is one process per GPU, so a mesh here is a small object: the
ranks of the process group it spans, this process's index among them, its
device and the data axis name.  Data parallelism keeps the JAX package's
rules: batches split along their leading axis (``shard_batch``; the batch
axis of a ``[K, B, 4]`` chain for ``shard_chain``), parameters replicated
(``replicate``: broadcast from the mesh's first rank; the trainer builds
them alike on every rank and only checks that they agree, ``check_same``),
and the gradients summed across ranks.

``mesh_from_config`` takes JAX's rules and warnings: a ``mesh_shape`` larger
than the world raises ``ValueError``, a smaller one warns; without
``batch_per_device`` the mesh shrinks to the largest rank count dividing
the global batch (and warns); with it every rank carries
``batch_size`` rows.  A rank a mesh leaves out idles at the run-end barrier
(``parallel/distributed.py:park``), so it never holds the others up.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from light_unet_tpu_torch.parallel.distributed import is_distributed_initialized, live_ranks, park


@dataclass(frozen=True)
class Mesh:
    """A 1-D data-parallel mesh: ``ranks`` (world ranks, in mesh order),
    ``rank`` (this process's index among them), ``device``, ``data_axis``
    and ``group`` (the process group; ``None`` is the default group)."""

    ranks: Tuple[int, ...]
    rank: int
    device: torch.device
    data_axis: str = "data"
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def backend(self) -> str:
        return str(dist.get_backend(self.group))

    @property
    def is_root(self) -> bool:
        return self.rank == 0


def mesh_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.size


def _mesh_over(ranks: Sequence[int], data_axis: str, device) -> Mesh:
    """The mesh of ``ranks`` (a prefix of the live ranks); the live ranks
    outside it are parked."""
    ranks = tuple(int(r) for r in ranks)
    live = live_ranks()
    device = torch.device(device)
    if not is_distributed_initialized():
        return Mesh(ranks, 0, device, data_axis)
    park([r for r in live if r not in ranks])
    group = None
    if len(ranks) < dist.get_world_size():
        # members only: the parked ranks never call in
        group = dist.new_group(list(ranks), use_local_synchronization=True)
    return Mesh(ranks, ranks.index(dist.get_rank()), device, data_axis, group)


def create_mesh(data_axis: str = "data", ranks: Optional[Sequence[int]] = None,
                mesh_shape: Optional[Sequence[int]] = None, device="cuda") -> Mesh:
    """1-D mesh over all live (or the given) ranks on the data axis."""
    ranks = list(live_ranks() if ranks is None else ranks)
    if mesh_shape is not None:
        want = int(np.prod(mesh_shape))
        if want > len(ranks):
            raise ValueError(f"mesh_shape {mesh_shape} needs {want} devices, have {len(ranks)}")
        if want < len(ranks):
            warnings.warn(
                f"mesh_shape {tuple(mesh_shape)} uses only {want} of "
                f"{len(ranks)} available devices ({len(ranks) - want} idle)",
                stacklevel=2,
            )
        ranks = ranks[:want]
    return _mesh_over(ranks, data_axis, device)


def planned_size(tpu_cfg, world: int, batch_size: Optional[int] = None) -> int:
    """Ranks ``mesh_from_config`` keeps of ``world`` when ``mesh_shape`` is
    unset: the largest count dividing ``batch_size`` unless
    ``batch_per_device`` (warns when that drops ranks)."""
    n = world
    if batch_size is not None and not getattr(tpu_cfg, "batch_per_device", False):
        while n > 1 and batch_size % n != 0:
            n -= 1
        if n < world:
            warnings.warn(
                f"global batch {batch_size} is not divisible by "
                f"{world} devices; using only {n} "
                f"({world - n} idle). Set tpu.batch_per_device: true "
                f"to scale the global batch to batch_size x n_devices "
                f"(remember to adjust the learning rate accordingly).",
                stacklevel=3,
            )
    return n


def mesh_from_config(tpu_cfg, batch_size: Optional[int] = None, device="cuda") -> Optional[Mesh]:
    """The mesh ``TpuConfig`` describes over the live ranks (None for one).

    Every live rank calls it at the same point of the program; a rank left
    out does not return (it idles until the run ends)."""
    if tpu_cfg.mesh_shape is not None:
        return create_mesh(tpu_cfg.data_axis, None, tpu_cfg.mesh_shape, device)
    live = live_ranks()
    n = planned_size(tpu_cfg, len(live), batch_size)
    mesh = _mesh_over(live[:n], tpu_cfg.data_axis, device)
    return None if n == 1 else mesh


def effective_batch_size(tpu_cfg, batch_size: int, mesh: Optional[Mesh]) -> int:
    """Global batch: ``batch_size``, or ``batch_size`` x the mesh size with
    ``tpu_cfg.batch_per_device``."""
    if mesh is not None and getattr(tpu_cfg, "batch_per_device", False):
        return int(batch_size) * mesh.size
    return int(batch_size)


def batch_rows(mesh: Optional[Mesh], global_batch: int) -> slice:
    """This rank's rows of a global batch (all of them without a mesh).
    Raises ``ValueError`` when the mesh does not divide the batch, as JAX's
    placement of such a batch on a mesh does."""
    if mesh_size(mesh) == 1:
        return slice(0, global_batch)
    if global_batch % mesh.size:
        raise ValueError(
            f"a global batch of {global_batch} does not split over the {mesh.size} ranks "
            f"of the mesh: set tpu.mesh_shape to a divisor of the batch size, or "
            f"tpu.batch_per_device")
    per = global_batch // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch, mesh: Optional[Mesh]):
    """This rank's rows of a (tuple, list or dict of) global batch array(s)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    return batch[batch_rows(mesh, batch.shape[0])]


def shard_chain(chain, mesh: Optional[Mesh]):
    """This rank's rows of the batch (second) axis of a ``[K, B, ...]`` chain."""
    return chain[:, batch_rows(mesh, chain.shape[1])]


def check_same(values, mesh: Optional[Mesh], what: str) -> None:
    """Raise ``RuntimeError`` on every rank of ``mesh`` unless ``values``
    (numbers, or tensors, each stood for by a float64 sum of at most ~4M
    evenly strided elements) are equal on all of them: the first rank's
    values are broadcast and the ranks that differ counted, two small
    collectives where a broadcast of the tensors would move them all."""
    if mesh_size(mesh) == 1:
        return
    from light_unet_tpu_torch.parallel.collectives import broadcast, psum

    sums = []
    for v in values:
        if isinstance(v, torch.Tensor):
            flat = v.detach().reshape(-1)
            v = flat[::max(1, flat.numel() >> 21)].double().sum()
        sums.append(torch.as_tensor(v, dtype=torch.float64).to(mesh.device))
    mine = torch.stack(sums)
    first = broadcast(mine.clone(), mesh)
    differ = psum((first != mine).any().to(torch.float32).reshape(1), mesh)
    if float(differ) > 0:
        raise RuntimeError(f"{what} differ on {int(differ)} of the {mesh.size} ranks: every "
                            f"rank must read the same files")


def replicate(tensors, mesh: Optional[Mesh]):
    """Make ``tensors`` (one or a sequence) equal on every rank: broadcast in
    place from the mesh's first rank."""
    if mesh_size(mesh) == 1:
        return tensors
    from light_unet_tpu_torch.parallel.collectives import broadcast

    for t in ([tensors] if isinstance(tensors, torch.Tensor) else tensors):
        broadcast(t, mesh)
    return tensors
