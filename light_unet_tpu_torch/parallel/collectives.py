"""Collectives over a ``Mesh``: the counterparts of ``lax.psum``,
``lax.ppermute``, ``lax.psum_scatter`` and ``lax.axis_index`` as the JAX
package uses them (``light_unet_tpu/ops/sliding_window.py:291-292, 376,
393-394``, ``datasets/device_corpus.py:264, 278-279``), plus the gather of
a sharded output to the first rank and a broadcast from it.

* ``psum`` is ``all_reduce`` (SUM), in place;
* ``ppermute`` is one ``batch_isend_irecv`` of the (source, destination)
  pairs that involve this rank, wrap-around pairs included; a rank that
  receives nothing gets zeros, as under ``lax.ppermute``;
* ``psum_scatter`` is ``reduce_scatter_tensor`` along the leading axis;
* ``lax.axis_index`` is ``Mesh.rank``.

Staging, chosen by backend: NCCL runs every collective on the device.
Gloo reduces and broadcasts CUDA tensors (``all_reduce``, ``broadcast``),
but sends, receives and gathers only host tensors, so under gloo a CUDA
tensor goes through host memory for ``ppermute`` and ``gather_to_root``,
and ``psum_scatter`` is an ``all_reduce`` and a slice (gloo's reduce-scatter
is neither in every torch nor on CUDA tensors).  The choice never depends
on a call failing.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from light_unet_tpu_torch.parallel.mesh import Mesh, mesh_size


def _host_staged(t: torch.Tensor, mesh: Mesh) -> bool:
    return t.is_cuda and mesh.backend == "gloo"


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh, in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def broadcast(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """``t`` of mesh rank ``src`` on every rank, in place (a 16-bit integer
    tensor, which neither NCCL nor gloo carries, as its byte view)."""
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.int16 else t,
                   src=mesh.ranks[src], group=mesh.group)
    return t


def ppermute(t: torch.Tensor, mesh: Mesh, pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: mesh rank ``s`` sends ``t`` to ``d`` for each
    (s, d) of ``pairs``; returns what this rank received (zeros if none)."""
    staged = _host_staged(t, mesh)
    src = t.detach().contiguous()
    src = src.cpu() if staged else src
    out = torch.zeros_like(src)
    ops = []
    for s, d in pairs:
        if s == mesh.rank and d == mesh.rank:
            out.copy_(src)
        elif s == mesh.rank:
            ops.append(dist.P2POp(dist.isend, src, mesh.ranks[d], mesh.group))
        elif d == mesh.rank:
            ops.append(dist.P2POp(dist.irecv, out, mesh.ranks[s], mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out.to(t.device) if staged else out


def psum_scatter(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``lax.psum_scatter(..., scatter_dimension=0, tiled=True)``: the sum
    over the mesh, and this rank keeps its ``1/size`` of the leading axis.
    NCCL has no 16-bit integer sum: callers reduce a byte view."""
    if t.shape[0] % mesh.size:
        raise ValueError(f"psum_scatter: {t.shape[0]} rows do not split over {mesh.size} ranks")
    rows = t.shape[0] // mesh.size
    if mesh.backend == "gloo":
        total = psum(t.contiguous().clone(), mesh)
        return total[mesh.rank * rows:(mesh.rank + 1) * rows]
    out = torch.empty((rows, *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.reduce_scatter_tensor(out, t.contiguous(), op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def gather_to_root(t: torch.Tensor, mesh: Mesh, dim: int) -> Optional[torch.Tensor]:
    """Every rank's ``t`` (equal shapes) joined along ``dim`` on mesh rank 0,
    on ``t``'s device; None on the other ranks."""
    staged = _host_staged(t, mesh)
    src = t.contiguous().cpu() if staged else t.contiguous()
    if src.dtype == torch.int16:  # carried as its byte view, like ``broadcast``
        src = src.view(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(mesh.size)] if mesh.is_root else None
    dist.gather(src, parts, dst=mesh.ranks[0], group=mesh.group)
    if not mesh.is_root:
        return None
    return torch.cat([p.view(t.dtype) for p in parts], dim=dim).to(t.device)


class _GlobalSum(torch.autograd.Function):
    """Forward: the sum over the mesh.  Backward: the identity, because
    every rank goes on to compute the same scalar from the sum; summing the
    parameter gradients across ranks afterwards gives the gradient of that
    scalar.  (``torch.distributed.nn.functional.all_reduce`` sums in the
    backward too, which would scale the gradients by the mesh size.)"""

    @staticmethod
    def forward(ctx, x, mesh):
        return psum(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Differentiable sum of ``x`` over the mesh (see ``_GlobalSum``);
    ``x`` itself without one."""
    return x if mesh_size(mesh) == 1 else _GlobalSum.apply(x, mesh)
