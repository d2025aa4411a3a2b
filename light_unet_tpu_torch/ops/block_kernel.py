"""Fused inference residual block (the port of
``light_unet_tpu/ops/pallas_block.py``, kernel K1).

One whole depthwise-separable ``ResidualBlock``:

    h   = pointwise1(depthwise1(x))           3x3x3 depthwise, zero edge
    g   = leaky(IN1(h))
    h2  = pointwise2(depthwise2(g))
    out = leaky(IN2(h2) + residual)           residual = x or IN_s(shortcut(x))

with f32 accumulation, every intermediate rounded to the compute dtype and
norm statistics taken from the rounded values (the JAX lax path's rounding
points; weights are rounded to the compute dtype as the lax convs do).

On a CUDA tensor ``fused_residual_block`` launches the hand-written kernels
of ``csrc/residual_block.cu`` (or raises); on a CPU tensor it runs
``reference_residual_block``, the plain version beside it.  ``launches``
counts kernel launches and ``plain_calls`` counts plain-version calls.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from light_unet_tpu_torch.ops import _build
from light_unet_tpu_torch.ops.norm_kernel import (
    DTYPE_CODES,
    IN_EPS,
    LEAKY_SLOPE,
    reference_instance_norm_leaky_relu,
)

launches = 0
plain_calls = 0


def reference_residual_block(x, blk):
    """Plain torch version of the fused block (the CPU path and the oracle).

    ``blk`` is a depthwise-separable ``models.unet3d.ResidualBlock``; its
    convs (``F.conv3d``) round their outputs to ``blk.compute_dtype``."""
    global plain_calls
    plain_calls += 1
    x = x.to(blk.compute_dtype)
    g = reference_instance_norm_leaky_relu(blk.conv1(x), blk.norm1.weight, blk.norm1.bias)
    y = reference_instance_norm_leaky_relu(blk.conv2(g), blk.norm2.weight, blk.norm2.bias,
                                           negative_slope=1.0)
    if blk.shortcut is None:
        res = x
    else:
        conv, norm = blk.shortcut
        res = reference_instance_norm_leaky_relu(conv(x), norm.weight, norm.bias,
                                                 negative_slope=1.0)
    # one rounding after the add and the LeakyReLU, as the kernel does
    return F.leaky_relu(y.float() + res.float(), LEAKY_SLOPE).to(x.dtype)


def _as_kernel_weights(w, dtype, device):
    """Conv weight -> float32 holding ``dtype`` values, contiguous on ``device``:
    depthwise [C, 1, 3, 3, 3] -> [27, C]; pointwise [C, Cin, 1, 1, 1] -> [Cin, C]."""
    w = w.detach().to(dtype).float()
    w = w.reshape(w.shape[0], -1).t()
    return w.contiguous().to(device)


def _f32(p, device):
    return p.detach().to(device, torch.float32).contiguous()


@torch.no_grad()  # inference only: the kernel has no backward
def fused_residual_block(x, blk):
    """Run one depthwise-separable ``ResidualBlock`` through the fused kernel
    in ``blk.compute_dtype``: ``x`` ``[B, D, H, W, Cin]`` -> ``[B, D, H, W, C]``."""
    if x.device.type == "cpu":
        return reference_residual_block(x, blk)
    dtype = blk.compute_dtype
    b, d, h, w, cin = x.shape if x.dim() == 5 else (0,) * 5
    c = blk.conv1.pointwise.weight.shape[0]
    if x.device.type != "cuda" or dtype not in DTYPE_CODES or cin == 0 \
            or blk.conv1.depthwise.weight.shape[0] != cin:
        raise ValueError(f"residual block kernel takes a [B, D, H, W, Cin] CUDA tensor matching "
                         f"the block and a float32/bfloat16 block, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device} for a {dtype} block of "
                         f"{blk.conv1.depthwise.weight.shape[0]} -> {c} channels")
    global launches
    dev = x.device
    x = x.to(dtype).contiguous()
    dw1 = _as_kernel_weights(blk.conv1.depthwise.weight, dtype, dev)
    pw1 = _as_kernel_weights(blk.conv1.pointwise.weight, dtype, dev)
    dw2 = _as_kernel_weights(blk.conv2.depthwise.weight, dtype, dev)
    pw2 = _as_kernel_weights(blk.conv2.pointwise.weight, dtype, dev)
    n1s, n1b = _f32(blk.norm1.weight, dev), _f32(blk.norm1.bias, dev)
    n2s, n2b = _f32(blk.norm2.weight, dev), _f32(blk.norm2.bias, dev)
    if blk.shortcut is None:
        sc_ptrs = (None, None, None)
    else:
        conv, norm = blk.shortcut
        sc = _as_kernel_weights(conv.weight, dtype, dev)
        nss, nsb = _f32(norm.weight, dev), _f32(norm.bias, dev)
        sc_ptrs = (sc.data_ptr(), nss.data_ptr(), nsb.data_ptr())
    hbuf = torch.empty((b, d, h, w, c), dtype=dtype, device=dev)
    h2buf = torch.empty_like(hbuf)
    out = torch.empty_like(hbuf)
    stats = torch.empty((3, b, c, 2), dtype=torch.float64, device=dev)
    lib = _build.load("residual_block")
    rc = lib.residual_block(
        x.data_ptr(), dw1.data_ptr(), pw1.data_ptr(), n1s.data_ptr(), n1b.data_ptr(),
        dw2.data_ptr(), pw2.data_ptr(), n2s.data_ptr(), n2b.data_ptr(), *sc_ptrs,
        hbuf.data_ptr(), h2buf.data_ptr(), out.data_ptr(), stats.data_ptr(),
        DTYPE_CODES[dtype], b, d, h, w, cin, c, float(IN_EPS),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "residual_block")
    launches += 1
    return out
