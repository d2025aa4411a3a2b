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
The weights go to the kernel's layouts once per block, dtype and device
(``kernel_weights``); in bf16 the pointwise weights of 16/32/64/128-channel
convs are packed as tensor-core (mma) fragments.
"""

from __future__ import annotations

import ctypes

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


MMA_WIDTHS = (16, 32, 64, 128)  # channel counts the kernel's mma tiles take


def _as_kernel_weights(w, dtype, device):
    """Conv weight -> float32 holding ``dtype`` values, contiguous on ``device``:
    depthwise [C, 1, 3, 3, 3] -> [27, C]; pointwise [C, Cin, 1, 1, 1] -> [Cin, C]."""
    w = w.detach().to(dtype).float()
    w = w.reshape(w.shape[0], -1).t()
    return w.contiguous().to(device)


def _as_mma_fragments(w, device):
    """Pointwise weight [C, Cin, 1, 1, 1] -> bf16 B operands of
    ``mma.m16n8k16`` in the order the kernel reads them:
    ``[Cin/16, C/8, 32 lanes, 4]``.  Lane ``4g + t`` of k-step ``ks`` and
    n-tile ``nt`` holds W[k][n] for n = 8 nt + g and k = 16 ks + 2t + (0, 1)
    (register b0), then 16 ks + 8 + 2t + (0, 1) (register b1)."""
    c, cin = w.shape[0], w.shape[1]
    m = w.detach().reshape(c, cin).t().to(torch.bfloat16)  # [Cin, C]
    m = m.reshape(cin // 16, 2, 4, 2, c // 8, 8)         # [ks, half, t, p, nt, g]
    m = m.permute(0, 4, 5, 2, 1, 3).reshape(cin // 16, c // 8, 32, 4)
    return m.contiguous().to(device)


def _f32(p, device):
    return p.detach().to(device, torch.float32).contiguous()


def mma_paths(cin, c, dtype):
    """(conv1 and the shortcut, conv2) on the tensor cores?  bf16 only: in
    float32 the tensor cores would compute in TF32."""
    if dtype != torch.bfloat16:
        return False, False
    return cin in MMA_WIDTHS and c in MMA_WIDTHS, c in MMA_WIDTHS


def kernel_weights(blk, dtype, device):
    """The block's weights in the kernel's layouts on ``device``, converted
    once and cached on the block (``blk._kernel_weights``) per dtype and
    device.  The cache key holds each parameter's storage pointer and
    version counter, so ``load_state_dict``, an optimizer step or any
    in-place update (which bump the version) and a replaced parameter all
    convert anew; a write through ``.data`` bumps no version and is missed."""
    device = torch.device(device)
    params = tuple(blk.parameters())
    key = (dtype, device, tuple((p.data_ptr(), p._version) for p in params))
    hit = getattr(blk, "_kernel_weights", None)
    if hit is not None and hit[0] == key:
        return hit[1]
    cin = blk.conv1.depthwise.weight.shape[0]
    c = blk.conv1.pointwise.weight.shape[0]
    mma1, mma2 = mma_paths(cin, c, dtype)

    def pointwise(w, mma):
        return _as_mma_fragments(w, device) if mma else _as_kernel_weights(w, dtype, device)

    kw = {
        "mma1": mma1, "mma2": mma2,
        "dw1": _as_kernel_weights(blk.conv1.depthwise.weight, dtype, device),
        "pw1": pointwise(blk.conv1.pointwise.weight, mma1),
        "dw2": _as_kernel_weights(blk.conv2.depthwise.weight, dtype, device),
        "pw2": pointwise(blk.conv2.pointwise.weight, mma2),
        "n1s": _f32(blk.norm1.weight, device), "n1b": _f32(blk.norm1.bias, device),
        "n2s": _f32(blk.norm2.weight, device), "n2b": _f32(blk.norm2.bias, device),
        "sc": None, "nss": None, "nsb": None,
    }
    if blk.shortcut is not None:
        conv, norm = blk.shortcut
        kw.update(sc=pointwise(conv.weight, mma1), nss=_f32(norm.weight, device),
                  nsb=_f32(norm.bias, device))
    blk._kernel_weights = (key, kw)
    return kw


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    if x.data_ptr() % 16:  # the kernel's 16-byte loads need an aligned base
        x = x.clone()
    kw = kernel_weights(blk, dtype, dev)
    hbuf = torch.empty((b, d, h, w, c), dtype=dtype, device=dev)
    h2buf = torch.empty_like(hbuf)
    out = torch.empty_like(hbuf)
    stats = torch.empty((3, b, c, 2), dtype=torch.float64, device=dev)
    lib = _build.load("residual_block")
    rc = lib.residual_block(
        x.data_ptr(), *(_ptr(kw[k]) for k in ("dw1", "pw1", "n1s", "n1b", "dw2", "pw2", "n2s",
                                              "n2b", "sc", "nss", "nsb")),
        hbuf.data_ptr(), h2buf.data_ptr(), out.data_ptr(), stats.data_ptr(),
        DTYPE_CODES[dtype], b, d, h, w, cin, c, int(kw["mma1"]), int(kw["mma2"]),
        float(IN_EPS), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "residual_block")
    launches += 1
    return out


def kernel_plan(shape, c, dtype):
    """The tiles the kernel's two conv launches take for input ``shape``
    ``(B, D, H, W, Cin)`` and ``c`` output channels: ``{"conv1": (TD, TH, 8,
    shared bytes), "conv2": ...}``.  Needs the card (it asks the device for its
    shared-memory limit)."""
    _, d, h, w, cin = shape
    mma1, mma2 = mma_paths(cin, c, dtype)
    lib = _build.load("residual_block")
    plan = (ctypes.c_int * 6)()
    rc = lib.residual_block_plan(d, h, w, cin, c, int(cin != c), int(mma1), int(mma2), plan)
    _build.check(lib, rc, "residual_block_plan")
    return {"conv1": (plan[0], plan[1], 8, plan[2]), "conv2": (plan[3], plan[4], 8, plan[5])}
