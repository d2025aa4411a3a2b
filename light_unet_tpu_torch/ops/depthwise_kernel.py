"""Depthwise 3x3x3 convolution, inference forward, over channels-last
``[B, D, H, W, C]`` (zero edge, stride 1, no bias), and its 5x5x5 variant
with a per-channel bias (``depthwise_conv3d_k5``, below):

    y[b, d, h, w, c] = sum over kd, kh, kw of
                       x[b, d + kd - 1, h + kh - 1, w + kw - 1, c] * weight[c, 0, kd, kh, kw]

with f32 accumulation and the output rounded once to the input's dtype
(bfloat16 or float32), the weight rounded to that dtype first, as
``models/unet3d.py:Conv3d`` rounds it: the function and rounding points of
``F.conv3d(groups=C)``.  It replaces no TPU kernel (the JAX package leaves
this conv to XLA).

On a CUDA tensor ``depthwise_conv3d`` launches the hand-written kernel of
``csrc/depthwise_conv.cu`` (or raises); on a CPU tensor it runs the plain
version beside it, ``reference_depthwise_conv3d`` (``F.conv3d`` with
``groups=C`` on the channels-first view).  ``launches`` counts kernel
launches and ``plain_calls`` plain-version calls.  The kernel allocates
nothing (the output comes from ``torch.empty``) and launches on the current
stream, so a CUDA graph captures it.  Inference only: it has no backward,
and the model takes it only while autograd does not record
(``models/unet3d.py:DepthwiseConv3d``).

The 5x5x5 variant (MedNeXt's block conv, ``models/mednext.py``):

    y[b, d, h, w, c] = bias[c] + sum over kd, kh, kw in [0, 5) of
                       x[b, d + kd - 2, h + kh - 2, w + kw - 2, c] * weight[c, 0, kd, kh, kw]

f32 accumulation in the order (kd, kh, kw), the bias (optional) added last,
the weight and bias rounded to the input's dtype first and the output
rounded once: ``F.conv3d(groups=C)`` in float32 of the weight and bias
rounded to that dtype, its plain version ``reference_depthwise_conv3d_k5``.
Its CUDA kernels are named ``dw5_*``; ``counts5``
(``depthwise_kernel.k5.*`` in ``tracing.snapshot()``, advanced by graph
replays) counts its launches and plain calls apart from the 3x3x3 ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from light_unet_tpu_torch.ops import _build
from light_unet_tpu_torch.ops.norm_kernel import DTYPE_CODES, as_f32
from light_unet_tpu_torch.utils import tracing

launches = 0
plain_calls = 0
# the 5x5x5 variant's launches and plain calls
counts5 = tracing.register_counts("depthwise_kernel.k5", {"launches": 0, "plain_calls": 0})


def reference_depthwise_conv3d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain torch version (the CPU path and the oracle)."""
    global plain_calls
    plain_calls += 1
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), weight.to(x.dtype), None, 1, 1, 1, x.shape[-1])
    return y.permute(0, 2, 3, 4, 1)


def reference_depthwise_conv3d_k5(x: torch.Tensor, weight: torch.Tensor,
                                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of the 5x5x5 variant (the CPU path and the
    oracle): ``F.conv3d`` in float32 of the input and of the weight and bias
    rounded to its dtype, rounded once to that dtype (cuDNN's own bfloat16
    depthwise 5^3 conv on the card is up to ~250 bfloat16 units away from
    that sum)."""
    counts5["plain_calls"] += 1
    b = None if bias is None else bias.to(x.dtype).float()
    y = F.conv3d(x.float().permute(0, 4, 1, 2, 3), weight.to(x.dtype).float(), b, 1, 2, 1,
                 x.shape[-1])
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def order_bound(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """How far two float32 sums of one output's k^3 products (and bias) can
    differ by their order alone: 2 * (k^3 - 1, plus 1 with a bias) float32
    roundings of the sum of |x w| (and |bias|), in float32: 26 roundings at
    3x3x3, 124 (125 with a bias) at 5x5x5."""
    taps, pad = weight[0].numel(), weight.shape[-1] // 2
    xa = x.float().abs()
    b = None if bias is None else bias.float().abs()
    y = F.conv3d(xa.permute(0, 4, 1, 2, 3), weight.float().abs(), b, 1, pad, 1, x.shape[-1])
    roundings = taps - 1 + (bias is not None)
    return y.permute(0, 2, 3, 4, 1) * (2 * roundings * 2.0 ** -24)


def gap_ulps(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
             weight: torch.Tensor, bias: Optional[torch.Tensor] = None) -> float:
    """The largest gap between two bfloat16 results of this conv of ``x`` by
    ``weight`` and ``bias`` (the kernel's and the plain version's), beyond
    ``order_bound``, in bfloat16 units in the last place of the larger value.  Both versions
    sum in float32, in their own orders, and round once, so correct results
    are at most 1 apart: only where a sum cancels far below its terms does
    the order term exceed a bfloat16 unit."""
    g, r = got.float(), want.float()
    mag = torch.maximum(g.abs(), r.abs()).clamp(min=torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)  # bfloat16 keeps 8 significant bits
    return float(((g - r).abs() - order_bound(x, weight, bias)).clamp(min=0).div(ulp).max())


def check_args(x: torch.Tensor, weight: torch.Tensor) -> None:
    """Raise ``ValueError`` unless the kernel takes ``x`` and ``weight``: a
    non-empty contiguous ``[B, D, H, W, C]`` float32 or bfloat16 tensor, a
    ``[C, 1, 3, 3, 3]`` weight on its device, H * W and D * H below 2^31 and
    at most 2^31 - 1 CTAs.  Reads no device."""
    if x.dim() != 5 or x.dtype not in DTYPE_CODES or x.numel() == 0:
        raise ValueError(f"depthwise kernel takes a non-empty 5-D float32/bfloat16 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    b, d, h, w, c = x.shape
    if tuple(weight.shape) != (c, 1, 3, 3, 3):
        raise ValueError(f"depthwise kernel takes a [{c}, 1, 3, 3, 3] weight for {c} channels, "
                         f"got {tuple(weight.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"depthwise kernel takes a contiguous [B, D, H, W, C] tensor, got "
                         f"strides {x.stride()}")
    if weight.device != x.device:
        raise ValueError(f"depthwise kernel: weight on {weight.device}, input on {x.device}")
    if h * w >= 2**31 - 1 or d * h >= 2**31 - 1 or b * c * h * w >= 2**31 - 1:
        raise ValueError(f"depthwise kernel: {tuple(x.shape)} is too large to index")


@torch.no_grad()  # inference only: the kernel has no backward
def depthwise_conv3d(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The depthwise 3x3x3 conv of ``x`` [B, D, H, W, C] by ``weight``
    [C, 1, 3, 3, 3], in ``x``'s dtype."""
    if x.device.type == "cpu":
        return reference_depthwise_conv3d(x, weight)
    check_args(x, weight)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise kernel takes a CUDA tensor, got one on {x.device}")
    global launches
    if x.data_ptr() % 16:  # the kernel's 16-byte copies need an aligned base
        x = x.clone()
    wt = as_f32(weight, x.device)  # the float32 parameter itself; the kernel rounds it
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    b, d, h, w, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load("depthwise_conv")
    rc = lib.depthwise_conv3d(x.data_ptr(), wt.data_ptr(), y.data_ptr(), DTYPE_CODES[x.dtype],
                              b, d, h, w, c, stream)
    _build.check(lib, rc, "depthwise_conv3d")
    launches += 1
    return y


def check_args_k5(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` unless the 5x5x5 kernel takes ``x``, ``weight``
    and ``bias``: a non-empty contiguous ``[B, D, H, W, C]`` float32 or
    bfloat16 tensor with C a multiple of 8, a ``[C, 1, 5, 5, 5]`` weight and a
    ``[C]`` bias (or None) on its device, H * W and D * H below 2^31 and at
    most 2^31 - 1 CTAs.  Reads no device."""
    if x.dim() != 5 or x.dtype not in DTYPE_CODES or x.numel() == 0:
        raise ValueError(f"depthwise 5^3 kernel takes a non-empty 5-D float32/bfloat16 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    b, d, h, w, c = x.shape
    if c % 8:
        raise ValueError(f"depthwise 5^3 kernel takes a multiple of 8 channels (its 16-byte "
                         f"copies hold whole channels of a voxel), got {c}")
    if tuple(weight.shape) != (c, 1, 5, 5, 5):
        raise ValueError(f"depthwise 5^3 kernel takes a [{c}, 1, 5, 5, 5] weight for {c} "
                         f"channels, got {tuple(weight.shape)}")
    if bias is not None and tuple(bias.shape) != (c,):
        raise ValueError(f"depthwise 5^3 kernel takes a [{c}] bias, got {tuple(bias.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"depthwise 5^3 kernel takes a contiguous [B, D, H, W, C] tensor, got "
                         f"strides {x.stride()}")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is not None and t.device != x.device:
            raise ValueError(f"depthwise 5^3 kernel: {name} on {t.device}, input on {x.device}")
    if h * w >= 2**31 - 1 or d * h >= 2**31 - 1 or b * c * h * w >= 2**31 - 1:
        raise ValueError(f"depthwise 5^3 kernel: {tuple(x.shape)} is too large to index")


@torch.no_grad()  # inference only: the kernel has no backward
def depthwise_conv3d_k5(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The depthwise 5x5x5 conv of ``x`` [B, D, H, W, C] by ``weight``
    [C, 1, 5, 5, 5] plus ``bias`` [C] (optional), in ``x``'s dtype."""
    if x.device.type == "cpu":
        return reference_depthwise_conv3d_k5(x, weight, bias)
    check_args_k5(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise 5^3 kernel takes a CUDA tensor, got one on {x.device}")
    if x.data_ptr() % 16:  # the kernel's 16-byte copies need an aligned base
        x = x.clone()
    wt = as_f32(weight, x.device)  # float32 parameters; the kernel rounds them
    bt = None if bias is None else as_f32(bias, x.device)
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    b, d, h, w, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load("depthwise_conv")
    rc = lib.depthwise_conv3d_k5(x.data_ptr(), wt.data_ptr(),
                                 None if bt is None else bt.data_ptr(), y.data_ptr(),
                                 DTYPE_CODES[x.dtype], b, d, h, w, c, stream)
    _build.check(lib, rc, "depthwise_conv3d_k5")
    counts5["launches"] += 1
    return y
