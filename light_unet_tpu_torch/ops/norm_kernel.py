"""Fused affine InstanceNorm + LeakyReLU (the port of
``light_unet_tpu/ops/pallas_kernels.py``, kernel K2).

    y = leaky_relu((x - mean_c) * rsqrt(var_c + eps) * scale_c + bias_c, slope)

over ``[B, D, H, W, C]`` with per-(sample, channel) biased statistics over
D*H*W in float32 and the output in the input dtype.  Slope 1.0 is a plain
InstanceNorm (``norm2``, ``shortcut_norm``).

On a CUDA tensor ``fused_instance_norm_leaky_relu`` launches the
hand-written kernel of ``csrc/instance_norm.cu`` (or raises); on a CPU
tensor it runs the plain version beside it,
``reference_instance_norm_leaky_relu``.  ``launches`` counts kernel
launches.  Each call is one cooperative launch that reads x once; its plan
(``kernel_plan``) and scratch are made once per device, stream, shape and
dtype, and float32 copies of a scale or bias that is not already float32 on
the device are cached on the tensor.
"""

from __future__ import annotations

import ctypes

import torch

from light_unet_tpu_torch.ops import _build

LEAKY_SLOPE = 0.01
IN_EPS = 1e-5  # torch InstanceNorm3d default

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the fields of instance_norm_plan's output, in order
PLAN_KEYS = ("k", "rows_per_chunk", "groups", "threads", "smem", "ctas_per_sm", "sms", "streams")

launches = 0
_workspaces = {}


def reference_instance_norm_leaky_relu(x, scale, bias, *, eps=IN_EPS, negative_slope=LEAKY_SLOPE):
    """Plain torch version (the CPU path and the numerical oracle)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return torch.where(y > 0, y, negative_slope * y).to(x.dtype)


def as_f32(p, device):
    """``p`` as a contiguous float32 tensor on ``device``: ``p`` itself when it
    already is one, else a copy cached on ``p`` (``p._kernel_f32``) and keyed
    by device, storage pointer and version counter, so an in-place update or
    ``load_state_dict`` converts anew (a write through ``.data`` is missed)."""
    if p.dtype == torch.float32 and p.device == device and p.is_contiguous():
        return p
    key = (device, p.data_ptr(), p._version)
    hit = getattr(p, "_kernel_f32", None)
    if hit is None or hit[0] != key:
        hit = (key, p.detach().to(device, torch.float32).contiguous())
        p._kernel_f32 = hit
    return hit[1]


def _plan(lib, dtype, b, s, c, device):
    plan = (ctypes.c_int64 * len(PLAN_KEYS))()
    with torch.cuda.device(device):  # the C entry plans for the current device
        rc = lib.instance_norm_plan(DTYPE_CODES[dtype], b, s, c, plan)
    _build.check(lib, rc, "instance_norm_plan")
    return plan


def _workspace(lib, x, stream):
    """(plan, partial sums, sync words) for ``x``'s shape on ``stream``, made
    once: partials [B, k, C, 2] float64, and [B, 2] (arrivals, generation)
    words zeroed here and left ready by every call."""
    b, d, h, w, c = x.shape
    key = (x.device, stream, b, d * h * w, c, x.dtype)
    ws = _workspaces.get(key)
    if ws is None:
        plan = _plan(lib, x.dtype, b, d * h * w, c, x.device)
        part = torch.empty((b, plan[0], c, 2), dtype=torch.float64, device=x.device)
        sync = torch.zeros((b, 2), dtype=torch.int32, device=x.device)
        ws = _workspaces[key] = (plan, part, sync)
    return ws


def kernel_plan(shape, dtype, device="cuda"):
    """The kernel's plan for ``[B, D, H, W, C]`` input of ``dtype``: a dict of
    ``PLAN_KEYS`` (k chunks per sample, rows per chunk, samples per round,
    threads and shared bytes per CTA, CTAs resident per SM, SMs, and 1 when a
    sample is too large to hold on chip and x is read twice).  Needs the card
    (it asks the device for its limits and the kernel's occupancy)."""
    b, d, h, w, c = shape
    plan = _plan(_build.load("instance_norm"), dtype, b, d * h * w, c, device)
    return dict(zip(PLAN_KEYS, plan))


@torch.no_grad()  # inference only: the kernel has no backward
def fused_instance_norm_leaky_relu(x, scale, bias, *, eps=IN_EPS, negative_slope=LEAKY_SLOPE):
    """InstanceNorm3d(affine) + LeakyReLU over ``[B, D, H, W, C]``."""
    if x.device.type == "cpu":
        return reference_instance_norm_leaky_relu(
            x, scale, bias, eps=eps, negative_slope=negative_slope)
    c = x.shape[-1]
    if (x.device.type != "cuda" or x.dim() != 5 or x.dtype not in DTYPE_CODES
            or scale.numel() != c or bias.numel() != c):
        raise ValueError(f"instance norm kernel takes a 5-D float32/bfloat16 CUDA tensor and "
                         f"[C] scale and bias, got {x.dtype} {tuple(x.shape)} on {x.device}, "
                         f"{scale.numel()} scales, {bias.numel()} biases")
    global launches
    b, d, h, w, _ = x.shape
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel's 16-byte copies need an aligned base
        x = x.clone()
    scale, bias = as_f32(scale, x.device), as_f32(bias, x.device)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.load("instance_norm")
    plan, part, sync = _workspace(lib, x, stream)
    rc = lib.instance_norm_leaky(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), part.data_ptr(),
        sync.data_ptr(), DTYPE_CODES[x.dtype], b, d * h * w, c, plan, float(eps),
        float(negative_slope), stream,
    )
    _build.check(lib, rc, "instance_norm_leaky")
    launches += 1
    return y
