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
launches.
"""

from __future__ import annotations

import torch

from light_unet_tpu_torch.ops import _build

LEAKY_SLOPE = 0.01
IN_EPS = 1e-5  # torch InstanceNorm3d default

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def reference_instance_norm_leaky_relu(x, scale, bias, *, eps=IN_EPS, negative_slope=LEAKY_SLOPE):
    """Plain torch version (the CPU path and the numerical oracle)."""
    x32 = x.float()
    mean = x32.mean(dim=(1, 2, 3), keepdim=True)
    var = (x32 - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return torch.where(y > 0, y, negative_slope * y).to(x.dtype)


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
    scale = scale.detach().to(x.device, torch.float32).contiguous()
    bias = bias.detach().to(x.device, torch.float32).contiguous()
    y = torch.empty_like(x)
    stats = torch.empty((b, c, 2), dtype=torch.float64, device=x.device)
    lib = _build.load("instance_norm")
    rc = lib.instance_norm_leaky(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), stats.data_ptr(),
        DTYPE_CODES[x.dtype], b, d * h * w, c, float(eps), float(negative_slope),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, rc, "instance_norm_leaky")
    launches += 1
    return y
