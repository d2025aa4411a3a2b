"""Lightweight 3D U-Net (port of ``light_unet_tpu/models/unet3d.py``).

217,228 parameters: a 4-level encoder/decoder (16->32->64->128) of
residual blocks built from depthwise-separable (or grouped, or plain) 3x3x3
convolutions, affine InstanceNorm + LeakyReLU(0.01), 2x max-pool, 2x
transposed-conv upsampling with skip concatenation, 1x1x1 conv + sigmoid.

Tensors are channels-last ``[B, D, H, W, C]``, as in the JAX model; each
convolution runs on the ``[B, C, D, H, W]`` view of that memory (which is
``torch.channels_last_3d``), so no layout copy is made.  Parameter names
and shapes are the reference torch model's, so a reference ``.pth`` or
``tools.weights.from_jax_params(...)`` loads with ``strict=True``.

Rounding points follow the JAX (lax) path: parameters stay float32 and are
cast to the compute dtype at each conv; conv outputs are in the compute
dtype; InstanceNorm statistics are float32 and its output is cast back
before the residual add.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from light_unet_tpu_torch.ops.norm_kernel import (
    IN_EPS,
    LEAKY_SLOPE,
    fused_instance_norm_leaky_relu,
    reference_instance_norm_leaky_relu,
)


def to_ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` on ``[B, D, H, W, C]`` input, computed in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = F.conv3d(to_ncdhw(x.to(dt)), self.weight.to(dt), bias, self.stride,
                     self.padding, self.dilation, self.groups)
        return to_ndhwc(y)


class ConvTranspose3d(nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` on ``[B, D, H, W, C]`` input, in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        y = F.conv_transpose3d(to_ncdhw(x.to(dt)), self.weight.to(dt), self.bias.to(dt),
                               self.stride)
        return to_ndhwc(y)


class InstanceNorm(nn.Module):
    """Affine InstanceNorm over the spatial dims of ``[B, D, H, W, C]``.

    torch ``InstanceNorm3d(C, affine=True)`` semantics, statistics in
    float32, output in the input dtype.  ``use_pallas`` (the JAX package's name for the gate) routes
    inference through the fused norm kernel (``ops/norm_kernel.py``);
    ``fuse_leaky`` folds the following LeakyReLU in (slope 1.0 otherwise).
    """

    def __init__(self, channels: int, use_pallas: bool = False, fuse_leaky: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.use_pallas = use_pallas
        self.slope = LEAKY_SLOPE if fuse_leaky else 1.0

    def forward(self, x):
        if self.use_pallas and not self.training:
            return fused_instance_norm_leaky_relu(
                x, self.weight, self.bias, eps=IN_EPS, negative_slope=self.slope)
        return reference_instance_norm_leaky_relu(
            x, self.weight, self.bias, eps=IN_EPS, negative_slope=self.slope)


class ChannelDropout(nn.Module):
    """Channel dropout on ``[B, D, H, W, C]`` (``nn.Dropout3d`` semantics: a
    whole channel of a sample is dropped, survivors scaled by 1/(1-p)).  The
    mask is drawn from ``generator`` (set by the trainer) on the input's device."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training:
            return x
        keep = 1.0 - self.p
        mask = torch.rand((x.shape[0], 1, 1, 1, x.shape[-1]), generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class DepthwiseSeparableConv(nn.Module):
    """3x3x3 depthwise conv then 1x1x1 pointwise conv (both bias-free)."""

    def __init__(self, in_ch: int, out_ch: int, compute_dtype=torch.float32):
        super().__init__()
        self.depthwise = Conv3d(in_ch, in_ch, 3, padding=1, groups=in_ch, bias=False,
                                compute_dtype=compute_dtype)
        self.pointwise = Conv3d(in_ch, out_ch, 1, bias=False, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class ResidualBlock(nn.Module):
    """conv -> IN -> LeakyReLU -> (channel dropout) -> conv -> IN -> +res -> LeakyReLU."""

    def __init__(self, in_ch: int, features: int, use_depthwise_separable: bool = True,
                 use_grouped: bool = True, groups: int = 8, dropout_p: float = 0.1,
                 compute_dtype=torch.float32, use_pallas: bool = False):
        super().__init__()
        self.use_depthwise_separable = use_depthwise_separable
        self.compute_dtype = compute_dtype
        self.conv1 = self._conv(in_ch, features, use_grouped, groups)
        self.norm1 = InstanceNorm(features, use_pallas, fuse_leaky=True)
        self.dropout = ChannelDropout(dropout_p) if dropout_p > 0 else None
        self.conv2 = self._conv(features, features, use_grouped, groups)
        self.norm2 = InstanceNorm(features, use_pallas)
        self.shortcut = None
        if in_ch != features:
            self.shortcut = nn.Sequential(
                Conv3d(in_ch, features, 1, bias=False, compute_dtype=compute_dtype),
                InstanceNorm(features, use_pallas),
            )

    def _conv(self, in_ch, features, use_grouped, groups):
        dt = self.compute_dtype
        if self.use_depthwise_separable:
            return DepthwiseSeparableConv(in_ch, features, dt)
        g = groups if (use_grouped and groups > 1 and in_ch >= groups and features >= groups) else 1
        return Conv3d(in_ch, features, 3, padding=1, groups=g, bias=False, compute_dtype=dt)

    def forward(self, x):
        residual = x if self.shortcut is None else self.shortcut(x)
        out = self.norm1(self.conv1(x))
        if self.dropout is not None:
            out = self.dropout(out)
        out = self.norm2(self.conv2(out))
        return F.leaky_relu(out + residual, LEAKY_SLOPE)


class DownBlock(nn.Module):
    """2x max-pool then residual block."""

    def __init__(self, in_ch: int, features: int, **kw):
        super().__init__()
        self.res_block = ResidualBlock(in_ch, features, **kw)

    def forward(self, x):
        return self.res_block(max_pool(x))


def max_pool(x):
    return to_ndhwc(F.max_pool3d(to_ncdhw(x), 2, 2))


def pad_concat(x, skip):
    """Pad ``x`` (centered) up to ``skip``'s spatial size, then concat [x, skip]."""
    pads = []
    for axis in (3, 2, 1):  # F.pad lists the last dims first
        diff = skip.shape[axis] - x.shape[axis]
        pads += [diff // 2, diff - diff // 2]
    if any(pads):
        x = F.pad(x, [0, 0] + pads)
    return torch.cat([x, skip], dim=-1)


class UpBlock(nn.Module):
    """2x transposed conv, pad-to-skip, concat [up, skip], residual block."""

    def __init__(self, in_ch: int, features: int, compute_dtype=torch.float32, **kw):
        super().__init__()
        self.up = ConvTranspose3d(in_ch, in_ch // 2, 2, stride=2, compute_dtype=compute_dtype)
        self.res_block = ResidualBlock(in_ch // 2 + features, features,
                                       compute_dtype=compute_dtype, **kw)

    def forward(self, x, skip):
        return self.res_block(pad_concat(self.up(x), skip))


class Lightweight3DUNet(nn.Module):
    """Input ``[B, D, H, W, in_channels]`` -> sigmoid probabilities
    ``[B, D, H, W, out_channels]`` in float32."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 encoder_channels: Sequence[int] = (16, 32, 64, 128),
                 use_depthwise_separable: bool = True, use_grouped: bool = True,
                 groups: int = 8, dropout_p: float = 0.1, compute_dtype=torch.float32,
                 use_pallas: bool = False):
        super().__init__()
        ch = list(encoder_channels)
        self.compute_dtype = compute_dtype
        self.use_depthwise_separable = use_depthwise_separable
        kw = dict(use_depthwise_separable=use_depthwise_separable, use_grouped=use_grouped,
                  groups=groups, dropout_p=dropout_p, compute_dtype=compute_dtype,
                  use_pallas=use_pallas)
        # the first block never uses grouped conv (depthwise-separable still allowed)
        self.init_conv = ResidualBlock(in_channels, ch[0], **{**kw, "use_grouped": False})
        self.down1 = DownBlock(ch[0], ch[1], **kw)
        self.down2 = DownBlock(ch[1], ch[2], **kw)
        self.down3 = DownBlock(ch[2], ch[3], **kw)
        self.bottleneck = ResidualBlock(ch[3], ch[3], **kw)
        self.up1 = UpBlock(ch[3], ch[2], **kw)
        self.up2 = UpBlock(ch[2], ch[1], **kw)
        self.up3 = UpBlock(ch[1], ch[0], **kw)
        self.out_conv = Conv3d(ch[0], out_channels, 1, bias=True)  # float32, as flax promotes

    def forward(self, x):
        x = x.to(self.compute_dtype)
        x1 = self.init_conv(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.bottleneck(x4)
        y = self.up1(y, x3)
        y = self.up2(y, x2)
        y = self.up3(y, x1)
        return torch.sigmoid(self.out_conv(y).float())


def build_model(model_cfg, compute_dtype=torch.float32, inference: bool = False,
                use_pallas: bool = False) -> Lightweight3DUNet:
    """Construct the model from a ``ModelConfig`` (same switches as the JAX
    package's ``build_model``)."""
    dropout = model_cfg.dropout_p if (model_cfg.use_dropout and not inference) else 0.0
    return Lightweight3DUNet(
        in_channels=1,
        out_channels=model_cfg.output_channels,
        encoder_channels=tuple(model_cfg.encoder_channels),
        use_depthwise_separable=model_cfg.use_depthwise_separable,
        use_grouped=model_cfg.use_grouped_conv,
        groups=model_cfg.groups,
        dropout_p=dropout,
        compute_dtype=compute_dtype,
        use_pallas=use_pallas,
    )


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights: convs uniform in +-1/sqrt(fan_in), norm scales
    near 1 and biases near 0 (so the norms' affine step is exercised)."""
    for name, p in model.named_parameters():
        if p.ndim >= 2:
            fan_in = p[0].numel() if not name.endswith("up.weight") else p.shape[0]
            bound = fan_in ** -0.5
            p.copy_(torch.rand(p.shape, generator=generator) * (2 * bound) - bound)
        elif name.endswith("weight"):
            p.copy_(1.0 + 0.1 * torch.randn(p.shape, generator=generator))
        else:
            p.copy_(0.1 * torch.randn(p.shape, generator=generator))
    return model


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Draw every dropout mask of ``model`` from ``generator``."""
    for m in model.modules():
        if isinstance(m, ChannelDropout):
            m.generator = generator


def count_parameters(model: nn.Module) -> dict:
    """Total/trainable parameter counts (all params are trainable)."""
    total = sum(p.numel() for p in model.parameters())
    return {"total": total, "trainable": total}
