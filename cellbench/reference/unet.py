"""The Lightweight 3D U-Net in plain PyTorch, float32, channels first.

The published model (``light_unet/models/unet3d.py`` of the upstream
repository): a 4-level encoder and decoder of residual blocks, each
conv -> InstanceNorm -> LeakyReLU(0.01) -> channel dropout -> conv ->
InstanceNorm -> + shortcut -> LeakyReLU, the convs depthwise-separable
3^3 (or grouped / plain 3^3), 1^3 conv + InstanceNorm shortcuts where the
width changes, 2x max-pool down, 2x transposed conv up with the skip
concatenated after it (the upsampled tensor padded to the skip's size),
a 1^3 head and a sigmoid.  Parameter names are the published model's, so
one state dict serves the program and this reference.

``quant`` (identity by default) rounds every convolution's input, weight
and output, every norm's output and every block's output: the control of
a cell runs this model with a lower-precision ``quant`` (``fake_quant``).
Inference only: channel dropout is off in evaluation, so it is left out.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

IN_EPS = 1e-5
SLOPE = 0.01


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _round_to(x: torch.Tensor, dtype) -> torch.Tensor:
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


def fake_quant(dtype=torch.float8_e4m3fn) -> Callable[[torch.Tensor], torch.Tensor]:
    """A ``quant`` that computes in fp8 as fp8 inference does: values in
    e4m3, each tensor scaled to the type's range."""
    return lambda t: _round_to(t, dtype)


class Conv(nn.Conv3d):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        w = self.quant(self.weight)
        return self.quant(F.conv3d(self.quant(x), w, self.bias, self.stride, self.padding,
                                   self.dilation, self.groups))


class UpConv(nn.ConvTranspose3d):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self.quant(F.conv_transpose3d(self.quant(x), self.quant(self.weight), self.bias,
                                             self.stride))


class SeparableConv(nn.Module):
    def __init__(self, cin: int, cout: int, quant):
        super().__init__()
        self.depthwise = Conv(cin, cin, 3, padding=1, groups=cin, bias=False, quant=quant)
        self.pointwise = Conv(cin, cout, 1, bias=False, quant=quant)

    def forward(self, x):
        return self.pointwise(self.depthwise(x))


class Norm(nn.Module):
    def __init__(self, c: int, quant=identity):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.quant = quant

    def forward(self, x):
        return self.quant(F.instance_norm(x, weight=self.weight, bias=self.bias, eps=IN_EPS))


class Block(nn.Module):
    def __init__(self, cin: int, c: int, model: dict, quant, grouped: bool = True):
        super().__init__()
        self.conv1 = self._conv(cin, c, model, quant, grouped)
        self.norm1 = Norm(c, quant)
        self.conv2 = self._conv(c, c, model, quant, grouped)
        self.norm2 = Norm(c, quant)
        self.shortcut = (nn.Sequential(Conv(cin, c, 1, bias=False, quant=quant), Norm(c, quant))
                         if cin != c else None)
        self.quant = quant

    @staticmethod
    def _conv(cin, c, model, quant, grouped):
        if model.get("use_depthwise_separable", True):
            return SeparableConv(cin, c, quant)
        g = int(model.get("groups", 8))
        if not (grouped and model.get("use_grouped_conv", True) and g > 1 and cin >= g and c >= g):
            g = 1
        return Conv(cin, c, 3, padding=1, groups=g, bias=False, quant=quant)

    def forward(self, x):
        res = x if self.shortcut is None else self.shortcut(x)
        h = F.leaky_relu(self.norm1(self.conv1(x)), SLOPE)
        h = self.norm2(self.conv2(h))
        return self.quant(F.leaky_relu(h + res, SLOPE))


class Down(nn.Module):
    def __init__(self, cin, c, model, quant):
        super().__init__()
        self.res_block = Block(cin, c, model, quant)

    def forward(self, x):
        return self.res_block(F.max_pool3d(x, 2))


class Up(nn.Module):
    def __init__(self, cin, c, model, quant):
        super().__init__()
        self.up = UpConv(cin, cin // 2, 2, stride=2, quant=quant)
        self.res_block = Block(cin // 2 + c, c, model, quant)

    def forward(self, x, skip):
        x = self.up(x)
        pads = []
        for axis in (4, 3, 2):
            diff = skip.shape[axis] - x.shape[axis]
            pads += [diff // 2, diff - diff // 2]
        if any(pads):
            x = F.pad(x, pads)
        return self.res_block(torch.cat([x, skip], dim=1))


class UNet(nn.Module):
    """``[B, 1, D, H, W]`` -> sigmoid probabilities ``[B, 1, D, H, W]``."""

    def __init__(self, model: dict, quant=identity):
        super().__init__()
        ch: Sequence[int] = list(model["encoder_channels"])
        self.init_conv = Block(1, ch[0], model, quant, grouped=False)
        self.down1 = Down(ch[0], ch[1], model, quant)
        self.down2 = Down(ch[1], ch[2], model, quant)
        self.down3 = Down(ch[2], ch[3], model, quant)
        self.bottleneck = Block(ch[3], ch[3], model, quant)
        self.up1 = Up(ch[3], ch[2], model, quant)
        self.up2 = Up(ch[2], ch[1], model, quant)
        self.up3 = Up(ch[1], ch[0], model, quant)
        self.out_conv = Conv(ch[0], int(model.get("output_channels", 1)), 1, quant=quant)

    def forward(self, x):
        x1 = self.init_conv(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        y = self.bottleneck(x4)
        y = self.up1(y, x3)
        y = self.up2(y, x2)
        y = self.up3(y, x1)
        return torch.sigmoid(self.out_conv(y))


def no_tf32():
    """Turn TF32 off for cuDNN and matmuls (a float32 reference must not
    round its inputs to TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
