"""MedNeXt v1 in plain PyTorch, float32, channels first.

The published model (Roy et al., "MedNeXt: Transformer-driven Scaling of
ConvNets for Medical Image Segmentation", MICCAI 2023, arXiv:2303.09975;
``nnunet_mednext/mednextv1/MedNextV1.py`` and ``blocks.py`` of
https://github.com/MIC-DKFZ/MedNeXt), written out from its layer equations.
``create_mednextv1_large`` sets ``n_channels`` 32, ``exp_r`` and
``block_counts`` [3, 4, 8, 8, 8, 8, 8, 4, 3], ``do_res`` and
``do_res_up_down`` on, ``norm_type`` 'group', GRN off; the kernel size is
the configuration's.

* **Block(C, C', r)**: ``conv1`` depthwise k^3 (stride 1, padding k // 2,
  groups C, bias), ``norm`` ``GroupNorm(C, C)`` (eps 1e-5, affine),
  ``conv2`` 1^3 C -> rC, exact GELU, ``conv3`` 1^3 rC -> C', and with
  ``do_res`` the residual ``x + h``.
* **Down(C -> C', r)**: the block with ``conv1`` at stride 2 and no inner
  residual, plus ``res_conv`` (1^3, stride 2, C -> C', bias) of the input.
* **Up(C -> C', r)**: the block with ``conv1`` a depthwise k^3 transposed
  conv (stride 2, padding k // 2, groups C, bias: 2n - 1 voxels an axis) and
  no inner residual, padded by one voxel at the start of each axis, plus
  ``res_conv`` (a 1^3 stride-2 transposed conv, C -> C', bias) of the input,
  padded the same way.
* **Net**: ``stem`` (1^3, 1 -> C), four encoder stages of blocks each
  followed by a Down, the ``bottleneck``, four Ups each added to the
  encoder stage's output and followed by a decoder stage, ``out_0`` (a 1^3
  transposed conv, C -> classes, bias).

Parameter names are upstream's (``dummy_tensor`` included), so one state
dict serves the program and this reference.  Departures: the head has one
output channel and a sigmoid (the system's lesion probability); inference
only, deep supervision off (its heads ``out_1`` .. ``out_4`` are not built).

``quant`` (identity by default) rounds every convolution's input, weight
and output, every norm's output and every block's output: the control of a
cell runs this model with a lower-precision ``quant``.  Call ``no_tf32()``
before comparing on a card.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

GN_EPS = 1e-5


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def no_tf32():
    """Turn TF32 off for cuDNN and matmuls (a float32 reference must not
    round its inputs to TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class Conv(nn.Conv3d):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self.quant(F.conv3d(self.quant(x), self.quant(self.weight), self.bias,
                                   self.stride, self.padding, self.dilation, self.groups))


class UpConv(nn.ConvTranspose3d):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self.quant(F.conv_transpose3d(self.quant(x), self.quant(self.weight), self.bias,
                                             self.stride, self.padding, self.output_padding,
                                             self.groups))


class Norm(nn.GroupNorm):
    def __init__(self, c: int, quant=identity):
        super().__init__(c, c, eps=GN_EPS)
        self.quant = quant

    def forward(self, x):
        return self.quant(super().forward(x))


class Block(nn.Module):
    """MedNeXtBlock; ``kind`` 'down' or 'up' makes ``conv1`` the resampling
    conv of MedNeXtDownBlock / MedNeXtUpBlock (and drops the inner residual)."""

    def __init__(self, cin: int, cout: int, r: int, k: int, quant=identity, kind: str = "",
                 do_res: bool = True):
        super().__init__()
        self.quant, self.kind = quant, kind
        self.do_res = do_res and not kind
        if kind == "up":
            self.conv1 = UpConv(cin, cin, k, stride=2, padding=k // 2, groups=cin, quant=quant)
        else:
            self.conv1 = Conv(cin, cin, k, stride=2 if kind else 1, padding=k // 2, groups=cin,
                              quant=quant)
        self.norm = Norm(cin, quant)
        self.conv2 = Conv(cin, r * cin, 1, quant=quant)
        self.conv3 = Conv(r * cin, cout, 1, quant=quant)
        if kind == "down":
            self.res_conv = Conv(cin, cout, 1, stride=2, quant=quant)
        elif kind == "up":
            self.res_conv = UpConv(cin, cout, 1, stride=2, quant=quant)

    def forward(self, x):
        h = self.conv3(F.gelu(self.conv2(self.norm(self.conv1(x)))))
        if self.kind == "down":
            h = h + self.res_conv(x)
        elif self.kind == "up":
            pad = (1, 0, 1, 0, 1, 0)
            h = F.pad(h, pad) + F.pad(self.res_conv(x), pad)
        elif self.do_res:
            h = x + h
        return self.quant(h)


class MedNeXt(nn.Module):
    """``[B, 1, D, H, W]`` -> sigmoid probabilities ``[B, 1, D, H, W]`` (every
    dim a multiple of 16); ``model`` is the configuration's ``model`` group
    (``n_channels``, ``exp_r``, ``block_counts``, ``kernel_size``,
    ``output_channels``)."""

    def __init__(self, model: dict, quant: Callable = identity):
        super().__init__()
        n, k = int(model["n_channels"]), int(model["kernel_size"])
        r: Sequence[int] = [int(v) for v in model["exp_r"]]
        counts: Sequence[int] = [int(v) for v in model["block_counts"]]
        width = [n, 2 * n, 4 * n, 8 * n, 16 * n, 8 * n, 4 * n, 2 * n, n]

        def stage(i):
            return nn.Sequential(*[Block(width[i], width[i], r[i], k, quant)
                                   for _ in range(counts[i])])

        self.stem = Conv(1, n, 1, quant=quant)
        for i in range(4):
            setattr(self, f"enc_block_{i}", stage(i))
            setattr(self, f"down_{i}", Block(width[i], 2 * width[i], r[i + 1], k, quant, "down"))
        self.bottleneck = stage(4)
        for j, i in enumerate((3, 2, 1, 0)):
            setattr(self, f"up_{i}", Block(width[4 + j], width[5 + j], r[5 + j], k, quant, "up"))
            setattr(self, f"dec_block_{i}", stage(5 + j))
        self.out_0 = nn.Module()
        self.out_0.conv_out = UpConv(n, int(model.get("output_channels", 1)), 1, quant=quant)
        # upstream keeps it for its checkpointing; it computes nothing
        self.dummy_tensor = nn.Parameter(torch.tensor([1.0]))

    def forward(self, x):
        x = self.stem(x)
        skips = []
        for i in range(4):
            x = getattr(self, f"enc_block_{i}")(x)
            skips.append(x)
            x = getattr(self, f"down_{i}")(x)
        x = self.bottleneck(x)
        for i in (3, 2, 1, 0):
            x = getattr(self, f"dec_block_{i}")(skips[i] + getattr(self, f"up_{i}")(x))
        return torch.sigmoid(self.out_0.conv_out(x))


def parameter_shapes(model: dict) -> list:
    """(name, shape) of every parameter, in order, built on the meta device."""
    with torch.device("meta"):
        return [(n, p.shape) for n, p in MedNeXt(model).named_parameters()]
