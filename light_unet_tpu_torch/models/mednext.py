"""MedNeXt v1 (Roy et al., "MedNeXt: Transformer-driven Scaling of ConvNets
for Medical Image Segmentation", MICCAI 2023, arXiv:2303.09975;
https://github.com/MIC-DKFZ/MedNeXt, ``nnunet_mednext/mednextv1``), for
inference on the port's serving path.

The layer equations are upstream's (``blocks.py``, ``MedNextV1.py``), at the
widths of the configuration (``model.n_channels``, ``exp_r``,
``block_counts``, ``kernel_size``); ``create_mednextv1_large`` sets 32,
[3, 4, 8, 8, 8, 8, 8, 4, 3] twice, ``do_res`` and ``do_res_up_down`` on,
``norm_type`` 'group' and GRN off, which are fixed here.  Tensors are
``[B, D, H, W, C]``; every conv has a bias, as upstream's ``nn.Conv3d``.

* **Block(C, C', r)**: ``h = DW(x)``, a depthwise k^3 conv (stride 1,
  padding k // 2, groups C, bias); ``h = GN(h)``, ``GroupNorm(C, C)``:
  biased statistics per sample and channel over D*H*W, eps 1e-5, affine;
  ``h = GELU(W2 h + b2)`` (a 1^3 conv C -> rC, exact erf GELU);
  ``h = W3 h + b3`` (1^3, rC -> C'); ``y = x + h``.
* **Down(C -> C', r)**: the block with DW at stride 2 and no inner residual,
  then ``y = h + R(x)``, ``R`` a 1^3 stride-2 conv C -> C' with bias.
* **Up(C -> C', r)**: the block with DW a depthwise k^3 *transposed* conv
  (stride 2, padding k // 2, groups C, bias: 2n - 1 voxels an axis) and no
  inner residual, then ``y = pad(h) + pad(RT(x))``, each padded by one voxel
  at the start of every axis, ``RT`` a 1^3 stride-2 transposed conv C -> C'
  with bias (``W x + b`` at the even voxels of its 2n - 1, ``b`` at the odd).
* **Net**: ``stem`` (1^3, 1 -> n); ``enc_block_i`` (``block_counts[i]``
  blocks at ``n 2^i``, ratio ``exp_r[i]``) each followed by ``down_i``
  (ratio ``exp_r[i + 1]``), i = 0..3; ``bottleneck`` (16 n, ``exp_r[4]``);
  ``up_i`` (ratio ``exp_r[8 - i]``) plus ``enc_block_i``'s output, then
  ``dec_block_i`` (``block_counts[8 - i]`` blocks), i = 3..0; ``out_0`` (a
  1^3 transposed conv, n -> classes, bias) and a sigmoid in float32.

How the port computes them: every 1^3 conv (stem, W2, W3, R, RT, the head)
is one channels-last matmul with bias (``F.linear``; R on the input's even
voxels; RT's product added at the odd voxels of the padded output, its bias
at every voxel but the pad); each block's DW at k = 5 runs the hand-written
5^3 kernel (``ops/depthwise_kernel.py:depthwise_conv3d_k5``: the ``dw5_*``
CUDA kernels on a card, the plain ``F.conv3d`` on the CPU) while autograd
does not record (``unet3d.runs_inference``), and each GN runs the fused norm
kernel K2 with its affine scale and bias and slope 1.0
(``unet3d.InstanceNorm``: ``GroupNorm(C, C)`` is an affine InstanceNorm);
the 8 resampling depthwise convs run PyTorch's grouped convolutions, each
kind in the layout that is faster on the card (the strided ones on a
channels-first copy, the transposed ones on the channels-last view;
PERF.md).  The residual and skip adds go into the
fresh output of the matmul or pad before them, and the GELU runs in place
where autograd does not record.  Rounding points are SwinUNETR's: float32
parameters cast to the compute dtype at each conv or matmul, norm
statistics in float32, outputs in the compute dtype, the head and its
sigmoid in float32.

State-dict keys are upstream's (``stem.weight``,
``enc_block_0.0.conv1.weight``, ``down_0.res_conv.bias``,
``up_0.conv1.weight``, ``out_0.conv_out.weight``, ``dummy_tensor``), so an
upstream state dict with a 1-channel head loads with ``strict=True``; the
deep-supervision heads ``out_1`` .. ``out_4`` of a checkpoint trained with
them are dropped on load (inference uses ``out_0`` alone).

Departures from upstream, by design: the head has ``output_channels`` (1)
and a sigmoid, the pipeline's lesion-probability contract; inference only
(no deep supervision, no checkpointing: the port does not train this model);
at kernel size 3 the block convs take ``F.conv3d`` on a card (the 3^3
kernel takes no bias); on a card the 5^3 kernel takes a multiple of 8
channels.

Spans (``utils/tracing.py``): ``mednext.stem``, ``mednext.enc{0..3}``,
``mednext.down{0..3}``, ``mednext.bottleneck``, ``mednext.up{0..3}``,
``mednext.dec{0..3}``, ``mednext.out``.  Counters (``counts``, registered
with ``tracing.register_counts``: ``mednext.<name>`` in
``tracing.snapshot()``): forwards, blocks, block convs sent to the 5^3
kernel's wrapper (``dw5_calls``) and resampling convs; like the kernels'
``launches`` they count always, and a CUDA graph replay advances them by what
its capture recorded (``utils/graphs.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from light_unet_tpu_torch.config import MEDNEXT_DEFAULTS as LARGE
from light_unet_tpu_torch.models.unet3d import (
    Conv3d,
    InstanceNorm,
    runs_inference,
    to_ncdhw,
    to_ndhwc,
)
from light_unet_tpu_torch.ops.depthwise_kernel import depthwise_conv3d_k5
from light_unet_tpu_torch.utils import tracing


# what every forward adds; a graph replay adds what its capture recorded
counts = tracing.register_counts("mednext", {
    "forwards": 0, "blocks": 0, "dw5_calls": 0, "resample_convs": 0})


def _gelu(h: torch.Tensor) -> torch.Tensor:
    """Exact GELU, in place where autograd does not record (its backward
    reads its input)."""
    return F.gelu(h) if torch.is_grad_enabled() and h.requires_grad else torch.ops.aten.gelu_(h)


def _named(**modules) -> nn.Sequential:
    """A one-module ``nn.Sequential`` whose child carries upstream's name."""
    return nn.Sequential(OrderedDict(modules))


class Pointwise(Conv3d):
    """A 1^3 convolution with bias (upstream's ``nn.Conv3d(cin, cout, 1)``) as
    one channels-last matmul in the compute dtype; ``stride`` 2 takes the
    input's even voxels."""

    def __init__(self, cin: int, cout: int, stride: int = 1, compute_dtype=torch.float32):
        super().__init__(cin, cout, 1, stride=stride, compute_dtype=compute_dtype)

    def forward(self, x):
        if self.stride[0] > 1:
            s = self.stride[0]
            x = x[:, ::s, ::s, ::s]
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.view(self.out_channels, -1).to(dt),
                        self.bias.to(dt))


class PointwiseT(nn.ConvTranspose3d):
    """A 1^3 transposed convolution with bias (``nn.ConvTranspose3d(cin, cout,
    1)``, weight [cin, cout, 1, 1, 1]): ``matmul`` is its product without the
    bias, one channels-last matmul in ``compute_dtype``."""

    def __init__(self, cin: int, cout: int, stride: int = 1, compute_dtype=torch.float32):
        super().__init__(cin, cout, 1, stride=stride)
        self.compute_dtype = compute_dtype

    def matmul(self, x, bias=None):
        dt = self.compute_dtype
        w = self.weight.view(self.in_channels, self.out_channels).t().to(dt)
        return F.linear(x.to(dt), w, None if bias is None else bias.to(dt))

    def forward(self, x):  # stride 1: the head
        return self.matmul(x, self.bias)


class BlockConv(Conv3d):
    """A block's depthwise k^3 conv (stride 1, padding k // 2, groups C,
    bias).  At k = 5 in inference (``runs_inference``) it runs the 5^3 kernel
    (``depthwise_conv3d_k5``); otherwise ``Conv3d`` (``F.conv3d`` on the
    channels-last view)."""

    def __init__(self, channels: int, k: int, compute_dtype=torch.float32):
        super().__init__(channels, channels, k, padding=k // 2, groups=channels,
                         compute_dtype=compute_dtype)

    def forward(self, x):
        if self.kernel_size[0] != 5 or not runs_inference(self, x, self.weight, self.bias):
            return super().forward(x)
        counts["dw5_calls"] += 1
        return depthwise_conv3d_k5(x.to(self.compute_dtype).contiguous(), self.weight, self.bias)


class DownConv(Conv3d):
    """Down's depthwise k^3 stride-2 conv (padding k // 2, groups C, bias), on
    a channels-first copy: 2.6-7.5x faster on the card than on the
    channels-last view at MedNeXt-L's shapes (PERF.md)."""

    def __init__(self, channels: int, k: int, compute_dtype=torch.float32):
        super().__init__(channels, channels, k, stride=2, padding=k // 2, groups=channels,
                         compute_dtype=compute_dtype)

    def forward(self, x):
        counts["resample_convs"] += 1
        dt = self.compute_dtype
        xc = to_ncdhw(x.to(dt)).contiguous()
        y = F.conv3d(xc, self.weight.to(dt), self.bias.to(dt), 2, self.padding, 1, self.groups)
        return to_ndhwc(y).contiguous()


class UpConv(nn.ConvTranspose3d):
    """Up's depthwise k^3 stride-2 transposed conv (padding k // 2, groups C,
    bias): n voxels an axis become 2n - 1.  On the channels-last view, a few
    percent faster on the card than on a copy (PERF.md)."""

    def __init__(self, channels: int, k: int, compute_dtype=torch.float32):
        super().__init__(channels, channels, k, stride=2, padding=k // 2, groups=channels)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        counts["resample_convs"] += 1
        dt = self.compute_dtype
        y = F.conv_transpose3d(to_ncdhw(x.to(dt)), self.weight.to(dt), self.bias.to(dt), 2,
                               self.padding, 0, self.groups)
        return to_ndhwc(y).contiguous()


class Block(nn.Module):
    """MedNeXtBlock (``kind`` ''), MedNeXtDownBlock ('down') or
    MedNeXtUpBlock ('up'), under upstream's names: ``conv1``, ``norm``,
    ``conv2``, ``conv3``, and ``res_conv`` for a resampling block."""

    def __init__(self, cin: int, cout: int, r: int, k: int, kind: str = "",
                 compute_dtype=torch.float32):
        super().__init__()
        dt = compute_dtype
        self.kind = kind
        if kind == "down":
            self.conv1 = DownConv(cin, k, dt)
        elif kind == "up":
            self.conv1 = UpConv(cin, k, dt)
        else:
            self.conv1 = BlockConv(cin, k, dt)
        self.norm = InstanceNorm(cin)  # GroupNorm(C, C): affine, slope 1.0
        self.conv2 = Pointwise(cin, r * cin, compute_dtype=dt)
        self.conv3 = Pointwise(r * cin, cout, compute_dtype=dt)
        if kind == "down":
            self.res_conv = Pointwise(cin, cout, stride=2, compute_dtype=dt)
        elif kind == "up":
            self.res_conv = PointwiseT(cin, cout, stride=2, compute_dtype=dt)

    def forward(self, x):
        if not self.kind:
            counts["blocks"] += 1
        h = self.conv3(_gelu(self.conv2(self.norm(self.conv1(x)))))
        if self.kind == "down":
            return h.add_(self.res_conv(x))
        if self.kind == "up":
            # pad(h) + pad(RT(x)): RT's bias at every voxel of its 2n - 1, its
            # product at the even ones (odd after the one-voxel pad)
            y = F.pad(h, (0, 0, 1, 0, 1, 0, 1, 0))
            y[:, 1:, 1:, 1:].add_(self.res_conv.bias.to(y.dtype))
            y[:, 1::2, 1::2, 1::2].add_(self.res_conv.matmul(x))
            return y
        return h.add_(x)


class MedNeXt(nn.Module):
    """Input ``[B, D, H, W, 1]`` (every dim a multiple of 16) -> sigmoid
    probabilities ``[B, D, H, W, out_channels]`` in float32."""

    def __init__(self, out_channels: int = 1, n_channels: int = 32,
                 exp_r: Sequence[int] = tuple(LARGE["exp_r"]),
                 block_counts: Sequence[int] = tuple(LARGE["block_counts"]),
                 kernel_size: int = 5, compute_dtype=torch.float32):
        super().__init__()
        n, k, dt = n_channels, kernel_size, compute_dtype
        self.compute_dtype = compute_dtype
        width = [n, 2 * n, 4 * n, 8 * n, 16 * n, 8 * n, 4 * n, 2 * n, n]

        def stage(i):
            return nn.Sequential(*[Block(width[i], width[i], exp_r[i], k, compute_dtype=dt)
                                   for _ in range(block_counts[i])])

        # upstream keeps it for its checkpointing; it computes nothing
        self.dummy_tensor = nn.Parameter(torch.tensor([1.0]))
        self.stem = Pointwise(1, n, compute_dtype=dt)
        for i in range(4):
            setattr(self, f"enc_block_{i}", stage(i))
            setattr(self, f"down_{i}", Block(width[i], 2 * width[i], exp_r[i + 1], k, "down", dt))
        self.bottleneck = stage(4)
        for j, i in enumerate((3, 2, 1, 0)):
            setattr(self, f"up_{i}", Block(width[4 + j], width[5 + j], exp_r[5 + j], k, "up", dt))
            setattr(self, f"dec_block_{i}", stage(5 + j))
        # float32, as the lightweight U-Net's head
        self.out_0 = _named(conv_out=PointwiseT(n, out_channels))
        self.register_load_state_dict_pre_hook(_drop_deep_supervision)

    def forward(self, x):
        counts["forwards"] += 1
        with tracing.span("mednext.stem"):
            x = self.stem(x.to(self.compute_dtype))
        skips = []
        for i in range(4):
            with tracing.span(f"mednext.enc{i}"):
                x = getattr(self, f"enc_block_{i}")(x)
            skips.append(x)
            with tracing.span(f"mednext.down{i}"):
                x = getattr(self, f"down_{i}")(x)
        with tracing.span("mednext.bottleneck"):
            x = self.bottleneck(x)
        for i in (3, 2, 1, 0):
            with tracing.span(f"mednext.up{i}"):
                x = getattr(self, f"up_{i}")(x).add_(skips.pop())
            with tracing.span(f"mednext.dec{i}"):
                x = getattr(self, f"dec_block_{i}")(x)
        with tracing.span("mednext.out"):
            return torch.sigmoid(self.out_0(x.float()))


def _drop_deep_supervision(module, state_dict, prefix, *rest):
    """Drop the heads ``out_1`` .. ``out_4`` of a checkpoint trained with deep
    supervision: inference reads ``out_0`` alone."""
    for key in [k for k in state_dict if k.startswith(prefix)]:
        if key[len(prefix):].split(".")[0] in ("out_1", "out_2", "out_3", "out_4"):
            del state_dict[key]


def build_mednext(model_cfg, compute_dtype=torch.float32) -> MedNeXt:
    """The model of a validated ``ModelConfig`` named ``MedNeXt``."""
    return MedNeXt(out_channels=model_cfg.output_channels, n_channels=model_cfg.n_channels,
                   exp_r=tuple(model_cfg.exp_r), block_counts=tuple(model_cfg.block_counts),
                   kernel_size=model_cfg.kernel_size, compute_dtype=compute_dtype)
