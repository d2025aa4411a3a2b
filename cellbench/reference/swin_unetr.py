"""SwinUNETR in plain PyTorch, float32, channels first.

The published model (Hatamizadeh et al., arXiv:2201.01266; MONAI's
``monai.networks.nets.SwinUNETR`` with its BTCV settings: feature size 48,
depths (2, 2, 2, 2), heads (3, 6, 12, 24), window 7, patch 2, MLP ratio 4,
qkv bias, non-affine instance norms, ``normalize`` on, v1 patch merging),
written out from MONAI's layer equations: ``get_window_size``,
``window_partition`` / ``window_reverse``, ``compute_mask``, the
relative-position index of a 7^3 window (a smaller window takes its
top-left block), the attention materialised (``q * scale @ k^T`` + bias +
mask, softmax, ``@ v``), MONAI's merge order, ``UnetResBlock``,
``UnetrUpBlock``, ``UnetOutBlock``.  Parameter and buffer names are MONAI's,
so one state dict serves the program and this reference.  The widths are
the configuration's ``model`` group (``feature_size``, ``depths``,
``num_heads``, ``window_size``, ``mlp_ratio``, ``output_channels``); the
patch embedding's 2, the v1 merge and the hidden states' LayerNorm
(``normalize``) are MONAI's defaults and fixed here.

Departures from MONAI: the head has one output channel and a sigmoid (the
system's lesion probability); inference only (no dropout or drop path).

``quant`` (identity by default) rounds every linear's and convolution's
input, weight and output, every norm's output, the attention's
probabilities and every block's output: the control of a cell runs this
model with a lower-precision ``quant``.  Call ``no_tf32()`` before comparing
on a card.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5
IN_EPS = 1e-5
SLOPE = 0.01
PATCH = 2  # the patch embedding's kernel and stride


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def no_tf32():
    """Turn TF32 off for cuDNN and matmuls (a float32 reference must not
    round its inputs to TF32)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def get_window_size(x_size, window_size, shift_size):
    use_window, use_shift = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def window_partition(x, ws):
    """[b, d, h, w, c] -> [b * windows, n, c]."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows, ws, dims):
    """[b * windows, n, c] -> [b, d, h, w, c]."""
    b, d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(b, d, h, w, -1)


def compute_mask(dims, ws, ss, device):
    cnt = 0
    d, h, w = dims
    img_mask = torch.zeros((1, d, h, w, 1), device=device)
    for a in slice(-ws[0]), slice(-ws[0], -ss[0]), slice(-ss[0], None):
        for b in slice(-ws[1]), slice(-ws[1], -ss[1]), slice(-ss[1], None):
            for c in slice(-ws[2]), slice(-ws[2], -ss[2]), slice(-ss[2], None):
                img_mask[:, a, b, c, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, ws).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def relative_position_index(ws) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws[0]), torch.arange(ws[1]),
                                        torch.arange(ws[2]), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


class Linear(nn.Linear):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self.quant(F.linear(self.quant(x), self.quant(self.weight), self.bias))


class LayerNorm(nn.LayerNorm):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self.quant(super().forward(x))


class Conv(nn.Conv3d):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self.quant(F.conv3d(self.quant(x), self.quant(self.weight), self.bias,
                                   self.stride, self.padding))


class UpConv(nn.ConvTranspose3d):
    def __init__(self, *args, quant=identity, **kwargs):
        super().__init__(*args, **kwargs)
        self.quant = quant

    def forward(self, x):
        return self.quant(F.conv_transpose3d(self.quant(x), self.quant(self.weight), self.bias,
                                             self.stride))


def _seq(**modules) -> nn.Sequential:
    return nn.Sequential(OrderedDict(modules))


class WindowAttention(nn.Module):
    def __init__(self, dim, num_heads, window_size, quant=identity):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.quant = quant
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size[0] - 1) * (2 * window_size[1] - 1)
                        * (2 * window_size[2] - 1), num_heads))
        self.register_buffer("relative_position_index", relative_position_index(window_size))
        self.qkv = Linear(dim, dim * 3, bias=True, quant=quant)
        self.proj = Linear(dim, dim, quant=quant)

    def forward(self, x, mask):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, c // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        q = q * self.scale
        attn = q @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[
            self.relative_position_index.clone()[:n, :n].reshape(-1)].reshape(n, n, -1)
        attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(b // nw, nw, self.num_heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, n, n)
        attn = self.quant(torch.softmax(attn, dim=-1))
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class MLPBlock(nn.Module):
    def __init__(self, dim, hidden, quant=identity):
        super().__init__()
        self.linear1 = Linear(dim, hidden, quant=quant)
        self.linear2 = Linear(hidden, dim, quant=quant)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, num_heads, window_size, shift_size, mlp_ratio, quant=identity):
        super().__init__()
        self.window_size, self.shift_size, self.quant = window_size, shift_size, quant
        self.norm1 = LayerNorm(dim, eps=LN_EPS, quant=quant)
        self.attn = WindowAttention(dim, num_heads, window_size, quant)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, quant=quant)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), quant)

    def forward_part1(self, x, mask_matrix):
        x = self.norm1(x)
        b, d, h, w, c = x.shape
        ws, ss = get_window_size((d, h, w), self.window_size, self.shift_size)
        pad_d1 = (ws[0] - d % ws[0]) % ws[0]
        pad_b = (ws[1] - h % ws[1]) % ws[1]
        pad_r = (ws[2] - w % ws[2]) % ws[2]
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b, 0, pad_d1))
        _, dp, hp, wp, _ = x.shape
        if any(i > 0 for i in ss):
            shifted_x = torch.roll(x, shifts=(-ss[0], -ss[1], -ss[2]), dims=(1, 2, 3))
            attn_mask = mask_matrix
        else:
            shifted_x, attn_mask = x, None
        attn_windows = self.attn(window_partition(shifted_x, ws), mask=attn_mask)
        shifted_x = window_reverse(attn_windows.view(-1, *(ws + (c,))), ws, [b, dp, hp, wp])
        if any(i > 0 for i in ss):
            x = torch.roll(shifted_x, shifts=ss, dims=(1, 2, 3))
        else:
            x = shifted_x
        return x[:, :d, :h, :w, :].contiguous()

    def forward(self, x, mask_matrix):
        x = x + self.forward_part1(x, mask_matrix)
        return self.quant(x + self.mlp(self.norm2(x)))


class PatchMerging(nn.Module):
    def __init__(self, dim, quant=identity):
        super().__init__()
        self.reduction = Linear(8 * dim, 2 * dim, bias=False, quant=quant)
        self.norm = LayerNorm(8 * dim, eps=LN_EPS, quant=quant)

    def forward(self, x):
        b, d, h, w, c = x.shape
        if (h % 2 == 1) or (w % 2 == 1) or (d % 2 == 1):
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x0 = x[:, 0::2, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, 0::2, :]
        x3 = x[:, 0::2, 0::2, 1::2, :]
        x4 = x[:, 1::2, 0::2, 1::2, :]
        x5 = x[:, 0::2, 1::2, 0::2, :]
        x6 = x[:, 0::2, 0::2, 1::2, :]
        x7 = x[:, 1::2, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3, x4, x5, x6, x7], -1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, depth, num_heads, window_size, mlp_ratio, quant=identity):
        super().__init__()
        self.window_size = window_size
        self.shift_size = tuple(i // 2 for i in window_size)
        self.no_shift = tuple(0 for _ in window_size)
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window_size,
                                 self.no_shift if i % 2 == 0 else self.shift_size, mlp_ratio,
                                 quant)
            for i in range(depth))
        self.downsample = PatchMerging(dim, quant)

    def forward(self, x):
        b, c, d, h, w = x.shape
        ws, ss = get_window_size((d, h, w), self.window_size, self.shift_size)
        x = x.permute(0, 2, 3, 4, 1)
        dp = -(-d // ws[0]) * ws[0]
        hp = -(-h // ws[1]) * ws[1]
        wp = -(-w // ws[2]) * ws[2]
        attn_mask = compute_mask([dp, hp, wp], ws, ss, x.device)
        for blk in self.blocks:
            x = blk(x, attn_mask)
        x = self.downsample(x.view(b, d, h, w, -1))
        return x.permute(0, 4, 1, 2, 3)


class SwinTransformer(nn.Module):
    def __init__(self, in_chans, embed_dim, window_size, patch_size, depths, num_heads,
                 mlp_ratio, quant=identity):
        super().__init__()
        self.patch_embed = _seq(proj=Conv(in_chans, embed_dim, patch_size, stride=patch_size,
                                          quant=quant))
        for i in range(len(depths)):
            layer = BasicLayer(int(embed_dim * 2 ** i), depths[i], num_heads[i], window_size,
                               mlp_ratio, quant)
            setattr(self, f"layers{i + 1}", nn.ModuleList([layer]))

    @staticmethod
    def proj_out(x):
        x = F.layer_norm(x.permute(0, 2, 3, 4, 1), [x.shape[1]], eps=LN_EPS)
        return x.permute(0, 4, 1, 2, 3)

    def forward(self, x):
        x0 = self.patch_embed(x)
        x1 = self.layers1[0](x0.contiguous())
        x2 = self.layers2[0](x1.contiguous())
        x3 = self.layers3[0](x2.contiguous())
        x4 = self.layers4[0](x3.contiguous())
        return [self.proj_out(t) for t in (x0, x1, x2, x3, x4)]


class UnetResBlock(nn.Module):
    def __init__(self, in_channels, out_channels, quant=identity):
        super().__init__()
        self.quant = quant
        self.conv1 = _seq(conv=Conv(in_channels, out_channels, 3, padding=1, bias=False,
                                    quant=quant))
        self.conv2 = _seq(conv=Conv(out_channels, out_channels, 3, padding=1, bias=False,
                                    quant=quant))
        if in_channels != out_channels:
            self.conv3 = _seq(conv=Conv(in_channels, out_channels, 1, bias=False, quant=quant))

    def norm(self, x):
        # F.instance_norm's op without its Python check, which refuses a
        # single voxel (the deepest state of a 32-voxel axis); its norm is 0
        return self.quant(torch.instance_norm(x, None, None, None, None, True, 0.0, IN_EPS,
                                              False))

    def forward(self, inp):
        out = F.leaky_relu(self.norm(self.conv1(inp)), SLOPE)
        out = self.norm(self.conv2(out))
        residual = self.norm(self.conv3(inp)) if hasattr(self, "conv3") else inp
        return self.quant(F.leaky_relu(out + residual, SLOPE))


class UnetrUpBlock(nn.Module):
    def __init__(self, in_channels, out_channels, quant=identity):
        super().__init__()
        self.transp_conv = _seq(conv=UpConv(in_channels, out_channels, 2, stride=2, bias=False,
                                            quant=quant))
        self.conv_block = UnetResBlock(2 * out_channels, out_channels, quant)

    def forward(self, inp, skip):
        return self.conv_block(torch.cat((self.transp_conv(inp), skip), dim=1))


class SwinUNETR(nn.Module):
    """``[B, 1, D, H, W]`` -> sigmoid probabilities ``[B, 1, D, H, W]``;
    ``model`` is the configuration's ``model`` group (MONAI's keys under the
    configuration's names, and ``output_channels``)."""

    def __init__(self, model: dict, quant: Callable = identity):
        super().__init__()
        fs = int(model["feature_size"])
        w = int(model["window_size"])
        self.swinViT = SwinTransformer(1, fs, (w, w, w), PATCH, model["depths"],
                                       model["num_heads"],
                                       float(model["mlp_ratio"]), quant)
        self.encoder1 = _seq(layer=UnetResBlock(1, fs, quant))
        self.encoder2 = _seq(layer=UnetResBlock(fs, fs, quant))
        self.encoder3 = _seq(layer=UnetResBlock(2 * fs, 2 * fs, quant))
        self.encoder4 = _seq(layer=UnetResBlock(4 * fs, 4 * fs, quant))
        self.encoder10 = _seq(layer=UnetResBlock(16 * fs, 16 * fs, quant))
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, quant)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, quant)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, quant)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, quant)
        self.decoder1 = UnetrUpBlock(fs, fs, quant)
        self.out = _seq(conv=_seq(conv=Conv(fs, int(model.get("output_channels", 1)), 1,
                                            bias=True, quant=quant)))

    def forward(self, x_in):
        hs = self.swinViT(x_in)
        enc0 = self.encoder1(x_in)
        enc1 = self.encoder2(hs[0])
        enc2 = self.encoder3(hs[1])
        enc3 = self.encoder4(hs[2])
        dec4 = self.encoder10(hs[4])
        dec3 = self.decoder5(dec4, hs[3])
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec0 = self.decoder2(dec1, enc1)
        out = self.decoder1(dec0, enc0)
        return torch.sigmoid(self.out(out))


def parameter_shapes(model: dict) -> list:
    """(name, shape) of every parameter, in order, built on the meta device."""
    with torch.device("meta"):
        return [(n, p.shape) for n, p in SwinUNETR(model).named_parameters()]
