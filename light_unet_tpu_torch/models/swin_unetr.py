"""SwinUNETR (Hatamizadeh et al., arXiv:2201.01266; MONAI's
``monai.networks.nets.SwinUNETR``), for inference on the port's serving path.

The layer equations are MONAI's, at the settings of its BTCV recipe:
``feature_size`` 48, ``depths`` (2, 2, 2, 2), ``num_heads`` (3, 6, 12, 24),
``window_size`` 7, patch 2, MLP ratio 4, ``qkv_bias``, non-affine instance
norms, ``normalize`` on, ``downsample="merging"``.  The widths are the
configuration's (``model.feature_size``, ``depths``, ``num_heads``,
``window_size``, ``mlp_ratio``); the patch embedding's 2, the v1 merge and
the hidden states' LayerNorm are MONAI's defaults and fixed here.

* **Encoder** (``swinViT``): ``patch_embed`` (a 2^3 stride-2 conv, bias, no
  norm), then four ``BasicLayer``s of two ``SwinTransformerBlock``s each,
  block ``j`` unshifted when ``j`` is even and shifted by ``window // 2``
  when odd, each layer ending in ``PatchMerging`` (the fourth too).  The
  hidden states are the patch embedding and the four layers' outputs, each
  through ``proj_out``: a LayerNorm over channels without affine, eps 1e-5.
* **Block**: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))`` (affine
  LayerNorms; Linear(d, 4d), exact GELU, Linear(4d, d)).  The attention
  zero-pads D, H and W at the end to multiples of the window after
  ``norm1``, rolls by -shift when shifted, attends within each window, rolls
  back and crops.  Padded tokens are not masked: they are zeros, so their
  keys and values are the biases, and they take part as keys.  On an axis
  of at most ``window`` voxels the window is the axis and the shift 0
  (MONAI's ``get_window_size``).
* **Window attention**: qkv Linear(d, 3d, bias), ``q k^T / sqrt(head_dim)``
  plus the relative-position bias, table[``index[:n, :n]``] for the ``n``
  tokens of a window, where ``index`` is built for the configured window
  (so a window smaller than it takes the top-left block of the index, as
  MONAI does), plus in shifted blocks the region mask (-100 between
  tokens of different regions, ``shift_mask``), softmax, ``@ v``, proj.
* **PatchMerging** (MONAI's v1 merge): odd dims padded, the eight
  ``x[a::2, b::2, c::2]`` concatenated in ``MERGE_ORDER`` (the 6th and 7th
  repeat the 3rd and 4th), LayerNorm(8d), Linear(8d, 2d, no bias).
* **Decoder**: ``UnetResBlock``s (the port's ``ResidualBlock`` on plain 3^3
  convolutions, without bias or dropout, non-affine norms) on the input and
  on hidden states 0, 1, 2 and 4; five ``UnetrUpBlock``s (a 2^3 stride-2
  transposed conv without bias, ``cat[up, skip]``, a ``UnetResBlock``); the
  1^3 head with bias.

Tensors are channels-last ``[B, D, H, W, C]``, the port's layout, so the
tokens need no transposes.  Rounding points follow ``models/unet3d.py``:
parameters stay float32 and are cast to the compute dtype at each matmul and
convolution; LayerNorm and InstanceNorm statistics are float32; outputs are in
the compute dtype; the head and its sigmoid run in float32.  Attention is
``F.scaled_dot_product_attention`` with one additive mask a block (bias plus
region mask, [1, windows x heads, n, n]); a block's windows and heads share
the attention's head axis, so the mask broadcasts over the batch.

State-dict keys are MONAI's (``swinViT.layers1.0.blocks.0.attn.qkv.weight``,
``encoder1.layer.conv1.conv.weight``, ``decoder5.transp_conv.conv.weight``,
``out.conv.conv.weight``, the ``relative_position_index`` buffers
included): ``UnetResBlock`` maps its ``ResidualBlock`` names to MONAI's both
ways, so a MONAI state dict loads with ``strict=True``.

Departures from MONAI, by design: the head has ``output_channels`` (1) and a
sigmoid, the pipeline's lesion-probability contract (MONAI's BTCV head has
14 logits); inference only (no dropout, drop path or checkpointing: the port
does not train this model); the patch embedding does not pad, since the
configuration holds every patch dim to a multiple of 32.

Spans (``utils/tracing.py``): ``swin.embed``, ``swin.stage{1..4}`` with
``.attn``, ``.mlp`` and ``.merge`` inside, ``swin.decoder``.  Counters
(``counts``, registered with ``tracing.register_counts``, so that
``tracing.snapshot()`` reports them as ``swin.<name>``): forwards, attention
calls, shifted calls, tokens attended and padded tokens attended.  Like the
kernels' ``launches`` they count always, and a CUDA graph replay advances
them by what its capture recorded (``utils/graphs.py``).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from light_unet_tpu_torch.models.unet3d import Conv3d, ConvTranspose3d, ResidualBlock
from light_unet_tpu_torch.utils import tracing

LN_EPS = 1e-5
MASK_VALUE = -100.0  # MONAI's compute_mask
MERGE_ORDER = ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (0, 1, 0), (0, 0, 1),
               (1, 1, 1))
MASK_ALIGN = 16  # the attention mask's rows are padded to this many elements
PATCH = 2  # the patch embedding's kernel and stride

# what every forward adds; a graph replay adds what its capture recorded
counts = tracing.register_counts("swin", {
    "forwards": 0, "attn.calls": 0, "attn.shifted_calls": 0, "attn.tokens": 0,
    "attn.pad_tokens": 0})


def window_and_shift(dims: Sequence[int], window: int, shift: int
                     ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """MONAI's ``get_window_size``: an axis of at most ``window`` voxels is
    one window and is not shifted."""
    return (tuple(d if d <= window else window for d in dims),
            tuple(0 if d <= window else shift for d in dims))


def padded_dims(dims: Sequence[int], ws: Sequence[int]) -> Tuple[int, ...]:
    return tuple(-(-d // w) * w for d, w in zip(dims, ws))


def window_partition(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, C] -> [B, windows, tokens, C], windows and their tokens
    in raster order (MONAI's ``window_partition``, the batch kept apart)."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws[0], ws[0], h // ws[1], ws[1], w // ws[2], ws[2], c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, -1, ws[0] * ws[1] * ws[2], c)


def window_reverse(windows: torch.Tensor, ws: Sequence[int], dims: Sequence[int]) -> torch.Tensor:
    """The inverse of ``window_partition``: [B, windows, tokens, C] ->
    [B, D, H, W, C]."""
    b, c = windows.shape[0], windows.shape[-1]
    d, h, w = dims
    x = windows.view(b, d // ws[0], h // ws[1], w // ws[2], ws[0], ws[1], ws[2], c)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, c)


def relative_position_index(window: int) -> torch.Tensor:
    """[window^3, window^3] int64 rows of the (2 window - 1)^3 bias table:
    pairwise coordinate differences of a window's tokens, shifted to be
    non-negative and flattened (MONAI's ``WindowAttention``)."""
    ar = torch.arange(window)
    coords = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    span = 2 * window - 1
    return rel[..., 0] * (span * span) + rel[..., 1] * span + rel[..., 2]


def shift_mask(dims: Sequence[int], ws: Sequence[int], ss: Sequence[int], device=None
               ) -> torch.Tensor:
    """MONAI's ``compute_mask`` over the padded ``dims``: [windows, n, n]
    float32, 0 where two tokens of a window lie in the same region of the
    shifted volume and -100 where not.  Regions are the slices ``[:-w]``,
    ``[-w:-s]``, ``[-s:]`` of each axis (on an axis with shift 0 the last
    slice is the whole axis, as in MONAI)."""
    img = torch.zeros((1, *dims, 1), device=device)
    cnt = 0
    axes = [(slice(-w), slice(-w, -s), slice(-s, None)) for w, s in zip(ws, ss)]
    for a in axes[0]:
        for b in axes[1]:
            for c in axes[2]:
                img[:, a, b, c, :] = cnt
                cnt += 1
    regions = window_partition(img, ws)[0, :, :, 0]
    diff = regions[:, None, :] - regions[:, :, None]
    return torch.where(diff != 0, MASK_VALUE, 0.0)


class Linear(nn.Linear):
    """``nn.Linear`` computed in ``compute_dtype``."""

    def __init__(self, *args, compute_dtype=torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with float32 statistics, output in the input dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias,
                            self.eps).to(x.dtype)


def _named(**modules) -> nn.Sequential:
    """A one-module ``nn.Sequential`` whose child carries MONAI's name."""
    return nn.Sequential(OrderedDict(modules))


class WindowAttention(nn.Module):
    """Multi-head attention inside each window, with the relative-position
    bias and, in shifted blocks, the region mask."""

    def __init__(self, dim: int, heads: int, window: int, compute_dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        self.compute_dtype = compute_dtype
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 3, heads))
        self.register_buffer("relative_position_index", relative_position_index(window))
        self.qkv = Linear(dim, 3 * dim, bias=True, compute_dtype=compute_dtype)
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype)

    def attention_mask(self, n: int, windows: int, region=None) -> torch.Tensor:
        """The additive mask of one block: [1, windows x heads, n, n] in the
        compute dtype, each row padded to ``MASK_ALIGN`` elements so that the
        attention kernel takes it without a copy."""
        h = self.heads
        idx = self.relative_position_index[:n, :n].reshape(-1)
        bias = self.relative_position_bias_table[idx].view(n, n, h).permute(2, 0, 1)
        bias = bias.to(self.compute_dtype)
        row = -(-n // MASK_ALIGN) * MASK_ALIGN
        out = torch.empty((windows, h, n, row), dtype=self.compute_dtype,
                          device=bias.device)[..., :n]
        if region is None:
            out.copy_(bias.expand(windows, h, n, n))
        else:
            torch.add(region[:, None], bias, out=out)
        return out.view(1, windows * h, n, n)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """``x`` [B, windows, n, C] -> [B, windows, n, C]."""
        b, nw, n, c = x.shape
        h, hd = self.heads, self.head_dim
        qkv = self.qkv(x).view(b, nw, n, 3, h, hd).permute(3, 0, 1, 4, 2, 5)
        q, k, v = qkv.reshape(3, b, nw * h, n, hd).unbind(0)
        y = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=hd ** -0.5)
        y = y.view(b, nw, h, n, hd).transpose(2, 3).reshape(b, nw, n, c)
        return self.proj(y)


class MLPBlock(nn.Module):
    """Linear(d, r d) -> exact GELU -> Linear(r d, d) (MONAI's ``MLPBlock``)."""

    def __init__(self, dim: int, hidden: int, compute_dtype=torch.float32):
        super().__init__()
        self.linear1 = Linear(dim, hidden, compute_dtype=compute_dtype)
        self.linear2 = Linear(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.linear2(F.gelu(self.linear1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, shift: int, mlp_ratio: float,
                 compute_dtype=torch.float32, stage: str = "swin.stage"):
        super().__init__()
        self.window, self.shift, self.stage = window, shift, stage
        self.norm1 = LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window, compute_dtype)
        self.norm2 = LayerNorm(dim, eps=LN_EPS)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio), compute_dtype)

    def forward(self, x):
        b, d, h, w, _ = x.shape
        ws, ss = window_and_shift((d, h, w), self.window, self.shift)
        dims = padded_dims((d, h, w), ws)
        shifted = any(ss)
        with tracing.span(f"{self.stage}.attn"):
            y = F.pad(self.norm1(x), (0, 0, 0, dims[2] - w, 0, dims[1] - h, 0, dims[0] - d))
            if shifted:
                y = torch.roll(y, shifts=tuple(-s for s in ss), dims=(1, 2, 3))
            windows = window_partition(y, ws)
            nw, n = windows.shape[1], windows.shape[2]
            region = shift_mask(dims, ws, ss, x.device).to(x.dtype) if shifted else None
            y = window_reverse(self.attn(windows, self.attn.attention_mask(n, nw, region)), ws,
                               dims)
            if shifted:
                y = torch.roll(y, shifts=ss, dims=(1, 2, 3))
            x = x + y[:, :d, :h, :w]
            counts["attn.calls"] += 1
            counts["attn.shifted_calls"] += int(shifted)
            counts["attn.tokens"] += b * nw * n
            counts["attn.pad_tokens"] += b * (nw * n - d * h * w)
        with tracing.span(f"{self.stage}.mlp"):
            return x + self.mlp(self.norm2(x))


class PatchMerging(nn.Module):
    """MONAI's v1 merge (``downsample="merging"``): [B, D, H, W, C] ->
    [B, D/2, H/2, W/2, 2C]."""

    def __init__(self, dim: int, compute_dtype=torch.float32):
        super().__init__()
        self.reduction = Linear(8 * dim, 2 * dim, bias=False, compute_dtype=compute_dtype)
        self.norm = LayerNorm(8 * dim, eps=LN_EPS)

    def forward(self, x):
        _, d, h, w, _ = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        x = torch.cat([x[:, a::2, b::2, c::2] for a, b, c in MERGE_ORDER], dim=-1)
        return self.reduction(self.norm(x))


class BasicLayer(nn.Module):
    """``depth`` blocks (odd ones shifted by ``window // 2``), then the merge."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, mlp_ratio: float,
                 compute_dtype=torch.float32, name: str = "swin.stage"):
        super().__init__()
        self.name = name
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2,
                                 mlp_ratio, compute_dtype, name)
            for j in range(depth))
        self.downsample = PatchMerging(dim, compute_dtype)

    def forward(self, x):
        with tracing.span(self.name):
            for blk in self.blocks:
                x = blk(x)
            with tracing.span(f"{self.name}.merge"):
                return self.downsample(x)


class SwinViT(nn.Module):
    """MONAI's ``SwinTransformer`` (``swinViT``): the five hidden states,
    each through ``proj_out``."""

    def __init__(self, in_channels: int, feature_size: int, depths: Sequence[int],
                 num_heads: Sequence[int], window: int, mlp_ratio: float,
                 compute_dtype=torch.float32):
        super().__init__()
        self.patch_embed = _named(proj=Conv3d(in_channels, feature_size, PATCH, stride=PATCH,
                                              bias=True, compute_dtype=compute_dtype))
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            layer = BasicLayer(feature_size * 2 ** i, depth, heads, window, mlp_ratio,
                               compute_dtype, f"swin.stage{i + 1}")
            setattr(self, f"layers{i + 1}", nn.ModuleList([layer]))

    def forward(self, x):
        def proj_out(t):
            return F.layer_norm(t.float(), t.shape[-1:], eps=LN_EPS).to(t.dtype)

        with tracing.span("swin.embed"):
            x = self.patch_embed(x)
        hidden = [proj_out(x)]
        for layers in (self.layers1, self.layers2, self.layers3, self.layers4):
            x = layers[0](x)
            hidden.append(proj_out(x))
        return hidden


def _renamer(pairs):
    """A state-dict hook that renames ``prefix + a`` to ``prefix + b`` for
    each (a, b) of ``pairs``."""
    def rename(state_dict, prefix):
        for a, b in pairs:
            if prefix + a in state_dict:
                state_dict[prefix + b] = state_dict.pop(prefix + a)
    return rename


class UnetResBlock(ResidualBlock):
    """MONAI's ``UnetResBlock`` (conv3 -> IN -> LeakyReLU(0.01) -> conv3 -> IN
    -> + shortcut -> LeakyReLU, the shortcut a 1^3 conv + IN where the widths
    differ): the port's ``ResidualBlock`` on plain convolutions without bias
    or dropout and with non-affine norms, under MONAI's parameter names."""

    # (the port's name, MONAI's name) of each parameter
    KEYS = (("conv1.weight", "conv1.conv.weight"), ("conv2.weight", "conv2.conv.weight"),
            ("shortcut.0.weight", "conv3.conv.weight"))

    def __init__(self, in_ch: int, features: int, compute_dtype=torch.float32):
        super().__init__(in_ch, features, use_depthwise_separable=False, use_grouped=False,
                         dropout_p=0.0, compute_dtype=compute_dtype, affine=False)
        to_monai = _renamer(self.KEYS)
        from_monai = _renamer([(b, a) for a, b in self.KEYS])
        self.register_state_dict_post_hook(lambda m, sd, prefix, meta: to_monai(sd, prefix))
        self.register_load_state_dict_pre_hook(
            lambda m, sd, prefix, *rest: from_monai(sd, prefix))


class UnetrUpBlock(nn.Module):
    """2^3 stride-2 transposed conv (no bias), ``cat[up, skip]``, ``UnetResBlock``."""

    def __init__(self, in_ch: int, features: int, compute_dtype=torch.float32):
        super().__init__()
        self.transp_conv = _named(conv=ConvTranspose3d(in_ch, features, 2, stride=2, bias=False,
                                                       compute_dtype=compute_dtype))
        self.conv_block = UnetResBlock(2 * features, features, compute_dtype)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class SwinUNETR(nn.Module):
    """Input ``[B, D, H, W, in_channels]`` (every dim a multiple of 32) ->
    sigmoid probabilities ``[B, D, H, W, out_channels]`` in float32."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, feature_size: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0, compute_dtype=torch.float32):
        super().__init__()
        fs, dt = feature_size, compute_dtype
        self.compute_dtype = compute_dtype
        self.swinViT = SwinViT(in_channels, fs, depths, num_heads, window_size, mlp_ratio, dt)

        def basic(cin, c):  # MONAI's UnetrBasicBlock: a UnetResBlock named ``layer``
            return _named(layer=UnetResBlock(cin, c, dt))

        self.encoder1 = basic(in_channels, fs)
        self.encoder2 = basic(fs, fs)
        self.encoder3 = basic(2 * fs, 2 * fs)
        self.encoder4 = basic(4 * fs, 4 * fs)
        self.encoder10 = basic(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, dt)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, dt)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, dt)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, dt)
        self.decoder1 = UnetrUpBlock(fs, fs, dt)
        # float32, as the lightweight U-Net's head
        self.out = _named(conv=_named(conv=Conv3d(fs, out_channels, 1, bias=True)))

    def forward(self, x):
        counts["forwards"] += 1
        x = x.to(self.compute_dtype)
        hs = self.swinViT(x)
        with tracing.span("swin.decoder"):
            enc0 = self.encoder1(x)
            enc1 = self.encoder2(hs[0])
            enc2 = self.encoder3(hs[1])
            enc3 = self.encoder4(hs[2])
            dec4 = self.encoder10(hs[4])
            dec3 = self.decoder5(dec4, hs[3])
            dec2 = self.decoder4(dec3, enc3)
            dec1 = self.decoder3(dec2, enc2)
            dec0 = self.decoder2(dec1, enc1)
            out = self.decoder1(dec0, enc0)
            return torch.sigmoid(self.out(out).float())


def build_swin_unetr(model_cfg, compute_dtype=torch.float32) -> SwinUNETR:
    """The model of a validated ``ModelConfig`` named ``SwinUNETR``."""
    return SwinUNETR(in_channels=1, out_channels=model_cfg.output_channels,
                     feature_size=model_cfg.feature_size, depths=tuple(model_cfg.depths),
                     num_heads=tuple(model_cfg.num_heads), window_size=model_cfg.window_size,
                     mlp_ratio=model_cfg.mlp_ratio, compute_dtype=compute_dtype)
