"""The work of one U-Net forward, counted from the model's widths and the
input's shape alone (the port of ``scripts/roofline.py:analytic_levels``,
extended to the whole forward).

The count does not depend on the route that computes the forward (the
plain convolutions, the fused block kernel or the fused norm kernel), so a
time taken on any route divides the same work.

* **Operations** are 2 x the multiply-accumulates of every convolution:
  depthwise 3^3, pointwise 1^3, grouped or plain 3^3, the 1^3 shortcuts,
  the 2^3 stride-2 transposed convs and the 1^3 head.  That is the count of
  ``torch.utils.flop_counter.FlopCounterMode``.  Norms, activations,
  pooling and adds are not counted, as in the JAX table.
* **Bytes** follow the JAX table's convention, perfect fusion inside a
  residual block: a block moves ``(cin + 3 c)`` activations a voxel (its
  input read once, its output written once, its two conv outputs once).
  Between blocks each op reads its input and writes its output once:
  max-pool, transposed conv, and the head (float32 output).  A decoder
  block reads the skip and the upsampled tensor in place, so the
  pad + concat moves nothing of its own.  The float32 parameters are read
  once.  Activations are ``dtype``.

SwinUNETR (``models/swin_unetr.py``) is counted by ``swin_forward_terms``,
each row of one ``kind``: ``conv`` (every convolution and transposed
convolution, its decoder blocks as a U-Net block above), ``attention``
(``q k^T`` and ``attn v`` of every head over the padded windows: what the
attention computes, padding included), ``linear`` (qkv and proj over the
padded windows, the merges' reductions) and ``mlp`` (the two linears of each
block's MLP, over the unpadded tokens).  Operations are ``FlopCounterMode``'s
(2 x multiply-accumulates); LayerNorms, softmax, GELU, rolls, pads, the
merges' gathers and the relative-position bias's gather are not counted.
Bytes: each linear and convolution reads its input and writes its output
once; an MLP reads its input and writes its output (its hidden layer kept
on chip); the attention reads q, k and v, writes its output and reads the
float32 bias table once.

MedNeXt (``models/mednext.py``) is counted by ``mednext_forward_terms``, each
row of one ``kind``: ``depthwise`` (a block's depthwise k^3 conv),
``pointwise`` (the stem, and each block's expansion MLP, W2 and W3, with the
Down's R or the Up's RT), ``resample`` (the Downs' strided and the Ups'
transposed depthwise convs) and ``head``.  Operations are
``FlopCounterMode``'s (2 x multiply-accumulates; a transposed conv's are
counted over its input's voxels, as the counter does); GroupNorm, GELU,
pads and adds are not counted.  Bytes: a depthwise or resampling conv reads
its input and writes its output once; a ``pointwise`` row of a block reads
the depthwise conv's output (C a voxel) and the residual, and writes the
block's output (C'), the norm, the MLP's hidden layer and the adds fused
(a Down reads its input at the even voxels for R; an Up reads its input for
RT and the encoder's skip, and writes the padded (2n)^3 output); the stem
reads one channel and writes n; the head writes float32.
``mednext_depthwise_cost`` gives the 54 block depthwise convs alone: their
input read, their output written, and their float32 weights and biases read
once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from light_unet_tpu_torch.models.swin_unetr import PATCH, padded_dims, window_and_shift
from light_unet_tpu_torch.models.unet3d import build_model


def analytic_levels(batch=96, d=48, ch=(16, 32, 64, 128)):
    """Per-level FLOPs / HBM bytes for the encoder path's residual blocks
    (depthwise-separable convs, the flagship config).  Bytes assume bf16
    activations with perfect fusion INSIDE a block (read input once, write
    output once per conv): an optimistic lower bound on traffic.  The rows
    are ``scripts/roofline.py:analytic_levels``'s, key for key."""
    rows = []
    spatial = d**3
    cin = 1
    for level, c in enumerate(ch):
        s = spatial // (8**level)  # MaxPool3d(2) halves each dim per level
        # residual block = 2x (depthwise 3^3 + pointwise 1^3) + shortcut 1^3
        flops = 0
        flops += 2 * 27 * cin * s + 2 * cin * c * s          # conv1 dw+pw
        flops += 2 * 27 * c * s + 2 * c * c * s              # conv2 dw+pw
        if cin != c:
            flops += 2 * cin * c * s                         # shortcut 1x1x1
        flops *= batch
        # traffic: activations in/out per conv pair (bf16 = 2 bytes)
        bytes_ = batch * s * (cin + c + c + c) * 2
        ai = flops / max(bytes_, 1)
        rows.append(
            dict(level=level, channels=c, spatial=round(s ** (1 / 3)),
                 gflops=flops / 1e9, mbytes=bytes_ / 1e6,
                 arithmetic_intensity=ai)
        )
        cin = c
    return rows


def _conv3_flops(model_cfg, cin: int, c: int, s: int, grouped: bool) -> int:
    """2 x MACs of a block's 3^3 conv: depthwise + pointwise, or grouped /
    plain (``models/unet3d.py:ResidualBlock._conv``)."""
    if model_cfg.use_depthwise_separable:
        return 2 * 27 * cin * s + 2 * cin * c * s
    g = model_cfg.groups
    if not (grouped and model_cfg.use_grouped_conv and g > 1 and cin >= g and c >= g):
        g = 1
    return 2 * 27 * (cin // g) * c * s


def _block(model_cfg, name: str, level: int, batch: int, cin: int, c: int, s: int,
           itemsize: int, grouped: bool = True) -> Dict:
    flops = (_conv3_flops(model_cfg, cin, c, s, grouped)
             + _conv3_flops(model_cfg, c, c, s, grouped))
    if cin != c:
        flops += 2 * cin * c * s  # shortcut 1^3
    return dict(op=name, level=level, flops=batch * flops,
                bytes=batch * s * (cin + 3 * c) * itemsize)


def forward_terms(model_cfg, batch: int, patch: Union[int, Sequence[int]],
                  dtype=torch.bfloat16) -> List[Dict]:
    """One row per op of the forward (``op``, ``level``, ``flops``,
    ``bytes``) in the order the forward runs them, for ``batch`` patches of
    ``patch`` voxels (an int: a cube)."""
    dims = (patch,) * 3 if isinstance(patch, int) else tuple(int(p) for p in patch)
    itemsize = torch.empty((), dtype=dtype).element_size()
    ch = list(model_cfg.encoder_channels)
    sizes = [dims]
    for _ in range(3):  # MaxPool3d(2) floors each dim
        sizes.append(tuple(n // 2 for n in sizes[-1]))
    vox = [a * b * c for a, b, c in sizes]

    rows = [_block(model_cfg, "init_conv", 0, batch, 1, ch[0], vox[0], itemsize, grouped=False)]
    for lv in range(1, 4):
        rows.append(dict(op=f"down{lv}.pool", level=lv, flops=0,
                         bytes=batch * ch[lv - 1] * (vox[lv - 1] + vox[lv]) * itemsize))
        rows.append(_block(model_cfg, f"down{lv}", lv, batch, ch[lv - 1], ch[lv], vox[lv],
                           itemsize))
    rows.append(_block(model_cfg, "bottleneck", 3, batch, ch[3], ch[3], vox[3], itemsize))
    cin = ch[3]
    for i, lv in enumerate((2, 1, 0), start=1):
        half = cin // 2
        up_vox = 8 * vox[lv + 1]  # stride 2 doubles each dim; pad_concat adds the rest
        rows.append(dict(op=f"up{i}.up", level=lv, flops=2 * cin * half * up_vox * batch,
                         bytes=batch * (cin * vox[lv + 1] + half * up_vox) * itemsize))
        rows.append(_block(model_cfg, f"up{i}", lv, batch, half + ch[lv], ch[lv], vox[lv],
                           itemsize))
        cin = ch[lv]
    out = model_cfg.output_channels
    rows.append(dict(op="out_conv", level=0, flops=2 * ch[0] * out * vox[0] * batch,
                     bytes=batch * vox[0] * (ch[0] * itemsize + out * 4)))
    return rows


def _swin_stage_dims(dims, window: int):
    """Each stage's (token dims, padded dims, window voxels) from the patch
    embedding's dims."""
    out = []
    for _ in range(4):
        ws, _ = window_and_shift(dims, window, 0)
        out.append((dims, padded_dims(dims, ws), ws[0] * ws[1] * ws[2]))
        dims = tuple(-(-d // 2) for d in dims)
    return out


def swin_forward_terms(model_cfg, batch: int, patch: Union[int, Sequence[int]],
                       dtype=torch.bfloat16) -> List[Dict]:
    """SwinUNETR's rows (``op``, ``kind``, ``flops``, ``bytes``) for ``batch``
    patches, in the order the forward runs them."""
    dims = (patch,) * 3 if isinstance(patch, int) else tuple(int(p) for p in patch)
    it = torch.empty((), dtype=dtype).element_size()
    fs, pe = model_cfg.feature_size, PATCH
    vol = lambda d: d[0] * d[1] * d[2]  # noqa: E731
    rows = []

    def conv(op, cin, c, k, vox_in, vox_out):
        rows.append(dict(op=op, kind="conv", flops=2 * cin * c * k ** 3 * vox_out * batch,
                         bytes=batch * (cin * vox_in + c * vox_out) * it))

    def upconv(op, cin, c, vox_in):
        rows.append(dict(op=op, kind="conv", flops=2 * cin * c * 8 * vox_in * batch,
                         bytes=batch * (cin * vox_in + c * 8 * vox_in) * it))

    def res_block(op, cin, c, vox):
        flops = 2 * 27 * cin * c * vox + 2 * 27 * c * c * vox
        if cin != c:
            flops += 2 * cin * c * vox
        rows.append(dict(op=op, kind="conv", flops=batch * flops,
                         bytes=batch * vox * (cin + 3 * c) * it))

    def linear(op, kind, cin, c, tokens):
        rows.append(dict(op=op, kind=kind, flops=2 * cin * c * tokens * batch,
                         bytes=batch * tokens * (cin + c) * it))

    emb = tuple(d // pe for d in dims)
    conv("swin.embed", 1, fs, pe, vol(dims), vol(emb))
    stages = _swin_stage_dims(emb, model_cfg.window_size)
    for i, ((sd, pad, n), depth, heads) in enumerate(
            zip(stages, model_cfg.depths, model_cfg.num_heads)):
        d, name = fs * 2 ** i, f"swin.stage{i + 1}"
        real, padded = vol(sd), vol(pad)
        hidden = int(d * model_cfg.mlp_ratio)
        for j in range(depth):
            linear(f"{name}.{j}.qkv", "linear", d, 3 * d, padded)
            rows.append(dict(op=f"{name}.{j}.attn", kind="attention",
                             flops=2 * 2 * padded * n * d * batch,
                             bytes=batch * 4 * padded * d * it
                             + 4 * (2 * model_cfg.window_size - 1) ** 3 * heads))
            linear(f"{name}.{j}.proj", "linear", d, d, padded)
            rows.append(dict(op=f"{name}.{j}.mlp", kind="mlp",
                             flops=2 * 2 * d * hidden * real * batch,
                             bytes=batch * real * 2 * d * it))
        merged = tuple(-(-x // 2) for x in sd)
        linear(f"{name}.merge", "linear", 8 * d, 2 * d, vol(merged))
    # the decoder: encoder blocks on the input and hidden states 0, 1, 2, 4
    size = [dims, emb] + [tuple(-(-x // 2) for x in s[0]) for s in stages]
    res_block("encoder1", 1, fs, vol(size[0]))
    res_block("encoder2", fs, fs, vol(size[1]))
    res_block("encoder3", 2 * fs, 2 * fs, vol(size[2]))
    res_block("encoder4", 4 * fs, 4 * fs, vol(size[3]))
    res_block("encoder10", 16 * fs, 16 * fs, vol(size[5]))
    for name, cin, c, lv in (("decoder5", 16 * fs, 8 * fs, 4), ("decoder4", 8 * fs, 4 * fs, 3),
                             ("decoder3", 4 * fs, 2 * fs, 2), ("decoder2", 2 * fs, fs, 1),
                             ("decoder1", fs, fs, 0)):
        upconv(f"{name}.up", cin, c, vol(size[lv + 1]))
        res_block(name, 2 * c, c, vol(size[lv]))
    out = model_cfg.output_channels
    rows.append(dict(op="out", kind="conv", flops=2 * fs * out * vol(dims) * batch,
                     bytes=batch * vol(dims) * (fs * it + out * 4)))
    return rows


def _mednext_widths(model_cfg):
    n = model_cfg.n_channels
    return [n, 2 * n, 4 * n, 8 * n, 16 * n, 8 * n, 4 * n, 2 * n, n]


def mednext_forward_terms(model_cfg, batch: int, patch: Union[int, Sequence[int]],
                          dtype=torch.bfloat16) -> List[Dict]:
    """MedNeXt's rows (``op``, ``kind``, ``flops``, ``bytes``) for ``batch``
    patches, in the order the forward runs them."""
    dims = (patch,) * 3 if isinstance(patch, int) else tuple(int(p) for p in patch)
    it = torch.empty((), dtype=dtype).element_size()
    k3 = model_cfg.kernel_size ** 3
    width, r = _mednext_widths(model_cfg), list(model_cfg.exp_r)
    vox = [dims[0] * dims[1] * dims[2] // 8 ** lv for lv in range(5)]
    rows = []

    def add(op, kind, flops, nbytes):
        rows.append(dict(op=op, kind=kind, flops=batch * flops, bytes=batch * nbytes * it))

    def blocks(name, i, lv):
        c, v = width[i], vox[lv]
        for j in range(model_cfg.block_counts[i]):
            add(f"{name}.{j}.conv1", "depthwise", 2 * k3 * c * v, 2 * c * v)
            add(f"{name}.{j}.mlp", "pointwise", 2 * 2 * c * r[i] * c * v, 3 * c * v)

    add("stem", "pointwise", 2 * width[0] * vox[0], (1 + width[0]) * vox[0])
    for i in range(4):
        blocks(f"enc_block_{i}", i, i)
        c, c2, ri, v_in, v = width[i], 2 * width[i], r[i + 1], vox[i], vox[i + 1]
        add(f"down_{i}.conv1", "resample", 2 * k3 * c * v, c * (v_in + v))
        add(f"down_{i}.mlp", "pointwise", 2 * (c * ri * c + ri * c * c2 + c * c2) * v,
            (2 * c + c2) * v)
    blocks("bottleneck", 4, 4)
    for j, i in enumerate((3, 2, 1, 0)):
        c, c2, ri, v_in, v = width[4 + j], width[5 + j], r[5 + j], vox[i + 1], vox[i]
        inner = (2 * dims[0] // 2 ** (i + 1) - 1) * (2 * dims[1] // 2 ** (i + 1) - 1) \
            * (2 * dims[2] // 2 ** (i + 1) - 1)  # the transposed conv's 2n - 1
        add(f"up_{i}.conv1", "resample", 2 * k3 * c * v_in, c * (v_in + inner))
        add(f"up_{i}.mlp", "pointwise", 2 * (c * ri * c + ri * c * c2) * inner + 2 * c * c2 * v_in,
            c * (inner + v_in) + 2 * c2 * v)
        blocks(f"dec_block_{i}", 5 + j, i)
    out = model_cfg.output_channels
    rows.append(dict(op="out_0", kind="head", flops=2 * width[0] * out * vox[0] * batch,
                     bytes=batch * vox[0] * (width[0] * it + out * 4)))
    return rows


def mednext_depthwise_cost(model_cfg, batch: int, patch: Union[int, Sequence[int]],
                           dtype=torch.bfloat16) -> Tuple[int, int]:
    """(operations, bytes) of the block depthwise convs alone (``kind``
    depthwise): their input read and output written, and their float32
    weights and biases read once."""
    rows = [r for r in mednext_forward_terms(model_cfg, batch, patch, dtype)
            if r["kind"] == "depthwise"]
    params = sum(4 * (model_cfg.kernel_size ** 3 + 1) * c * n
                 for c, n in zip(_mednext_widths(model_cfg), model_cfg.block_counts))
    return sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows) + params


def parameter_count(model_cfg) -> int:
    """Parameters of ``models/unet3d.py:build_model(model_cfg)``, built on
    the meta device (217,228 for the flagship config; 62,186,659 for
    SwinUNETR at feature size 48; 62,992,866 for MedNeXt-L at kernel 5)."""
    with torch.device("meta"):
        return sum(p.numel() for p in build_model(model_cfg, inference=True).parameters())


def forward_cost(model_cfg, batch: int, patch: Union[int, Sequence[int]],
                 dtype=torch.bfloat16) -> Tuple[int, int]:
    """(operations, bytes) of one forward of ``batch`` patches: the sums of
    ``forward_terms`` (``swin_forward_terms`` for SwinUNETR,
    ``mednext_forward_terms`` for MedNeXt), plus the float32 parameters read
    once."""
    terms = {"SwinUNETR": swin_forward_terms,
             "MedNeXt": mednext_forward_terms}.get(model_cfg.name, forward_terms)
    rows = terms(model_cfg, batch, patch, dtype)
    return (sum(r["flops"] for r in rows),
            sum(r["bytes"] for r in rows) + 4 * parameter_count(model_cfg))
