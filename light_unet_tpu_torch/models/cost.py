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
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

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


def parameter_count(model_cfg) -> int:
    """Parameters of ``models/unet3d.py:build_model(model_cfg)``, built on
    the meta device (217,228 for the flagship config)."""
    with torch.device("meta"):
        return sum(p.numel() for p in build_model(model_cfg).parameters())


def forward_cost(model_cfg, batch: int, patch: Union[int, Sequence[int]],
                 dtype=torch.bfloat16) -> Tuple[int, int]:
    """(operations, bytes) of one forward of ``batch`` patches: the sums of
    ``forward_terms``, plus the float32 parameters read once."""
    rows = forward_terms(model_cfg, batch, patch, dtype)
    return (sum(r["flops"] for r in rows),
            sum(r["bytes"] for r in rows) + 4 * parameter_count(model_cfg))
