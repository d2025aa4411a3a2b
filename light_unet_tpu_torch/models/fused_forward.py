"""Whole-model inference forward with fused residual blocks (port of
``light_unet_tpu/models/fused_forward.py``).

``make_fused_apply(model)`` returns ``fn(x)`` equal to ``model(x)`` in eval
mode, except that every depthwise-separable residual block runs through the
fused block kernel (``ops/block_kernel.py``), which takes every shape.
Max-pool, the ``up`` transposed conv, pad-concat and the ``out_conv`` head +
sigmoid stay plain torch, as the JAX package leaves them to XLA.  Grouped
and plain-conv models run their blocks as the modules they are.
"""

from __future__ import annotations

import torch

from light_unet_tpu_torch.models.unet3d import Lightweight3DUNet, max_pool, pad_concat
from light_unet_tpu_torch.ops.block_kernel import fused_residual_block


def make_fused_apply(model: Lightweight3DUNet):
    def block(blk, x):
        if model.use_depthwise_separable:
            return fused_residual_block(x, blk)
        return blk(x)

    @torch.no_grad()
    def apply_fn(x):
        x = x.to(model.compute_dtype)
        x1 = block(model.init_conv, x)
        x2 = block(model.down1.res_block, max_pool(x1))
        x3 = block(model.down2.res_block, max_pool(x2))
        x4 = block(model.down3.res_block, max_pool(x3))
        y = block(model.bottleneck, x4)
        y = block(model.up1.res_block, pad_concat(model.up1.up(y), x3))
        y = block(model.up2.res_block, pad_concat(model.up2.up(y), x2))
        y = block(model.up3.res_block, pad_concat(model.up3.up(y), x1))
        return torch.sigmoid(model.out_conv(y).float())

    # what a unit's graph key reads (``utils/graphs.py:unit_key``)
    apply_fn.compute_dtype = model.compute_dtype
    return apply_fn
