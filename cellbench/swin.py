"""SwinUNETR's part of the benchmark: its seeded weights in MONAI's names,
its plain float32 reference net, its reference map and the work of a
volume.

The weights come from the device in two generator calls, as
``weights.py`` makes the U-Net's: one uniform and one normal draw of all
parameters' length, each parameter taking its slice: convolution and
linear weights uniform in +-1/sqrt(fan_in) (a transposed conv's fan-in is
its input channels), relative-position bias tables 2 N(0, 1), norm scales
1 + 0.1 N(0, 1), biases 0.1 N(0, 1); the ``relative_position_index``
buffers as MONAI builds them.  Random q and k of this scale give logits of
about 0.3; the tables' spread makes each window's attention peaked, as a
trained model's is, so that the maps depend on the bias and the mask
(dropping either moves a map several times the bfloat16 program's gap).  The reference computes a volume's windows 4
at a time, so that its materialised float32 attention (1.9 GB of scores
at 96^3) fits beside the volume.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cellbench import common
from cellbench.cost_swin import attention_cost, forward_cost
from cellbench.reference.swin_unetr import (
    SwinUNETR,
    identity,
    no_tf32,
    parameter_shapes,
    relative_position_index,
)
from cellbench.reference.window import positions, window_map

# The seed of SwinUNETR's benchmark weights (one model for every run).
WEIGHTS_SEED = 48
REFERENCE_BATCH = 4  # windows a reference forward
# device kernels of the window attention (F.scaled_dot_product_attention's
# memory-efficient, flash and cuDNN forwards), matched in the trace's names
ATTENTION_KERNELS = ("fmha", "attention", "flash_fwd", "sdpa")


def cell_state(cell, device) -> Dict[str, torch.Tensor]:
    return seeded_state(cell.settings()["model"], WEIGHTS_SEED, device)


def seeded_state(model_cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 state dict in MONAI's names, buffers included."""
    shapes = parameter_shapes(model_cfg)
    total = sum(s.numel() for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand(total, generator=gen, device=device)
    nor = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = shape.numel()
        u, z = uni[off:off + n].reshape(shape), nor[off:off + n].reshape(shape)
        off += n
        if name.endswith("relative_position_bias_table"):
            out[name] = 2.0 * z
            index = name.replace("relative_position_bias_table", "relative_position_index")
            w = int(model_cfg["window_size"])
            out[index] = relative_position_index((w, w, w)).to(device)
        elif len(shape) >= 2:
            fan_in = shape[0] if "transp_conv" in name else shape[1:].numel()
            bound = fan_in ** -0.5
            out[name] = u * (2 * bound) - bound
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def reference_net(settings: dict, state: dict, device, quant=identity) -> SwinUNETR:
    no_tf32()
    net = SwinUNETR(settings["model"], quant).to(device)
    net.load_state_dict(state, strict=True)
    return net.eval()


def reference_map(net, settings: dict, normalized: np.ndarray, device, mask=None) -> np.ndarray:
    """The reference's map of a normalized volume, times ``mask``."""
    out = window_map(net, normalized, tuple(settings["data"]["patch_size"]), device,
                     batch=REFERENCE_BATCH)
    return out * mask if mask is not None else out


def n_params(model: dict) -> int:
    return sum(s.numel() for _, s in parameter_shapes(model))


def volume_work(settings: dict, shape, device) -> Dict[str, float]:
    """Operations and bytes of the forward over a volume's windows, of its
    window attention alone (``attn_flops``, ``attn_bytes``), and the card's
    peaks for the compute dtype."""
    model, patch = settings["model"], tuple(settings["data"]["patch_size"])
    n = len(positions(shape, patch))
    bf16 = settings["tpu"]["compute_dtype"] == "bfloat16"
    item = 2 if bf16 else 4
    flops, nbytes = forward_cost(model, n, patch, item, n_params(model))
    attn_flops, attn_bytes = attention_cost(model, n, patch, item)
    return {"windows": n, "flops": flops, "bytes": nbytes, "attn_flops": attn_flops,
            "attn_bytes": attn_bytes, **common.card_peaks(device, bf16)}


def attention_seconds(trace) -> float:
    """Device seconds of the window-attention kernels in a reduced trace."""
    return sum(s for name, s in trace.kernel_s.items()
               if any(k in name.lower() for k in ATTENTION_KERNELS))
