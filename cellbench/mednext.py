"""MedNeXt's part of the benchmark: its seeded weights in upstream's names,
its plain float32 reference net, its reference map, the work of a volume
and the names of its depthwise kernels.

The weights come from the device in two generator calls, as ``weights.py``
makes the U-Net's: one uniform and one normal draw of all parameters'
length, each parameter taking its slice: convolution weights uniform in
+-1/sqrt(fan_in) (the fan-in of a 1^3 transposed conv, ``res_conv`` of an
Up and the head, is its input channels), GroupNorm scales 1 + 0.1 N(0, 1),
biases 0.1 N(0, 1), ``dummy_tensor`` 1.  The reference computes a volume's
windows 2 at a time, so that its float32 activations (the 192-channel
expansion of ``up_0`` at 127^3 is 1.6 GB a window) fit beside the volume.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cellbench import common, harness
from cellbench.cost_mednext import depthwise_cost, forward_cost
from cellbench.reference.mednext import MedNeXt, identity, no_tf32, parameter_shapes
from cellbench.reference.window import positions, window_map

# The seed of MedNeXt's benchmark weights (one model for every run).
WEIGHTS_SEED = 25
REFERENCE_BATCH = 2  # windows a reference forward
# device kernels of the block depthwise convs (csrc/depthwise_conv.cu's
# 5x5x5 kernels), matched in the trace's names
DW_KERNELS = ("dw5_",)


def cell_state(cell, device) -> Dict[str, torch.Tensor]:
    return seeded_state(cell.settings()["model"], WEIGHTS_SEED, device)


def seeded_state(model_cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 state dict in upstream's names."""
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
        if name == "dummy_tensor":
            out[name] = torch.ones(shape, device=device)
        elif len(shape) >= 2:
            transposed_1x1 = name.startswith(("up_", "out_0")) and shape[2:].numel() == 1
            fan_in = shape[0] if transposed_1x1 else shape[1:].numel()
            bound = fan_in ** -0.5
            out[name] = u * (2 * bound) - bound
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out


def reference_net(settings: dict, state: dict, device, quant=identity) -> MedNeXt:
    no_tf32()
    net = MedNeXt(settings["model"], quant).to(device)
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
    block depthwise convs alone (``dw_flops``, ``dw_bytes``), the card's
    peaks for the compute dtype and its float32 peak (``peak_fp32_flops``:
    the depthwise convs run on the CUDA cores)."""
    model, patch = settings["model"], tuple(settings["data"]["patch_size"])
    n = len(positions(shape, patch))
    bf16 = settings["tpu"]["compute_dtype"] == "bfloat16"
    item = 2 if bf16 else 4
    flops, nbytes = forward_cost(model, n, patch, item, n_params(model))
    dw_flops, dw_bytes = depthwise_cost(model, n, patch, item)
    dev = torch.device(device)
    peaks = harness.peaks_for(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "")
    return {"windows": n, "flops": flops, "bytes": nbytes, "dw_flops": dw_flops,
            "dw_bytes": dw_bytes, "peak_fp32_flops": peaks.get("fp32_flops_per_s", 0.0),
            **common.card_peaks(device, bf16)}


def dw_seconds(trace) -> float:
    """Device seconds of the block depthwise kernels in a reduced trace."""
    return sum(s for name, s in trace.kernel_s.items() if any(k in name for k in DW_KERNELS))
