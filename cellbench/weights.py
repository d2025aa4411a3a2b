"""Seeded model weights, made on the device in two generator calls.

The benchmark makes the weights and hands the same state dict to the
program and to the reference.  One uniform and one normal draw of all
parameters' length come from a ``torch.Generator`` on the device; each
parameter takes its slice: convolution weights uniform in
+-1/sqrt(fan_in) (a transposed conv's fan-in is its input channels), norm
scales 1 + 0.1 N(0, 1), biases 0.1 N(0, 1), so that every affine step of
the norms does work.
"""

from __future__ import annotations

from typing import Dict

import torch

from cellbench.reference.unet import UNet

# The seed of the benchmark's weights.  Every seeded model puts the whole
# body above the stage's threshold (0.3) as one component, with from none
# to tens of thousands of specks beside it; this one gives about nine
# components a phantom, within the device candidate table's cap of 64.
WEIGHTS_SEED = 12


def cell_state(cell, device) -> Dict[str, torch.Tensor]:
    """The benchmark's model: one set of weights for every cell and run, as
    a deployment serves one checkpoint (``WEIGHTS_SEED``)."""
    return seeded_state(cell.settings()["model"], WEIGHTS_SEED, device)


def seeded_state(model_cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """float32 state dict of the published model's parameter names."""
    with torch.device("meta"):
        shapes = [(n, p.shape) for n, p in UNet(model_cfg).named_parameters()]
    total = sum(s.numel() for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    uni = torch.rand(total, generator=gen, device=device)
    nor = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in shapes:
        n = shape.numel()
        u, z = uni[off:off + n].reshape(shape), nor[off:off + n].reshape(shape)
        off += n
        if len(shape) >= 2:
            fan_in = shape[0] if name.endswith("up.weight") else shape[1:].numel()
            bound = fan_in ** -0.5
            out[name] = u * (2 * bound) - bound
        elif name.endswith("weight"):
            out[name] = 1.0 + 0.1 * z
        else:
            out[name] = 0.1 * z
    return out
