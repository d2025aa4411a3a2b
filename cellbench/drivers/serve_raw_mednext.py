"""``serve_raw`` (``drivers/serve_raw.py``: raw volumes through the fused
per-volume pipeline, closed loop, then the sampled maps held against the
float32 reference) for a MedNeXt configuration.  The loop and the check are
``serve_raw``'s own code; only where the weights, the reference and a
volume's work come from differs (``cellbench/mednext.py``).  The
configuration is validated first, so a program that does not know the model
fails before any input is made.
"""

from __future__ import annotations

from cellbench import common, harness, mednext


class _MedNeXtCommon:
    """``cellbench.common`` with MedNeXt's reference net, reference map and
    work of a volume."""

    reference_net = staticmethod(mednext.reference_net)
    reference_map = staticmethod(mednext.reference_map)
    volume_work = staticmethod(mednext.volume_work)

    def __getattr__(self, name):
        return getattr(common, name)


class _MedNeXtWeights:
    cell_state = staticmethod(mednext.cell_state)


def run(cell: harness.Cell) -> harness.Outcome:
    from light_unet_tpu_torch.config import Config

    Config.from_dict(cell.settings())  # raises if the program cannot build the model
    base = harness.load_module("drivers", "serve_raw")  # a copy of its own
    base.common, base.weights = _MedNeXtCommon(), _MedNeXtWeights()
    out = base.run(cell)
    if out.trace is not None:  # the block depthwise kernels by name, device seconds
        out.detail["dw_kernels"] = {name: s for name, s in out.trace.kernel_s.items()
                                    if any(k in name for k in mednext.DW_KERNELS)}
    return out
