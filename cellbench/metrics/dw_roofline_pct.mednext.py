"""The block depthwise convs' share of their roofline: the least time of
their work (``cellbench/cost_mednext.py:depthwise_cost`` of a volume's
windows: the larger of their FMA operations over the card's float32 peak,
since they run on the CUDA cores, and their bytes over the peak bandwidth)
times the volumes in the traced window, over the device seconds of the
kernels ``cellbench/mednext.py:DW_KERNELS`` names, in percent; None if no
such kernel ran."""

from cellbench import mednext


def read(out):
    t, w = out.trace, out.work
    if t is None or not w.get("peak_fp32_flops") or "dw_flops" not in w:
        return None
    seconds = mednext.dw_seconds(t)
    if not seconds:
        return None
    least = max(w["dw_flops"] / w["peak_fp32_flops"], w["dw_bytes"] / w["peak_bytes"])
    return 100.0 * least * t.units / seconds
