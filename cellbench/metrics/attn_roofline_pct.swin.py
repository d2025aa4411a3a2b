"""The window attention's share of its roofline: the least time of its work
(``cellbench/cost_swin.py:attention_cost`` of a volume's windows: the larger
of operations over the peak operations and bytes over the peak bandwidth)
times the volumes in the traced window, over the device seconds of the
attention kernels (``cellbench/swin.py:ATTENTION_KERNELS``), in percent;
None if no such kernel ran."""

from cellbench import swin


def read(out):
    t, w = out.trace, out.work
    if t is None or not w.get("peak_flops") or "attn_flops" not in w:
        return None
    seconds = swin.attention_seconds(t)
    if not seconds:
        return None
    least = max(w["attn_flops"] / w["peak_flops"], w["attn_bytes"] / w["peak_bytes"])
    return 100.0 * least * t.units / seconds
