"""Device milliseconds a volume in the window-attention kernels
(``cellbench/swin.py:ATTENTION_KERNELS``, matched in the trace's kernel
names), over the volumes whose work ran in the traced window; None if no
such kernel ran."""

from cellbench import swin


def read(out):
    t = out.trace
    if t is None or not t.units:
        return None
    seconds = swin.attention_seconds(t)
    return 1e3 * seconds / t.units if seconds else None
