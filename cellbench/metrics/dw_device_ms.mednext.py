"""Device milliseconds a volume in the block depthwise kernels
(``cellbench/mednext.py:DW_KERNELS``, matched in the trace's kernel names),
over the volumes whose work ran in the traced window; None if no such
kernel ran."""

from cellbench import mednext


def read(out):
    t = out.trace
    if t is None or not t.units:
        return None
    seconds = mednext.dw_seconds(t)
    return 1e3 * seconds / t.units if seconds else None
