"""The least time of the forward's work (a volume's windows: the larger of
operations over peak operations and bytes over peak bandwidth) times the
volumes in the traced window, over the device's busy seconds, in percent."""


def read(out):
    t, w = out.trace, out.work
    if t is None or not w.get("peak_flops") or not t.busy_s:
        return None
    least = max(w["flops"] / w["peak_flops"], w["bytes"] / w["peak_bytes"])
    return 100.0 * least * t.units / t.busy_s
