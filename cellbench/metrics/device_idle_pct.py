"""Share of the traced window in which no device activity ran, in percent."""


def read(out):
    t = out.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
