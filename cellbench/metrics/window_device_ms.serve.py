"""Device-busy milliseconds a volume in the traced window (the union of the
profiler's device activity, over the volumes whose work ran in it)."""


def read(out):
    t = out.trace
    if t is None or not t.units:
        return None
    return 1e3 * t.busy_s / t.units
