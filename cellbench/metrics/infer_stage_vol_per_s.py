"""Cases whose map and bbox JSON were written in the window (whole
``infer_split`` calls), over its seconds."""


def read(out):
    return out.rate
