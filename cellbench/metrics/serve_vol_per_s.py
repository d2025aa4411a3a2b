"""Raw volumes whose maps were fetched in the window, over its seconds."""


def read(out):
    return out.rate
