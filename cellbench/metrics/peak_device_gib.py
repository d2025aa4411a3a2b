"""Peak device memory of the run in GiB (``torch.cuda.max_memory_allocated``
from process start, graph pools included), read when the window closes."""


def read(out):
    return out.peak_bytes / 2**30 if out.peak_bytes else None
