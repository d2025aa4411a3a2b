"""Set-up seconds: process start to the first timed unit (imports, inputs,
model, kernel builds, graph warm-up and capture)."""


def read(out):
    return out.setup_s
