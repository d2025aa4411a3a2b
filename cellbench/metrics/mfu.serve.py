"""The forward's share of the card's peak: operations of a volume's windows
(frozen ``cellbench/cost.py``) times volumes a second, over the published
peak of the compute dtype, in percent."""


def read(out):
    w = out.work
    if not w.get("peak_flops"):
        return None
    return 100.0 * w["flops"] * out.rate / w["peak_flops"]
