"""Host milliseconds of decode + prepare a volume on the worker threads
(harness spans around ``fastio.load_f32`` and
``FusedVolumePipeline.prepare``), mean over the window's volumes."""


def read(out):
    s = out.spans.seconds if out.spans else {}
    if not s.get("prepare"):
        return None
    return 1e3 * (sum(s.get("decode", [])) + sum(s["prepare"])) / len(s["prepare"])
