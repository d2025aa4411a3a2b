"""Host milliseconds a case in the stage's writes: the map's NIfTI save and
the bbox JSON dump (harness spans around the calls), mean over the cases."""


def read(out):
    s = out.spans.seconds if out.spans else {}
    if not s.get("write_json"):
        return None
    return 1e3 * (sum(s.get("write_map", [])) + sum(s["write_json"])) / len(s["write_json"])
