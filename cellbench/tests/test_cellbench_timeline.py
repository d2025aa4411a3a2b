"""The window's timeline in each run's ``detail`` line (``common.timeline``),
at the test size on the CPU: one completion offset per counted unit, inside
the window and in order, and the percentiles of each harness span."""

import json

import pytest

from tiny import run_tiny

SPANS = {"fl70.serve_raw": ("decode", "prepare", "wait_input", "dispatch", "fetch"),
         "fl70.infer_stage": ("decode_prepare", "dispatch", "fetch", "table", "write_map",
                              "write_json")}
PARAMS = {"fl70.serve_raw": {"pool": 3}, "fl70.infer_stage": {"cases": 3}}


def detail_of(capsys) -> dict:
    lines = capsys.readouterr().out.splitlines()
    return json.loads(next(line for line in lines if line.startswith("detail "))[7:])


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_window_timeline(cell, capsys):
    res = run_tiny(cell, seconds=1.5, **PARAMS[cell])
    detail = detail_of(capsys)
    done = detail["done_s"]
    assert res["correct"] and res["failed"] == 0
    assert len(done) == res["attempted"] >= 2  # a unit counts when it completes
    assert done == sorted(done) and 0 < done[0] and done[-1] < 1.5 + 60
    assert detail["cpu_s"] > 0
    for name in SPANS[cell]:
        p10, p50, p90 = detail["span_ms"][name]
        assert 0 <= p10 <= p50 <= p90
