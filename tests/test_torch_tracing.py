"""PyTorch port: ``StageTimer`` (``utils/tracing.py``) against the JAX
package's on the same sequence of timed blocks, ``time.time`` patched in
both, and ``maybe_profile`` doing nothing without a directory."""

import json
import time

import pytest

from light_unet_tpu.utils import tracing as jax_tracing
from light_unet_tpu_torch.utils import tracing

# block boundaries (enter, exit) in seconds: durations of 0.5, 0.25, 1e-5,
# 1/3 and 2.00004, so that the 4-decimal rounding and the report's .2f/.3f
# both show
TICKS = [0.0, 0.5, 1.0, 1.25, 2.0, 2.00001, 3.0, 3.3333333, 4.0, 6.00004]


def _drive(module, monkeypatch, capsys, tmp_path, prefix):
    ticks = iter(TICKS)
    monkeypatch.setattr(time, "time", lambda: next(ticks))
    timer = module.StageTimer()
    for name in ("decode", "prepare", "decode", "dispatch"):
        with timer.time(name):
            pass
    with pytest.raises(ValueError):  # a block that raises is still timed
        with timer.time("write"):
            raise ValueError("disk full")
    monkeypatch.undo()
    timer.report(prefix=prefix)
    printed = capsys.readouterr().out
    path = tmp_path / module.__name__ / "nested" / "stages.json"
    timer.save(path)
    return timer.summary(), printed, path.read_text()


@pytest.mark.parametrize("prefix", ["", "  [serving] "])
def test_stage_timer_matches_jax(monkeypatch, capsys, tmp_path, prefix):
    got = _drive(tracing, monkeypatch, capsys, tmp_path, prefix)
    want = _drive(jax_tracing, monkeypatch, capsys, tmp_path, prefix)
    assert got == want
    summary, printed, saved = got
    assert list(summary) == ["decode", "prepare", "dispatch", "write"]
    assert summary["decode"] == {"total_seconds": 0.5, "calls": 2, "seconds_per_call": 0.25}
    assert summary["write"]["calls"] == 1
    assert json.loads(saved) == summary
    assert printed.splitlines()[0] == f"{prefix}decode: 0.50s total, 2 calls, 0.250s/call"


def test_stage_timer_empty(tmp_path, capsys):
    timer = tracing.StageTimer()
    assert timer.summary() == jax_tracing.StageTimer().summary() == {}
    timer.report()
    assert capsys.readouterr().out == ""
    timer.save(tmp_path / "empty.json")
    assert json.loads((tmp_path / "empty.json").read_text()) == {}


def test_maybe_profile_without_a_directory_does_nothing(monkeypatch):
    monkeypatch.delenv("LIGHT_UNET_PROFILE", raising=False)
    with tracing.maybe_profile(None) as where:
        assert where is None
