"""Tracing and timing (port of ``light_unet_tpu/utils/tracing.py``).

* ``maybe_profile(profile_dir)`` wraps ``torch.profiler`` (CPU and, when
  available, CUDA activity) around a block when a directory is given
  (``tpu.profile_dir``, or the ``LIGHT_UNET_PROFILE`` environment variable)
  and writes a Chrome trace there; with no directory it does nothing.
* ``StageTimer`` accumulates wall-clock time of named stages across
  ``time(name)`` blocks and reports totals, calls and seconds per call, or
  writes them as JSON (the JAX package's keys and rounding).  It reads the
  host clock only: a stage that enqueues device work ends in a
  ``torch.cuda.synchronize()`` inside its block, or it measures the enqueue.
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import torch


@contextmanager
def maybe_profile(profile_dir: Optional[str] = None):
    """torch.profiler around the block when a directory is configured."""
    profile_dir = profile_dir or os.environ.get("LIGHT_UNET_PROFILE")
    if not profile_dir:
        yield None
        return
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield str(out)
    trace = out / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(trace))
    print(f"Profiler trace written to {trace} (open with chrome://tracing or Perfetto)")


class StageTimer:
    """Accumulating wall-clock timers for named stages."""

    def __init__(self):
        self._totals: "OrderedDict[str, float]" = OrderedDict()
        self._counts: "OrderedDict[str, int]" = OrderedDict()

    @contextmanager
    def time(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {
                "total_seconds": round(total, 4),
                "calls": self._counts[name],
                "seconds_per_call": round(total / max(self._counts[name], 1), 4),
            }
            for name, total in self._totals.items()
        }

    def report(self, prefix: str = "") -> None:
        for name, row in self.summary().items():
            print(
                f"{prefix}{name}: {row['total_seconds']:.2f}s total, "
                f"{row['calls']} calls, {row['seconds_per_call']:.3f}s/call"
            )

    def save(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
