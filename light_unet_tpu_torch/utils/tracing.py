"""Profiling hook (port of ``light_unet_tpu/utils/tracing.py:maybe_profile``).

``maybe_profile(profile_dir)`` wraps ``torch.profiler`` (CPU and, when
available, CUDA activity) around a block when a directory is given
(``tpu.profile_dir``, or the ``LIGHT_UNET_PROFILE`` environment variable)
and writes a Chrome trace there; with no directory it does nothing.
"""

from __future__ import annotations

import os
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
