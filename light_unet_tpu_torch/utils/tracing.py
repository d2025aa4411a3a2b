"""Tracing and timing (port of ``light_unet_tpu/utils/tracing.py``).

* ``maybe_profile(profile_dir)`` wraps ``torch.profiler`` (CPU and, when
  available, CUDA activity) around a block when a directory is given
  (``tpu.profile_dir``, or the ``LIGHT_UNET_PROFILE`` environment variable)
  and writes a Chrome trace there; with the profiler it turns the recorder
  below on and writes the block's spans and counters as
  ``spans_<pid>.json`` beside the trace.  With no directory it does nothing.
* The recorder: ``span(name, req)`` around the program's host work at each
  layer boundary (decode, prepare, dispatch, replay, fetch, table, writes)
  and ``count(name, n)`` at the same boundaries.  ``enable(on)`` is its only
  switch, off by default.  Off, ``span`` is one flag check that returns a
  shared no-op and ``count`` does nothing.  On, each span appends one
  record to a bounded in-memory buffer (``take()`` drains it): name,
  request id (a case id or a volume's sequence number; a span without one
  takes its parent's, else the thread's ``request``), the unit a graph
  replay runs, its own id and its parent's (the innermost span open on the
  same thread), the OS thread id, and start and end in ``time.time_ns()``,
  the clock ``torch.profiler`` stamps its events in.  While a profiler
  session is active a span also opens a ``record_function`` range named
  ``lu.<name>``, so a trace shows the program's ranges apart from torch's.
  ``snapshot()`` returns the counters with the program's module counters
  (kernel launches, native calls, graph replays and captures by runner,
  and the dicts that modules register with ``register_counts``, such as
  SwinUNETR's forwards and attention calls and tokens, MedNeXt's forwards,
  blocks and resampling convs, and the 5^3 depthwise kernel's launches).
* ``StageTimer`` accumulates wall-clock time of named stages across
  ``time(name)`` blocks and reports totals, calls and seconds per call, or
  writes them as JSON (the JAX package's keys and rounding).  It reads the
  host clock only: a stage that enqueues device work ends in a
  ``torch.cuda.synchronize()`` inside its block, or it measures the enqueue.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import OrderedDict, defaultdict
from contextlib import contextmanager, nullcontext
from pathlib import Path
from typing import Dict, List, Optional

import torch

PREFIX = "lu."       # the profiler range of span ``x`` is ``lu.x``
MAX_SPANS = 1 << 16  # records held until ``take()``; later ones count as ``spans.dropped``

_on = False
_spans: List[dict] = []
_counters: Dict[str, int] = defaultdict(int)
_lock = threading.Lock()  # spans and counts come from worker threads too
_local = threading.local()  # per thread: ``stack`` of open spans, ``req``
_ids = itertools.count(1)
# counter dicts that modules keep whether or not the recorder is on, by the
# prefix ``snapshot()`` gives their keys, in the order they were registered
_registered: Dict[str, Dict[str, int]] = {}
_clock = time.time_ns
_NOOP = nullcontext()


def enable(on: bool) -> None:
    """Turn the recorder on or off (spans already open still close)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "req", "unit", "id", "parent", "t0", "range")

    def __init__(self, name: str, req, unit):
        self.name, self.req, self.unit = name, req, unit

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        if self.req is None:
            self.req = parent.req if parent is not None else getattr(_local, "req", None)
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.range = None
        stack.append(self)
        self.t0 = _clock()  # the span holds its range: stamped before it opens
        if torch.autograd._profiler_enabled():
            self.range = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = _clock()
        _stack().pop()
        rec = {"name": self.name, "req": self.req, "unit": self.unit, "id": self.id,
               "parent": self.parent, "tid": threading.get_native_id(), "start_ns": self.t0,
               "end_ns": t1}
        with _lock:
            if len(_spans) < MAX_SPANS:
                _spans.append(rec)
            else:
                _counters["spans.dropped"] += 1
        return False


def span(name: str, req=None, unit: Optional[str] = None):
    """A context manager that records the block as span ``name`` while the
    recorder is on (``req``: the request id; ``unit``: the graph unit)."""
    return _Span(name, req, unit) if _on else _NOOP


@contextmanager
def _request(req):
    prev = getattr(_local, "req", None)
    _local.req = req
    try:
        yield
    finally:
        _local.req = prev


def request(req):
    """The block's spans on this thread carry ``req`` unless they name one
    (a case id around the calls that work on that case)."""
    return _request(req) if _on else _NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if _on:
        with _lock:
            _counters[name] += n


def register_counts(prefix: str, counts: Dict[str, int]) -> Dict[str, int]:
    """Have ``snapshot()`` report the module's ``counts`` (a dict of ints
    whose keys stay fixed) as ``<prefix>.<key>``, and a CUDA graph replay
    advance them by what its capture added (``utils/graphs.py``); returns
    ``counts``.  A prefix registered again keeps its place."""
    _registered[prefix] = counts
    return counts


def registered_counts() -> Dict[str, Dict[str, int]]:
    """The registered counter dicts by prefix, in the order they came."""
    return _registered


def snapshot() -> Dict[str, int]:
    """Every counter: the recorder's, and the program's module counters as
    they stand (kernel launches and plain calls, the native library's calls
    by entry, graph replays and captures by runner, the registered dicts)."""
    from light_unet_tpu_torch.ops import block_kernel, ccl_kernel, depthwise_kernel, norm_kernel
    from light_unet_tpu_torch.utils import fastio, graphs

    with _lock:
        out = dict(_counters)
    out.update({"block_kernel.launches": block_kernel.launches,
                "block_kernel.plain_calls": block_kernel.plain_calls,
                "norm_kernel.launches": norm_kernel.launches,
                "depthwise_kernel.launches": depthwise_kernel.launches,
                "depthwise_kernel.plain_calls": depthwise_kernel.plain_calls,
                "ccl_kernel.launches": ccl_kernel.launches})
    for prefix, counts in _registered.items():
        out.update({f"{prefix}.{k}": v for k, v in counts.items()})
    out.update({f"fastio.calls.{k}": v for k, v in fastio.calls.items()})
    out.update({f"graphs.{k}": v for k, v in graphs.counters().items()})
    return out


def take() -> List[dict]:
    """The recorded spans, in the order they ended; the buffer is emptied."""
    with _lock:
        out = list(_spans)
        _spans.clear()
    return out


def self_ns(spans: List[dict]) -> Dict[str, int]:
    """Self time by span name: each span's duration less its children's."""
    inner: Dict[int, int] = defaultdict(int)
    for s in spans:
        if s["parent"] is not None:
            inner[s["parent"]] += s["end_ns"] - s["start_ns"]
    out: Dict[str, int] = defaultdict(int)
    for s in spans:
        out[s["name"]] += s["end_ns"] - s["start_ns"] - inner[s["id"]]
    return dict(out)


@contextmanager
def maybe_profile(profile_dir: Optional[str] = None):
    """torch.profiler and the recorder around the block when a directory is
    configured."""
    profile_dir = profile_dir or os.environ.get("LIGHT_UNET_PROFILE")
    if not profile_dir:
        yield None
        return
    out = Path(profile_dir)
    out.mkdir(parents=True, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    # a recorder already on belongs to an outer reader: its spans stay in the buffer
    was_on = enabled()
    t0 = _clock()
    before = snapshot()
    enable(True)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield str(out)
    finally:
        enable(was_on)
    trace = out / f"trace_{os.getpid()}.json"
    prof.export_chrome_trace(str(trace))
    with _lock:
        spans = [s for s in _spans if s["start_ns"] >= t0]
        if not was_on:
            _spans.clear()
    after = snapshot()
    record = {"spans": spans,
              "self_ms": {k: v * 1e-6 for k, v in self_ns(spans).items()},
              "counters": {k: v - before.get(k, 0) for k, v in after.items()}}
    (out / f"spans_{os.getpid()}.json").write_text(json.dumps(record))
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
