"""The benchmark's machinery: finding a cell's files by name, host spans,
the device trace and its reduction, and the result line.

Everything that belongs to one configuration, cell, driver or metric is a
file of its own under ``cellbench/``, found by the name ``BENCHMARK.json``
gives it:

* ``configs/<config>.json``: the configuration as it is run (``config``),
  its source, ``reduced`` and ``assumed``;
* ``workloads/<cell>.json``: the configuration's name, the driver
  (``driver``), the traffic's parameters (``params``), the limits of the
  correctness check (``limits``) and ``why``;
* ``drivers/<driver>.py``: ``run(cell) -> Outcome``, one a kind of traffic;
* ``metrics/<metric>.py``: ``read(outcome) -> float | None``, one a metric
  (a metric split by cell, ``<quantity>.<split>``, may share
  ``metrics/<quantity>.py``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "light_unet_tpu")


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"cellbench: no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str):
    """``cellbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"cellbench: no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"cellbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or for a metric
    split by the end-to-end metric it moves (``<quantity>.<split>``) without
    a file of its own, the quantity's ``metrics/<quantity>.py``."""
    base = name.rsplit(".", 1)[0]
    own = (ROOT / "metrics" / f"{name}.py").is_file()
    return load_module("metrics", name if own or base == name else base)


def peaks_for(kind: str) -> dict:
    """The published peaks of the card named ``kind`` (empty if unknown)."""
    table = json.loads((ROOT / "peaks.json").read_text())["cards"]
    for key, peaks in table.items():
        if key in kind:
            return peaks
    return {}


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run may not load, compared
    whole (``light_unet_tpu_torch`` is not ``light_unet_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclass
class Cell:
    """One cell as a driver sees it."""

    name: str
    workload: dict
    config: dict          # the configuration file (``config`` holds the settings)
    seed: int
    seconds: float
    trace: bool
    device: object
    workdir: Path
    t_start: float        # perf_counter at process start

    @property
    def params(self) -> dict:
        return self.workload.get("params", {})

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})

    def settings(self) -> dict:
        """A fresh copy of the configuration's settings, the run's seed in."""
        cfg = json.loads(json.dumps(self.config["config"]))
        cfg.setdefault("experiment", {})["seed"] = self.seed
        return cfg


class Spans:
    """Host spans the harness records around its calls into the program, on
    any thread: seconds by name, and (name, start, end) in wall-clock
    nanoseconds, which a traced run lays beside the device's activity."""

    def __init__(self):
        self.seconds: Dict[str, List[float]] = defaultdict(list)
        self.intervals: List[Tuple[str, int, int]] = []
        self._lock = threading.Lock()

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            t1 = time.time_ns()
            with self._lock:
                self.seconds[name].append((t1 - t0) * 1e-9)
                self.intervals.append((name, t0, t1))

    def wrap(self, fn, name: str):
        """``fn`` run inside the span ``name``."""
        def timed(*a, **k):
            with self(name):
                return fn(*a, **k)
        return timed


@dataclass
class Trace:
    """The reduction of one traced window."""

    busy_s: float
    window_s: float
    units: float                     # units of work that ran inside it
    ops: List[Tuple[str, float]]     # device seconds by kernel name, largest first
    gaps: List[Tuple[str, float]]    # longest idle gaps, named by the host span over them
    kernel_s: Dict[str, float] = field(default_factory=dict)


class Tracer:
    """``torch.profiler`` over a window of a traced run (CPU and CUDA
    activity).  ``start`` and ``stop`` bracket the window; ``stop``
    synchronizes first, so the window holds the device work it launched."""

    def __init__(self, enabled: bool, device, spans: Optional[Spans] = None):
        self.enabled = enabled
        self.device = device
        self.spans = spans
        self.prof = None
        self.trace: Optional[Trace] = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self._wall0 = time.time_ns()
        self._rf = record_function("cellbench.window")
        self._rf.__enter__()
        self._t0 = time.perf_counter()

    def stop(self, units: float) -> Optional[Trace]:
        if self.prof is None:
            return None
        import torch

        torch.cuda.synchronize(self.device)
        window_s = time.perf_counter() - self._t0
        self._rf.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        spans = list(self.spans.intervals) if self.spans is not None else []
        self.trace = reduce_trace(self.prof.profiler.kineto_results.events(), window_s, units,
                                  spans, self._wall0)
        self.prof = None
        return self.trace


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce_trace(events, window_s: float, units: float, spans=(), wall0: int = 0,
                 top: int = 10) -> Trace:
    """Busy seconds (the union of device activity inside the window), device
    seconds by kernel name, and the longest idle gaps, each named by the
    harness span (``Spans.intervals``, wall-clock ns from ``wall0``, the
    window's start) that overlaps it most (``host.none`` if none does).
    The window is the profiler's ``cellbench.window`` range; annotation
    ranges (``cellbench.*``) are not device activity."""
    from torch.autograd import DeviceType

    win = None
    dev: List[Tuple[int, int, str]] = []
    for e in events:
        name = e.name()
        if name.startswith("cellbench."):
            if name == "cellbench.window" and e.device_type() == DeviceType.CPU:
                win = (e.start_ns(), e.start_ns() + e.duration_ns())
        elif e.device_type() != DeviceType.CPU and e.duration_ns() > 0:
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), name))
    if win is None:
        raise RuntimeError("the trace holds no cellbench.window range")
    lo, hi = win
    shift = lo - wall0 if wall0 else 0
    host = [(s + shift, e + shift, n) for n, s, e in spans]
    dev = [(max(s, lo), min(e, hi), n) for s, e, n in dev if e > lo and s < hi]
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n in dev:
        by_name[n] += (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in dev])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    edge = lo
    for s, e in busy + [(hi, hi)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:top]:
        best, label = 0, "host.none"
        for s, e, n in host:
            ov = min(e, g1) - max(s, g0)
            if ov > best:
                best, label = ov, n
        named.append((label, (g1 - g0) * 1e-9))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return Trace(busy_s=busy_s, window_s=window_s, units=units, ops=ops[:top], gaps=named,
                 kernel_s=dict(by_name))


@dataclass
class Outcome:
    """What a driver hands back: the window's work and time, the set-up's
    split, spans, the trace, the work a unit holds, and the checks."""

    units: float                  # volumes, cases or samples done in the window
    window_s: float
    attempted: int
    failed: int
    setup_s: float
    peak_bytes: int
    setup_split: Dict[str, float] = field(default_factory=dict)
    spans: Optional[Spans] = None
    trace: Optional[Trace] = None
    work: Dict[str, float] = field(default_factory=dict)
    checks: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    detail: Dict[str, object] = field(default_factory=dict)

    @property
    def rate(self) -> float:
        return self.units / self.window_s

    @property
    def correct(self) -> bool:
        return passes(self.checks)


def passes(checks: Dict[str, Tuple[float, float]]) -> bool:
    """Whether every compared number is within its limit (and one is)."""
    return bool(checks) and all(v <= lim for v, lim in checks.values())


def checks_line(checks: Dict[str, Tuple[float, float]]) -> Dict[str, Dict[str, float]]:
    return {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
