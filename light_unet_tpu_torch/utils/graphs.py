"""CUDA graphs: one device program per dispatch unit (the port's counterpart
of the JAX package's ``jax.jit`` programs).

The JAX package compiles every dispatch unit into one device program: the
training step and its K-step chain (``light_unet_tpu/core/trainer.py:538-585``),
the whole sliding window of a volume (``ops/sliding_window.py:165-203``, and
its patch- and slab-sharded programs), the fused per-volume program and the
preprocess pass (``ops/fused.py``), the candidate table
(``ops/components.py``) and the validation sweep (``ops/val_metrics.py``).
The port captures the same units with ``torch.cuda.CUDAGraph`` and replays
them, so that a unit costs the host one replay instead of hundreds of
launches, and no unit reads a device value on the host.  A unit's key
(``unit_key``) is the JAX program's static arguments by name, with the
shapes and dtypes of its inputs; whatever differs per volume (positions,
true extents, value ranges, thresholds, masks) is an input, device data in
the graph's static buffers.

``GraphRunner`` keeps one graph per key (the counterpart of JAX's compiled
variants):

* the first call of a key runs the unit eagerly on the runner's side
  stream.  That run is the warm-up (cuDNN picks its algorithms, an NCCL
  communicator comes up, the norm kernel's workspace is made) and a real
  dispatch: its outputs are returned.  Then the unit is captured on the
  same stream into the runner's memory pool, which all its graphs share;
* every later call copies its inputs into the graph's static input buffers
  and replays.  It returns the graph's static outputs, which the next
  replay of the runner overwrites: a caller that keeps them copies them.

The generators given are registered with every graph, so a replay advances
each one's Philox offset as the eager calls would, and ``set_state`` on such
a generator moves the stream the graphs read.  The kernels' launch counters
(``ops/block_kernel.launches``, ``ops/norm_kernel.launches``,
``ops/ccl_kernel.launches``, ``ops/depthwise_kernel.launches``) count a
captured launch once per replay and not at the capture, which runs nothing;
so do the counter dicts that modules register with
``tracing.register_counts`` (SwinUNETR's forwards and window attention
calls and tokens, MedNeXt's forwards and blocks, the 5^3 depthwise kernel's
launches).
Graph memory (the pool's growth at each capture) is charged to an
``HbmLedger`` when one is given, and every capture appends a ``Capture``
record (runner, key, warm-up and capture seconds, pool growth, reserved and
peak device memory after it) to ``captures``.  A capture or replay error
raises; nothing falls back to the eager unit.

A graph bakes every address it reads: the static buffers, and whatever the
unit reads besides (parameters, optimizer state, a corpus).  Those must keep
their storage for the life of the runner; updates go in place.

The keys of one runner share its memory pool: a key's capture takes the
blocks that the earlier keys' captures freed, so the pool of a runner with
a key per z bucket is about that of its largest key, not their sum
(``chip_smoke.py`` phase 14: no growth at the second to fourth bucket of
the window and the fused program).  A replay may therefore overwrite what
another key keeps in the same blocks, its intermediates or its static
outputs.  That is safe, and the keys replay in any order, because (1) a
replay writes every intermediate before it reads it; (2) every replay runs
on the caller's one stream, so no two replays overlap; (3) a key's static
outputs are read only before the runner's next replay: ``run_unit`` clones
them at once.  Runners do not share pools: each has its own, and its own
capture stream.
"""

from __future__ import annotations

import importlib
import itertools
import time
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from light_unet_tpu_torch.utils import tracing

# modules whose ``launches`` counter a replay advances by what its capture recorded
LAUNCH_COUNTERS = ("light_unet_tpu_torch.ops.block_kernel", "light_unet_tpu_torch.ops.norm_kernel",
                   "light_unet_tpu_torch.ops.ccl_kernel",
                   "light_unet_tpu_torch.ops.depthwise_kernel")
# every live runner, so that ``release`` can destroy their graphs
_runners: "weakref.WeakSet[GraphRunner]" = weakref.WeakSet()
_serial = itertools.count()


class Capture(NamedTuple):
    """One key's capture: its runner (name and serial number), warm-up and
    capture seconds, the pool's growth, and the device's reserved and peak
    allocated bytes just after it."""

    runner: str
    serial: int
    key: tuple
    warmup_s: float
    capture_s: float
    pool_bytes: int
    reserved: int
    peak: int


# every capture of the process, in order (a few records a key)
captures: List[Capture] = []


def _counters() -> Tuple[int, ...]:
    """The launch counters of ``LAUNCH_COUNTERS``, then the values of the
    registered counter dicts (``tracing.registered_counts``) in their order.
    Dicts are only ever added at the end, so a capture's counts still line
    up with the dicts after a later registration."""
    out = [importlib.import_module(m).launches for m in LAUNCH_COUNTERS]
    for table in tracing.registered_counts().values():
        out += table.values()
    return tuple(out)


def _add_launches(counts: Sequence[int]) -> None:
    """Add ``counts`` (as ``_counters`` orders them) to the counters."""
    counts = iter(counts)
    for name, n in zip(LAUNCH_COUNTERS, counts):
        if n:
            importlib.import_module(name).launches += n
    for table in tracing.registered_counts().values():
        for key, n in zip(list(table), counts):
            table[key] += n


class Captured(NamedTuple):
    """One key's graph: its static inputs and outputs and the kernel launches
    one replay makes (per ``LAUNCH_COUNTERS``)."""

    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    outputs: Tuple[torch.Tensor, ...]
    launches: Tuple[int, ...]


class GraphRunner:
    """Capture a unit once per key, replay it after (see the module doc).

    ``name`` names the ledger entry; ``generators`` are the CUDA generators
    the units draw from."""

    def __init__(self, name: str, device, ledger=None,
                 generators: Sequence[torch.Generator] = ()):
        self.name = name
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, got {self.device}")
        self.ledger = ledger
        self.generators = list(generators)
        self.graphs: Dict[tuple, Captured] = {}
        self.pool = None
        self.stream = None
        self.replays = 0
        self.warmup_seconds: Dict[tuple, float] = {}
        self.capture_seconds: Dict[tuple, float] = {}
        self.pool_bytes = 0
        self.serial = next(_serial)
        _runners.add(self)

    def __call__(self, key: tuple, fn: Callable, *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)`` (a tensor or a tuple of tensors) as a tuple: the
        warm-up's own outputs at a key's first call, else the graph's static
        outputs after one replay.  ``inputs`` may lie on the host (pinned
        memory copies without blocking) or on the device."""
        entry = self.graphs.get(key)
        if entry is None:
            return self._capture(key, fn, inputs)
        if len(inputs) != len(entry.inputs):
            raise ValueError(f"graph {key}: {len(inputs)} inputs, captured with {len(entry.inputs)}")
        for static, x in zip(entry.inputs, inputs):
            if static.shape != x.shape or static.dtype != x.dtype:
                raise ValueError(f"graph {key}: input {x.dtype} {tuple(x.shape)}, captured with "
                                 f"{static.dtype} {tuple(static.shape)}")
            static.copy_(x, non_blocking=True)
        entry.graph.replay()
        _add_launches(entry.launches)
        self.replays += 1
        return entry.outputs

    def _capture(self, key, fn, inputs):
        dev = self.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
            self.pool = torch.cuda.graph_pool_handle()
        cur = torch.cuda.current_stream(dev)
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev) for x in inputs)
        for s, x in zip(static, inputs):
            s.copy_(x, non_blocking=True)
        self.stream.wait_stream(cur)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        with torch.cuda.stream(self.stream):
            first = _as_tuple(fn(*static))  # the warm-up: a real dispatch
            t1 = time.perf_counter()
            # the cached blocks of the general pool go back to the device, so
            # that the graph's private pool can take their memory
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            before = _counters()
            graph.capture_begin(self.pool, capture_error_mode="thread_local")
            try:
                outputs = _as_tuple(fn(*static))
            finally:  # a failed capture ends (and raises) here too
                graph.capture_end()
        launches = tuple(a - b for a, b in zip(_counters(), before))
        _add_launches([-n for n in launches])  # the capture launched nothing
        grown = max(0, torch.cuda.memory_reserved(dev) - reserved)
        self.pool_bytes += grown
        if self.ledger is not None:
            self.ledger.charge(f"graphs:{self.name}", grown)
        for t in first:
            t.record_stream(cur)
        cur.wait_stream(self.stream)
        self.graphs[key] = Captured(graph, static, outputs, launches)
        self.warmup_seconds[key] = t1 - t0
        self.capture_seconds[key] = time.perf_counter() - t1
        captures.append(Capture(self.name, self.serial, key, t1 - t0, self.capture_seconds[key],
                                grown, torch.cuda.memory_reserved(dev),
                                torch.cuda.max_memory_allocated(dev)))
        return first


def counters() -> Dict[str, int]:
    """``replays.<runner>`` (over the live runners) and ``capture.<runner>``
    (over ``captures``) by runner name."""
    out: Dict[str, int] = {}
    for runner in list(_runners):
        out[f"replays.{runner.name}"] = out.get(f"replays.{runner.name}", 0) + runner.replays
    for c in captures:
        out[f"capture.{c.runner}"] = out.get(f"capture.{c.runner}", 0) + 1
    return out


def release() -> None:
    """Destroy the graphs of every live runner (each captures again at its
    next use).  An NCCL communicator must outlive the graphs that captured
    its collectives: a process group destroyed under live ones hangs, so
    ``parallel/distributed.py:finish`` calls this first."""
    for runner in list(_runners):
        if runner.graphs:
            torch.cuda.synchronize(runner.device)
            runner.graphs.clear()


def _as_tuple(out) -> Tuple[torch.Tensor, ...]:
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def unit_key(unit: str, apply_fn=None, **static) -> tuple:
    """A unit's graph key: its name; the compute dtype of the network
    ``apply_fn`` it runs (a model that ``models.unet3d.build_model`` returns,
    ``Lightweight3DUNet`` or ``SwinUNETR``, or ``make_fused_apply``'s
    function), the float32 convolutions' TF32 flag and the function's
    identity, which tells the model's route from ``fused_block``'s; then its
    static arguments as (name, value) pairs.
    ``run_unit`` appends the shapes and dtypes of the inputs."""
    return (unit, getattr(apply_fn, "compute_dtype", None), torch.backends.cudnn.allow_tf32,
            id(apply_fn)) + tuple(sorted(static.items()))


def run_unit(runner: Optional["GraphRunner"], key: tuple, fn: Callable,
             *inputs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs)`` as a tuple of tensors the caller owns: eagerly without
    a runner (the CPU, ``graphs=False``, a gloo mesh), else one replay of the
    key's graph, its outputs copied out of the static buffers that the
    runner's next replay overwrites.  Either is the span ``replay`` with the
    unit's name (``key[0]``)."""
    with tracing.span("replay", unit=key[0]):
        if runner is None:
            return _as_tuple(fn(*inputs))
        key = key + (tuple((tuple(x.shape), x.dtype) for x in inputs),)
        return tuple(t.clone() for t in runner(key, fn, *inputs))


def runner_for(device: torch.device, requested: bool, what: str, mesh=None,
               ledger=None, generators: Sequence[torch.Generator] = ()) -> Optional[GraphRunner]:
    """A ``GraphRunner`` for ``what`` on a CUDA ``device`` when ``requested``
    and not over a gloo ``mesh`` (gloo stages collectives through host
    memory, which a graph cannot hold); else None, the eager path, which a
    card logs with its reason.  The CPU has no graphs."""
    if device.type != "cuda":
        return None
    if not requested:
        print(f"{what}: eager (graphs=False: the reference path)")
        return None
    if mesh is not None and mesh.backend != "nccl":
        print(f"{what}: eager (the {mesh.backend} mesh stages its collectives through host "
              f"memory, which a CUDA graph cannot capture)")
        return None
    return GraphRunner(what, device, ledger, generators)
