#!/usr/bin/env python3
"""Training-step benchmark of the PyTorch port: host-streamed against
device-corpus batches (the port of ``scripts/bench_train_step.py``).

Measures steps/s (host sampling + upload + the step) at batch 2, 8 and 32
for both data paths, on ``N_CASES`` synthetic whole-body cases
(144x144x272, ``build_raw_dataset`` seed 0, normalized to [0, 1] on
write).  Each step goes through ``Trainer._step_on_batch``, so it is the
trainer's own dispatch unit: one CUDA graph replay on a card (``("host",)``
for a host batch, ``("step",)`` for a corpus corner batch).  The two paths
are interleaved segment by segment: ``STEPS`` steps each synchronized (the
median is ``step_ms_median_synced``), then ``STEPS`` steps dispatched
back to back and synchronized once (``step_ms_pipelined``, the trainer's
own mode).  One JSON line per (mode, batch), with the JAX script's keys.

    python3 scripts/bench_train_step_torch.py [--device cuda]

``Config()``'s training settings (bf16, 48^3 patches, separable
augmentation, uint16 transfer) with warmup and the body mask off, as the
JAX script sets them; ``tpu.device_corpus: false`` is the host path.  It
imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_CASES = 6
SHAPE = (144, 144, 272)
STEPS = 15
SEGMENTS = 3
BATCHES = (2, 8, 32)


class ModeBench:
    """One trainer and its data iterator; measures a segment on demand, so
    that the two paths can be interleaved within one process."""

    def __init__(self, tmp: Path, device_corpus: bool, batch: int, device):
        from light_unet_tpu_torch import bench as port_bench

        self.t = port_bench.bench_trainer(tmp, batch, device, device_corpus=device_corpus)
        self.loader = self.t.train_loader
        self.it = iter(self.loader)
        float(self._step_once())  # the warm-up and, on a card, the capture

    def _step_once(self):
        try:
            b = next(self.it)
        except StopIteration:
            self.it = iter(self.loader)
            b = next(self.it)
        return self.t._step_on_batch(b)

    def segment(self) -> tuple:
        times = []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            float(self._step_once())  # per-step sync: one step's latency
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        # pipelined: dispatch every step, sync once (the trainer's own mode)
        t0 = time.perf_counter()
        losses = [self._step_once() for _ in range(STEPS)]
        self.t._flatten_losses(losses)
        piped = (time.perf_counter() - t0) / STEPS
        return med, piped


def bench_batch(tmp: Path, batch: int, device, segments: int = SEGMENTS) -> list:
    from light_unet_tpu_torch import bench as port_bench

    host = ModeBench(tmp, False, batch, device)
    corpus = ModeBench(tmp, True, batch, device)
    res = {False: {"synced": [], "piped": []}, True: {"synced": [], "piped": []}}
    for _ in range(segments):
        for mode, b in ((False, host), (True, corpus)):
            med, piped = b.segment()
            res[mode]["synced"].append(med)
            res[mode]["piped"].append(piped)
    out = []
    for mode in (False, True):
        med = statistics.median(res[mode]["synced"])
        piped = statistics.median(res[mode]["piped"])
        out.append({
            "mode": "corpus" if mode else "host",
            "batch": batch,
            "step_ms_median_synced": round(med * 1e3, 1),
            "step_ms_pipelined": round(piped * 1e3, 1),
            "steps_per_sec_pipelined": round(1.0 / piped, 2),
            "piped_segments_ms": [round(x * 1e3, 1) for x in res[mode]["piped"]],
            "corpus_active": (corpus if mode else host).t.corpus is not None,
            "device": port_bench.device_line(device),
        })
    del host, corpus
    port_bench.release(device)
    return out


def main(argv=None) -> int:
    from light_unet_tpu_torch import bench as port_bench
    from light_unet_tpu_torch.utils.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        port_bench.processed_volumes(tmp, N_CASES, SHAPE)
        for batch in BATCHES:
            for r in bench_batch(tmp, batch, dev, SEGMENTS):
                print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
