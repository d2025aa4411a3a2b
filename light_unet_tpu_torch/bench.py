"""End-to-end serving benchmark of the PyTorch port (the port of the repo's
``bench.py:1-310``, which ``light_unet_tpu/cli.py`` runs as ``--mode bench``).

    python -m light_unet_tpu_torch.bench [--device cuda]
    python -m light_unet_tpu_torch.cli --mode bench [--device cuda]

Six synthetic whole-body volumes (144x144x272 at 4 mm, ``build_raw_dataset``
seed 0: the JAX bench's volumes bit for bit) go raw through
``FusedVolumePipeline``: native decode, clip percentiles, uint16 quantize
and pad, one device program per volume (normalize, the 48^3 sliding window,
the body mask), fetch.  Prints ONE JSON line with the JAX line's keys: the
median volumes/s of at least 3 passes with its min/max spread, one volume
split into phases, and a serial torch-CPU run of the reference's execution
model as the baseline.  ``detail.tpu`` is the accelerated run under the JAX
schema's name; its ``device`` key (nvidia-smi's name and power limit, or
``cpu``) is the one key the JAX line lacks.

The model and settings are ``Config()``'s: bfloat16, ``patch_batch`` 192,
uint16 transfer and fetch, sparse fetch, and the plain route (not
``tpu.fused_block``), with seeded random weights.
``--mode bench`` takes no config, as in the JAX CLI, unless ``--config``
names one: then the pipeline runs that config's model and settings
(``configs/swinunetr_fs48_roi96.yaml``: SwinUNETR, 20 windows of 96^3 a
volume; ``configs/mednext_l_k5_roi128.yaml``: MedNeXt-L k5, 16 windows of
128^3).  The CPU baseline times the lightweight U-Net, so a config of
another model prints no baseline: ``vs_baseline`` and
``detail.torch_cpu_serial_baseline`` are null.

There is no supervisor: the JAX one retries in a child process and prints
``"value": 0.0`` on failure, for a flaky remote link.  Here a failure
raises and the process exits non-zero.

The helpers below (``default_config``, ``seeded_model``, ``raw_volumes``,
``processed_volumes``, ``bench_trainer``, ``device_line``, ``elapsed_ms``,
``release``) serve the port's measurement scripts as well
(``scripts/{bench_train_step,bench_fused_block,bench_link_opts,roofline}_torch.py``).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.inferencer import COMPUTE_DTYPES
from light_unet_tpu_torch.models.fused_forward import make_fused_apply
from light_unet_tpu_torch.models.unet3d import build_model, init_weights
from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
from light_unet_tpu_torch.ops.sliding_window import compute_positions
from light_unet_tpu_torch.tools.synthetic import build_raw_dataset, write_split_files
from light_unet_tpu_torch.utils import fastio, nifti
from light_unet_tpu_torch.utils.device import resolve_device

METRIC = "volumes_per_sec_e2e_preprocess_plus_sliding_window_144x144x272"
VOLUME_SHAPE = (144, 144, 272)
N_VOLUMES = 6
PATCH = (48, 48, 48)
BASELINE_MODEL = "Lightweight3DUNet"  # what bench_torch_cpu_baseline times


def default_config() -> Config:
    """``Config()`` with ``PATCH`` as the patch size (the bench's settings)."""
    cfg = Config()
    cfg.data.patch_size = list(PATCH)
    return cfg


def seeded_model(cfg: Config, device, seed: int = 0):
    """(inference model, apply_fn) of ``cfg`` on ``device`` with seeded random
    weights, as ``core/inferencer.py`` builds it: ``tpu.fused_block`` runs the
    blocks through the block kernel, and otherwise every norm runs the norm
    kernel."""
    model = build_model(cfg.model, COMPUTE_DTYPES[cfg.tpu.compute_dtype], inference=True)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    return model, (make_fused_apply(model) if cfg.tpu.fused_block else model)


def raw_volumes(tmpdir: Path, n: int, shape=None) -> list:
    """``n`` raw cases 0001.. of ``shape`` (default ``VOLUME_SHAPE``) under
    ``tmpdir`` (seed 0); returns the case ids."""
    ids = [f"{i:04d}" for i in range(1, n + 1)]
    return build_raw_dataset(tmpdir, ids, shape=tuple(shape or VOLUME_SHAPE), seed=0)


def processed_volumes(tmp: Path, n: int, shape) -> list:
    """``n`` phantoms of ``shape`` (seed 0) normalized to [0, 1] under
    ``tmp/processed``, with split files under ``tmp/splits`` (every case
    trains, the first validates), as the JAX training benches write them;
    returns the case ids."""
    ids = raw_volumes(tmp / "processed", n, shape)
    for cid in ids:
        p = image_path(tmp / "processed", cid)
        img = nifti.load(p).get_fdata()
        img = (img - img.min()) / max(img.max() - img.min(), 1e-8)
        nifti.save(nifti.Nifti1Image(img.astype(np.float32), np.diag([4, 4, 4, 1])), p)
    write_split_files(tmp / "splits", ids, ids[:1])
    return ids


def bench_trainer(tmp: Path, batch: int, device, **tpu):
    """A ``Trainer`` of ``default_config()`` on ``processed_volumes``' tree
    at ``batch``, without warmup or body mask (as the JAX training benches
    set them), with the ``tpu`` settings given (``device_corpus``,
    ``steps_per_dispatch``)."""
    from light_unet_tpu_torch.core.trainer import Trainer

    cfg = default_config()
    cfg.training.batch_size = batch
    cfg.training.use_warmup = False
    cfg.data.body_mask.enabled = False
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    cfg.data_dir = str(tmp / "processed")
    cfg.splits_dir = str(tmp / "splits")
    name = "_".join(f"{k}{v}" for k, v in sorted(tpu.items()))
    return Trainer(cfg, workdir=str(tmp / f"w_b{batch}_{name}"), device=device)


def image_path(tmpdir: Path, cid: str) -> Path:
    return Path(tmpdir) / "images" / f"{cid}_0000.nii.gz"


def device_line(device) -> str:
    """nvidia-smi's ``name, power.limit`` (its first card) for a CUDA
    ``device``; ``cpu`` else."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def elapsed_ms(fn, device, calls: int = 1) -> float:
    """Milliseconds per call of ``calls`` back-to-back ``fn()``: CUDA events
    on a card, the host clock elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return (time.perf_counter() - t0) * 1e3 / calls


def release(device) -> None:
    """Give the device memory of dead runners and tensors back (a runner's
    graphs hold their pool until the runner is collected)."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def make_pipeline(cfg: Config, device):
    """(model, ``FusedVolumePipeline``) as the bench serves: ``cfg``'s route,
    transfers, sparse fetch and ``patch_batch``, CUDA graphs on a card."""
    model, apply_fn = seeded_model(cfg, device)
    return model, FusedVolumePipeline(apply_fn, cfg, patch_batch=cfg.tpu.patch_batch,
                                      device=device)


def bench_gpu(tmpdir: Path, ids, device="cuda", reps: int = 3, max_reps: int = 7,
              spread_ratio: float = 2.5, rep_budget_s: float = 900.0, config=None) -> dict:
    """The fused pipeline over the raw volumes ``ids`` (the counterpart of
    ``bench.py:bench_tpu``).  Decode and prepare (percentiles, quantize +
    pad, upload) run on 2 worker threads, as ``Inferencer.infer_split``
    prepares; each volume's program is dispatched before the previous map
    is fetched.

    Volume 0 is the warm-up: its seconds, the kernel builds and the one
    graph capture included (every volume has the bucketed shape of volume
    0, so one key), are ``compile_seconds``.  No capture happens inside the
    timed passes, so the workers' uploads never meet one.  The timed pass
    repeats at least ``reps`` times, and more while max/min exceeds
    ``spread_ratio``, up to ``max_reps`` or ``rep_budget_s``; the headline
    is the median.  Then one volume is split serially into decode,
    host_prepare (up to the upload's end), dispatch (returns before the
    device is done) and device_compute_fetch (the synchronous fetch).

    ``config`` is for tests' tiny models; by default ``default_config()``."""
    dev = resolve_device(device)
    cfg = config if config is not None else default_config()
    _, pipe = make_pipeline(cfg, dev)
    paths = [image_path(tmpdir, cid) for cid in ids]

    def load_and_prepare(path):
        return pipe.prepare(fastio.load_f32(path)[0])

    def run_all():
        results = []
        pending = None
        with ThreadPoolExecutor(max_workers=2) as pool:
            for prep in pool.map(load_and_prepare, paths):
                disp = pipe.dispatch(prep)
                if pending is not None:
                    results.append(pipe.fetch(pending))
                pending = disp
            results.append(pipe.fetch(pending))
        return results

    sync(dev)
    t0 = time.perf_counter()
    pipe(fastio.load_f32(paths[0])[0])
    compile_s = time.perf_counter() - t0

    rep_vps = []
    probs = None
    loop_t0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        probs = run_all()
        rep_vps.append(len(ids) / (time.perf_counter() - t0))
        if len(rep_vps) < reps:
            continue
        if len(rep_vps) >= max_reps or time.perf_counter() - loop_t0 > rep_budget_s:
            break
        if max(rep_vps) / max(min(rep_vps), 1e-9) <= spread_ratio:
            break
    if len(probs) != len(ids) or not all(np.isfinite(p).all() for p in probs):
        raise RuntimeError("the bench's maps are missing or not finite")
    vps = statistics.median(rep_vps)

    phases = {"decode": [], "host_prepare": [], "dispatch": [], "device_compute_fetch": []}
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        img = fastio.load_f32(paths[0])[0]
        t1 = time.perf_counter()
        prep = pipe.prepare(img)
        sync(dev)
        t2 = time.perf_counter()
        disp = pipe.dispatch(prep)
        t3 = time.perf_counter()
        pipe.fetch(disp)
        t4 = time.perf_counter()
        phases["decode"].append(t1 - t0)
        phases["host_prepare"].append(t2 - t1)
        phases["dispatch"].append(t3 - t2)
        phases["device_compute_fetch"].append(t4 - t3)

    return {
        "volumes_per_sec": vps,
        "volumes_per_sec_min": min(rep_vps),
        "volumes_per_sec_max": max(rep_vps),
        "volumes_per_sec_reps": [round(v, 4) for v in rep_vps],
        "seconds_per_volume": 1.0 / vps,
        "phase_seconds_median": {k: round(statistics.median(v), 4) for k, v in phases.items()},
        "compile_seconds": compile_s,
        "n_volumes": len(ids),
        "n_reps": len(rep_vps),
        "backend": dev.type,
        "device": device_line(dev),
    }


def bench_torch_cpu_baseline(tmpdir: Path, cid: str, sample_patches: int = 12) -> dict:
    """Reference-style serial pipeline on torch CPU, extrapolated
    (``bench.py:155-262``): scipy preprocess, then a per-patch forward of a
    plain 217K-parameter U-Net over a sample of the grid."""
    import torch.nn as nn
    from scipy import ndimage

    torch.set_num_threads(max(1, (torch.get_num_threads())))

    # compact 217K-param U-Net equivalent for timing (same ops/shapes as the
    # architecture spec; weights random — timing only)
    def dws(cin, cout):
        return nn.Sequential(
            nn.Conv3d(cin, cin, 3, padding=1, groups=cin, bias=False),
            nn.Conv3d(cin, cout, 1, bias=False),
        )

    class Block(nn.Module):
        def __init__(self, cin, cout):
            super().__init__()
            self.c1, self.n1 = dws(cin, cout), nn.InstanceNorm3d(cout, affine=True)
            self.c2, self.n2 = dws(cout, cout), nn.InstanceNorm3d(cout, affine=True)
            self.short = (
                nn.Sequential(nn.Conv3d(cin, cout, 1, bias=False), nn.InstanceNorm3d(cout, affine=True))
                if cin != cout
                else nn.Identity()
            )
            self.act = nn.LeakyReLU(0.01)

        def forward(self, x):
            r = self.short(x)
            h = self.act(self.n1(self.c1(x)))
            return self.act(self.n2(self.c2(h)) + r)

    class Net(nn.Module):
        def __init__(self, ch=(16, 32, 64, 128)):
            super().__init__()
            self.e0 = Block(1, ch[0])
            self.down = nn.ModuleList([Block(ch[i], ch[i + 1]) for i in range(3)])
            self.pool = nn.MaxPool3d(2)
            self.mid = Block(ch[3], ch[3])
            self.up = nn.ModuleList([nn.ConvTranspose3d(ch[3 - i], ch[3 - i] // 2, 2, 2) for i in range(3)])
            self.dec = nn.ModuleList([Block(ch[3 - i], ch[2 - i]) for i in range(3)])
            self.head = nn.Conv3d(ch[0], 1, 1)

        def forward(self, x):
            skips = [self.e0(x)]
            h = skips[0]
            for blk in self.down:
                h = blk(self.pool(h))
                skips.append(h)
            h = self.mid(h)
            for i in range(3):
                h = self.up[i](h)
                h = self.dec[i](torch.cat([h, skips[2 - i]], dim=1))
            return torch.sigmoid(self.head(h))

    model = Net().eval()

    t0 = time.time()
    img = nifti.load(image_path(tmpdir, cid)).get_fdata()
    load_s = time.time() - t0

    # host preprocess (numpy/scipy, as the reference does)
    t0 = time.time()
    lo, hi = np.percentile(img, 0.5), np.percentile(img, 99.5)
    norm = (np.clip(img, lo, hi) - lo) / max(hi - lo, 1e-8)
    mask = norm > 0.02
    struct = ndimage.iterate_structure(ndimage.generate_binary_structure(3, 1), 5)
    mask = ndimage.binary_closing(mask, structure=struct)
    labeled, n = ndimage.label(mask)
    if n:
        sizes = ndimage.sum(mask, labeled, range(1, n + 1))
        mask = labeled == (np.argmax(sizes) + 1)
    mask = ndimage.binary_dilation(mask, ndimage.generate_binary_structure(3, 1), iterations=3)
    preprocess_s = time.time() - t0

    positions = compute_positions(norm.shape, PATCH, 0.5)
    patch_times = []
    with torch.no_grad():
        # warmup
        model(torch.zeros(1, 1, *PATCH))
        for z, y, x in positions[:sample_patches]:
            # time the WHOLE serial per-patch cost (slice+pad+tensor
            # conversion+forward+fetch) — the reference pipeline pays all of
            # it per grid position
            t0 = time.time()
            patch = norm[z : z + PATCH[0], y : y + PATCH[1], x : x + PATCH[2]]
            if patch.shape != PATCH:
                patch = np.pad(patch, [(0, p - s) for p, s in zip(PATCH, patch.shape)])
            t = torch.from_numpy(np.ascontiguousarray(patch)).float()[None, None]
            model(t).squeeze().numpy()
            patch_times.append(time.time() - t0)
    per_patch = float(np.mean(patch_times))
    total = load_s + preprocess_s + per_patch * len(positions)
    return {
        "volumes_per_sec": 1.0 / total,
        "seconds_per_volume": total,
        "n_patches": int(len(positions)),
        "per_patch_seconds": per_patch,
        # per-patch spread: vs_baseline's variance across runs follows the
        # host's load through this number, so it is quoted beside the ratio
        "per_patch_seconds_min": float(np.min(patch_times)),
        "per_patch_seconds_max": float(np.max(patch_times)),
        "per_patch_seconds_std": float(np.std(patch_times)),
        "n_sample_patches": len(patch_times),
    }


def _rounded(d: dict) -> dict:
    return {k: round(v, 4) if isinstance(v, float) else v for k, v in d.items()}


def run_bench(device="cuda", config=None) -> dict:
    """Write the volumes, run ``bench_gpu`` (at ``config``, by default
    ``default_config()``) and the CPU baseline, print the JSON line
    (``bench.py:265-310``) and return it.

    The JAX bench first turns on XLA's persistent compilation cache
    (``bench.py:269-272``); the port has no counterpart to turn on
    (``config.py:462-466``): its kernels build once into
    ``light_unet_tpu_torch/_kernels_build/`` and each process captures its
    own graphs, which ``compile_seconds`` includes."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as td:
        tmpdir = Path(td)
        ids = raw_volumes(tmpdir, N_VOLUMES)
        gpu = bench_gpu(tmpdir, ids, device=dev, config=config)
        release(dev)  # the pipeline's graph pool, before the baseline
        same_model = config is None or config.model.name == BASELINE_MODEL
        baseline = bench_torch_cpu_baseline(tmpdir, ids[0]) if same_model else None

    result = {
        "metric": METRIC,
        "value": round(gpu["volumes_per_sec"], 4),  # median of n_reps passes
        "unit": "volumes/sec",
        "vs_baseline": (round(gpu["volumes_per_sec"] / baseline["volumes_per_sec"], 2)
                        if baseline else None),
        "spread": {
            "min": round(gpu["volumes_per_sec_min"], 4),
            "max": round(gpu["volumes_per_sec_max"], 4),
        },
        "detail": {
            "tpu": _rounded(gpu),
            "torch_cpu_serial_baseline": _rounded(baseline) if baseline else None,
        },
    }
    print(json.dumps(result), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (default cuda; cpu only when asked for)")
    run_bench(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
