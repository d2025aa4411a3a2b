#!/usr/bin/env python3
"""Reference-scale rehearsal of the PyTorch port (``light_unet_tpu_torch``).

The counterpart of ``scripts/full_scale_rehearsal.py``: it writes the same
synthetic cohort (123 cases at whole-body size, seed 42, z extents
272 + 8 * U{-3..3} so that they fall in two z buckets of 48, 2-6 lesions of
radius 2-5) and runs split, preprocess, train, inference and evaluate
through ``light_unet_tpu_torch.cli.run`` with ``configs/unet_fl70.yaml``
(read by the port's own YAML reader), epochs capped, ``T_max`` equal to the
epochs, 1 warmup epoch, a checkpoint every epoch and the last 2 kept.  The
config it runs is written with the port's ``Config.save``.

It prints one JSON record as its last line (also written to ``--out``):
seconds per stage, seconds per epoch of training and of validation, peak
host RSS, peak device memory and reserved memory after each stage (and
after releasing it: a finished stage's graphs must go), graph keys and pool
GiB per runner, the training corpus's bytes and bucket, the validation path
per epoch (device, escalated, host cases), the checkpoints left by the
rotation, and the inference and evaluate counts.

    python3 scripts/full_scale_rehearsal_torch.py --workdir /tmp/rehearsal
    python3 scripts/full_scale_rehearsal_torch.py --workdir /tmp/r --cases 6 \\
        --shape 24x24x40 --epochs 1 --config tiny.yaml --device cpu

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import sys
import time
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

REPO = Path(__file__).resolve().parent.parent
STAGES = ("split", "preprocess", "train", "inference", "evaluate")


def make_phantom(rng: np.random.Generator, shape: Tuple[int, int, int],
                 n_lesions: int, lesion_radius: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """(image, label) float32 phantom volumes: a body ellipsoid with hot
    spherical lesions (the port's copy of ``tests/synthetic.py:make_phantom``,
    the same draws from ``rng``)."""
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    cz, cy, cx = shape[0] / 2, shape[1] / 2, shape[2] / 2
    body = ((zz - cz) ** 2 / (0.42 * shape[0]) ** 2 + (yy - cy) ** 2 / (0.42 * shape[1]) ** 2
            + (xx - cx) ** 2 / (0.45 * shape[2]) ** 2) <= 1.0
    image = body * (2.0 + 0.4 * rng.random(shape)) + 0.01 * rng.random(shape)
    label = np.zeros(shape, np.float32)
    for _ in range(n_lesions):
        r = int(rng.integers(lesion_radius[0], lesion_radius[1] + 1))
        c = [int(rng.integers(int(d * 0.3), int(d * 0.7))) for d in shape]  # inside the body
        lesion = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r**2
        image[lesion] = 8.0 + rng.random()
        label[lesion] = 1.0
    return image.astype(np.float32), label


def write_cohort(raw_dir: Path, n_cases: int, shape: Tuple[int, int, int]) -> list:
    """The cohort of ``scripts/full_scale_rehearsal.py``: ids 0000.. (inside
    the FL id range), z jittered by 8 * U{-3..3}; returns the z extents."""
    from light_unet_tpu_torch.utils import nifti

    rng = np.random.default_rng(42)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for sub in ("images", "labels"):
        (raw_dir / sub).mkdir(parents=True, exist_ok=True)
    zs = []
    t0 = time.perf_counter()
    for i in range(n_cases):
        z = shape[2] + int(rng.integers(-3, 4)) * 8
        img, lab = make_phantom(rng, (shape[0], shape[1], z), int(rng.integers(2, 7)), (2, 5))
        nifti.save(nifti.Nifti1Image(img, aff), raw_dir / f"images/{i:04d}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab.astype(np.uint8), aff), raw_dir / f"labels/{i:04d}.nii.gz")
        zs.append(z)
        if (i + 1) % 20 == 0:
            print(f"  cohort: {i + 1}/{n_cases} ({time.perf_counter() - t0:.0f} s)", flush=True)
    return zs


def rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def instrument_trainer(record: Dict) -> None:
    """Time every training and validation epoch of the port's ``Trainer``
    and keep, after ``train``, its corpus and validation paths."""
    from light_unet_tpu_torch.core.trainer import Trainer

    def timed(name, fn):
        def run(self, *args, **kwargs):
            sync(self.device)
            t0 = time.perf_counter()
            out = fn(self, *args, **kwargs)
            sync(self.device)
            record.setdefault(name, []).append(round(time.perf_counter() - t0, 3))
            return out
        return run

    train = Trainer.train

    def train_and_record(self):
        out = train(self)
        corpus = self.corpus
        record["corpus"] = None if corpus is None else {
            "cases": corpus.n_cases, "bytes": int(corpus.per_chip_bytes),
            "bucket": list(corpus.images.shape[1:])}
        record["validation_paths"] = [
            {k: v for k, v in h.items() if k in ("epoch", "device", "escalated", "host",
                                                 "n_cases", "wall_seconds")}
            for h in self.val_fallback_history]
        record["steps_per_epoch"] = len(self.train_loader) if hasattr(self.train_loader,
                                                                        "__len__") else None
        return out

    Trainer.train_epoch = timed("train_epoch_s", Trainer.train_epoch)
    Trainer.validate = timed("validation_epoch_s", Trainer.validate)
    Trainer.train = train_and_record


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def graph_runners(since: int) -> Dict[str, Dict]:
    """Graph keys and pool GiB per runner captured after record ``since``."""
    from light_unet_tpu_torch.utils import graphs

    out: Dict[str, Dict] = {}
    for c in graphs.captures[since:]:
        entry = out.setdefault(f"{c.runner}#{c.serial}", {"keys": 0, "pool_gib": 0.0})
        entry["keys"] += 1
        entry["pool_gib"] = round(entry["pool_gib"] + c.pool_bytes / 2**30, 3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", type=str, required=True)
    ap.add_argument("--cases", type=int, default=123)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--shape", type=str, default="144x144x272",
                    help="in-plane size and base z of every case, DxHxW")
    ap.add_argument("--config", type=str, default=str(REPO / "configs/unet_fl70.yaml"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--out", type=str, default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.lower().split("x"))
    if len(shape) != 3:
        raise SystemExit(f"--shape {args.shape}: expected DxHxW")

    sys.path.insert(0, str(REPO))
    import torch

    from light_unet_tpu_torch import cli
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.utils import graphs

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    raw, processed, splits = work / "data/raw", work / "data/processed", work / "data/splits"
    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to rehearse on the CPU")

    record: Dict = {"cases": args.cases, "epochs": args.epochs, "shape": list(shape),
                    "config": args.config, "device": args.device}
    t0 = time.perf_counter()
    zs = write_cohort(raw, args.cases, shape)
    record["generate_s"] = round(time.perf_counter() - t0, 2)
    record["z_extents"] = {str(z): zs.count(z) for z in sorted(set(zs))}
    print(f"cohort of {args.cases} written in {record['generate_s']} s, z {record['z_extents']}",
          flush=True)

    cfg = Config.load(args.config)
    cfg.training.epochs = args.epochs
    cfg.training.scheduler.T_max = args.epochs
    cfg.training.warmup_epochs = 1
    cfg.output.save_every_n_epochs = 1  # the rotation engages within the capped run
    cfg.output.keep_last_n_checkpoints = 2
    cfg_path = work / "rehearsal_config.yaml"
    cfg.save(cfg_path)
    record["z_bucket"] = cfg.tpu.z_bucket

    instrument_trainer(record)
    argv_common = ["--config", str(cfg_path), "--data_root", str(raw),
                   "--processed_dir", str(processed), "--splits_dir", str(splits),
                   "--workdir", str(work), "--allow_test", "--device", args.device]
    record.update(stage_s={}, stage_rc={}, device_memory={}, graph_runners={})
    for stage in STAGES:
        since = len(graphs.captures)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = cli.run(["--mode", stage, *argv_common])
        if cuda:
            torch.cuda.synchronize()
        record["stage_s"][stage] = round(time.perf_counter() - t0, 2)
        record["stage_rc"][stage] = rc
        if cuda:
            reserved = torch.cuda.memory_reserved()
            gc.collect()
            torch.cuda.empty_cache()
            record["device_memory"][stage] = {
                "peak_allocated_gib": round(torch.cuda.max_memory_allocated() / 2**30, 3),
                "reserved_after_gib": round(reserved / 2**30, 3),
                "reserved_after_release_gib": round(torch.cuda.memory_reserved() / 2**30, 3)}
        record["graph_runners"][stage] = graph_runners(since)
        print(f"== stage {stage}: rc {rc}, {record['stage_s'][stage]} s, peak RSS "
              f"{rss_gib():.2f} GiB ==", flush=True)
        if rc not in (0, None):
            break
    record["peak_rss_gib"] = round(rss_gib(), 3)
    record["checkpoints"] = sorted(p.name for p in (work / "models/checkpoints").glob("*.ckpt"))
    record["best_model"] = (work / "models/best_model.pth").exists()
    boxes = sorted((work / "inference/bboxes").glob("*_bboxes.json"))
    record["inference"] = {
        "split_cases": len((splits / "val_list.txt").read_text().split())
        if (splits / "val_list.txt").exists() else 0,
        "prob_maps": len(list((work / "inference/prob_maps").glob("*_prob.nii.gz"))),
        "bbox_files": len(boxes),
        "candidates": sum(json.loads(p.read_text())["num_candidates"] for p in boxes)}
    detailed = work / "inference/detailed_results.json"
    if detailed.exists():
        per_case = json.loads(detailed.read_text())["per_case"]
        default = str(cfg.validation.default_threshold)
        record["evaluate"] = {"cases": len(per_case), "threshold": cfg.validation.default_threshold,
                              **{k: sum(c[default][k] for c in per_case.values())
                                 for k in ("tp", "fp", "fn")}}
    history = work / "logs/training_history.json"
    if history.exists():
        record["val_recall"] = json.loads(history.read_text()).get("val_recall")
    line = json.dumps(record)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if all(rc in (0, None) for rc in record["stage_rc"].values()) \
        and len(record["stage_rc"]) == len(STAGES) else 1


if __name__ == "__main__":
    sys.exit(main())
