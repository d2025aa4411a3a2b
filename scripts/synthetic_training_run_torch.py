#!/usr/bin/env python3
"""Longer synthetic training run of the PyTorch port: does the trainer learn?

The counterpart of ``scripts/synthetic_training_run.py``, with the same
flags, the same phantoms (``light_unet_tpu_torch/tools/synthetic.py``, the
JAX tests' draws from seed 42), the same config overrides and the same JSON
line: train loss, validation recall, DSC and best threshold per validation,
learning rate, model-selection events, early stop, and the device or host
route of every validation.  It trains the port's ``Trainer`` on the card
(``--device``, default ``cuda``; ``--cpu`` is ``--device cpu``).

    python3 scripts/synthetic_training_run_torch.py --epochs 12 --n-train 8 --n-val 3 \\
        --shape 80 80 96
    python3 scripts/synthetic_training_run_torch.py --hard --epochs 40 --n-train 12 --n-val 5 \\
        --shape 96 96 120 --batch 8 --validate-every 1 --scheduler plateau \\
        --plateau-patience 4 --early-patience 10 --lr 1e-3
    python3 scripts/synthetic_training_run_torch.py --mixed-mode probabilistic --epochs 6 --n-train 6

It imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--n-train", type=int, default=10)
    ap.add_argument("--n-val", type=int, default=3)
    ap.add_argument("--shape", type=int, nargs=3, default=[96, 96, 120])
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--workdir", type=str, default=None)
    ap.add_argument("--mixed-mode", choices=["fl_epoch_plus_dlbcl", "probabilistic"], default=None,
                    help="a mixed FL+DLBCL training mode: --n-train FL cases plus as many "
                    "DLBCL-id cases (1000+); validation stays FL-only")
    ap.add_argument("--hard", action="store_true",
                    help="low-contrast sub-cc lesions in heavy texture noise: recall starts well "
                    "below 1.0 and must be learned")
    ap.add_argument("--scheduler", choices=["cosine", "plateau"], default=None,
                    help="override the LR scheduler (plateau = ReduceLROnPlateau on recall)")
    ap.add_argument("--early-patience", type=int, default=None,
                    help="override early-stopping patience (epochs)")
    ap.add_argument("--plateau-patience", type=int, default=None,
                    help="override the ReduceLROnPlateau patience; set it below "
                    "--early-patience so the LR reduction fires before early stopping")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--validate-every", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--patch", type=int, default=None, help="cubic patch size override")
    ap.add_argument("--reuse-data", action="store_true",
                    help="skip phantom generation for cases already present in <workdir>/proc")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    args = ap.parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    return args


def write_phantoms(args, workdir: Path) -> list:
    """Normalized phantoms and labels under ``workdir/proc``, split files
    under ``workdir/splits``; returns the case ids."""
    from light_unet_tpu_torch.ops.intensity import clip_and_normalize
    from light_unet_tpu_torch.tools.synthetic import (
        make_phantom,
        make_phantom_hard,
        write_case,
        write_split_files,
    )

    rng = np.random.default_rng(42)
    ids = [f"{i:04d}" for i in range(1, args.n_train + args.n_val + 1)]
    if args.mixed_mode:  # the DLBCL domain: ids 1000-1422
        ids += [f"{1000 + i:04d}" for i in range(args.n_train)]
    for cid in ids:
        if args.reuse_data and (workdir / f"proc/labels/{cid}.nii.gz").exists():
            continue
        if args.hard:
            img, lab = make_phantom_hard(rng, shape=tuple(args.shape))
        else:
            img, lab = make_phantom(rng, shape=tuple(args.shape), n_lesions=4, lesion_radius=(2, 4))
        img = np.asarray(clip_and_normalize(img, device=args.device)[0], np.float32)
        write_case(workdir / "proc", cid, img, lab)
    train_ids = ids[: args.n_train] + ids[args.n_train + args.n_val:]
    write_split_files(workdir / "splits", train_ids, ids[args.n_train: args.n_train + args.n_val])
    return ids


def build_config(args, workdir: Path):
    """The JAX script's overrides of the default config."""
    from light_unet_tpu_torch.config import Config

    cfg = Config()
    if args.patch:
        cfg.data.patch_size = [args.patch] * 3
        cfg.tpu.z_bucket = min(48, args.patch)
    cfg.training.batch_size = args.batch or 8
    cfg.training.epochs = args.epochs
    cfg.training.learning_rate = args.lr if args.lr is not None else 1e-3
    cfg.training.use_warmup = True
    cfg.training.warmup_epochs = 2
    cfg.training.scheduler.T_max = args.epochs
    cfg.validation.validate_every_n_epochs = (args.validate_every if args.validate_every
                                              is not None else 2)
    cfg.data.body_mask.enabled = False
    cfg.output.save_every_n_epochs = 10
    cfg.data_dir = str(workdir / "proc")
    cfg.splits_dir = str(workdir / "splits")
    if args.scheduler == "plateau":
        cfg.training.scheduler.name = "ReduceLROnPlateau"
    elif args.scheduler == "cosine":
        cfg.training.scheduler.name = "CosineAnnealingLR"
    if args.plateau_patience is not None:
        cfg.training.scheduler.patience = args.plateau_patience
    if args.early_patience is not None:
        cfg.training.early_stopping.enabled = True
        cfg.training.early_stopping.patience = args.early_patience
    if args.mixed_mode:
        cfg.training.mixed_domains.enabled = True
        cfg.training.mixed_domains.mode = args.mixed_mode
    return cfg


def main(argv=None) -> int:
    args = parse_args(argv)
    import tempfile

    import torch

    from light_unet_tpu_torch.core.trainer import Trainer

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the CPU")
    workdir = Path(args.workdir or tempfile.mkdtemp(prefix="synth_run_")).resolve()
    write_phantoms(args, workdir)
    cfg = build_config(args, workdir)

    t0 = time.time()
    trainer = Trainer(cfg, workdir=str(workdir), device=args.device)
    result = trainer.train()
    wall = time.time() - t0

    hist = result["history"]
    out = {
        "epochs": args.epochs,
        "mode": args.mixed_mode or "standard",
        "hard": bool(args.hard),
        "scheduler": cfg.training.scheduler.name,
        "wall_seconds": round(wall, 1),
        "best_recall": result["best_recall"],
        "best_dsc": result["best_dsc"],
        "best_epoch": result["best_epoch"],
        "early_stopped": result["early_stopped"],
        "selection_events": result["selection_events"],
        "train_loss": [round(x, 4) for x in hist["train_loss"]],
        "val_recall": [round(x, 4) for x in hist["val_recall"]],
        "val_dsc": [round(x, 4) for x in hist["val_dsc"]],
        "val_best_threshold": [round(x, 2) for x in hist["val_best_threshold"]],
        "learning_rate": [round(x, 6) for x in hist["learning_rate"]],
        "val_fallback_history": result["val_fallback_history"],
        "workdir": str(workdir),
    }
    if args.mixed_mode == "probabilistic" and trainer.train_dataset is not None:
        # the sampler's draws in the last epoch: near training.mixed_domains.fl_ratio
        out["domain_sample_counts"] = trainer.train_dataset.get_sample_counts()
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
