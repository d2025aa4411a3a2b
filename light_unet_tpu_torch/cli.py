"""Pipeline CLI of the PyTorch port (port of ``light_unet_tpu/cli.py:94-200``).

Same flags as the JAX package's CLI, and the same directory tree.  Stages:
``split``, ``preprocess``, ``train`` (``--resume`` continues from the latest
checkpoint), ``inference``, ``evaluate``, and ``all`` for the five in that
order; ``bench`` raises ``NotImplementedError`` naming its ROADMAP item.
``--device`` (default ``cuda``) is where every stage runs.

A multi-process run (``tpu.distributed: true``, ``tpu.num_processes`` > 1,
or a process that ``torchrun`` started as one of several) makes its
process group before the first stage
(``parallel/distributed.py:maybe_distributed_init``); each rank takes
``cuda:LOCAL_RANK`` unless ``--device`` names a device index or the CPU.
The host stages (split, preprocess, evaluate) run on rank 0, train and
inference on every rank, and the ranks meet after each stage at a barrier
with no deadline (rank 0's preprocess of a large cohort takes longer than
NCCL's default timeout).  ``run`` ends the group only if it made it, so a
caller that made the group can run several stages in one group.  Under
torchrun the config needs no further key; ``configs/unet_fl70_pod.yaml``
makes the global batch 2 x N and scales the learning rate by N:

    torchrun --nproc_per_node 4 -m light_unet_tpu_torch.cli --mode all \\
        --config configs/unet_fl70_pod.yaml --data_root data/raw

    python -m light_unet_tpu_torch.cli --mode split --data_root data/raw --splits_dir data/splits
    python -m light_unet_tpu_torch.cli --mode preprocess --split val --data_root data/raw \\
        --processed_dir data/processed --splits_dir data/splits
    python -m light_unet_tpu_torch.cli --mode train --config configs/unet_fl70.yaml \\
        --processed_dir data/processed --splits_dir data/splits
    python -m light_unet_tpu_torch.cli --mode inference --config configs/unet_fl70.yaml \\
        --model_path models/best_model.pth --processed_dir data/processed
    python -m light_unet_tpu_torch.cli --mode evaluate --processed_dir data/processed
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from light_unet_tpu_torch.config import Config

_NOT_PORTED = {
    "bench": "ROADMAP queue 1, item 16 (a benchmark of the port is later work)",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Lightweight 3D U-Net pipeline (PyTorch + CUDA)")
    parser.add_argument("--mode", type=str, required=True,
                        choices=["all", "split", "preprocess", "train", "inference", "evaluate",
                                 "bench"])
    parser.add_argument("--config", type=str, default="configs/unet_fl70.yaml")
    parser.add_argument("--data_root", "--raw_dir", type=str, default="data/raw")
    parser.add_argument("--processed_dir", "--data_dir", type=str, default="data/processed")
    parser.add_argument("--splits_dir", type=str, default="data/splits")
    parser.add_argument("--model_path", "--model", type=str, default="models/best_model.pth")
    parser.add_argument("--split_file", type=str, default=None,
                        help="Split list for inference/evaluate (default: val)")
    parser.add_argument("--case_id", type=str, default=None, help="Single case for inference")
    parser.add_argument("--threshold", type=float, default=None, help="Probability threshold override")
    parser.add_argument("--split", type=str, default="all", choices=["train", "val", "test", "all"])
    parser.add_argument("--prob_maps_dir", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--train_ratio", type=float, default=None)
    parser.add_argument("--val_ratio", type=float, default=None)
    parser.add_argument("--test_ratio", type=float, default=None)
    parser.add_argument("--no_prob_maps", action="store_true",
                        help="Skip saving probability maps (bboxes only)")
    parser.add_argument("--allow_test", action="store_true")
    parser.add_argument("--skip_split", action="store_true")
    parser.add_argument("--skip_preprocess", action="store_true")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--workdir", type=str, default=".",
                        help="Root for relative output paths (never mutates the config file)")
    parser.add_argument("--seed", type=int, default=None, help="Seed override")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Torch device (default cuda; cpu only when asked for)")
    return parser


def _load_config(args) -> Config:
    cfg_path = Path(args.config)
    config = Config.load(cfg_path) if cfg_path.exists() else Config()
    if not cfg_path.exists():
        print(f"Config {cfg_path} not found; using built-in defaults")
    config.data_dir = args.processed_dir
    config.splits_dir = args.splits_dir
    if args.seed is not None:
        config.experiment.seed = args.seed
    if args.threshold is not None:
        config.validation.default_threshold = args.threshold
    return config


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode in _NOT_PORTED:
        raise NotImplementedError(
            f"--mode {args.mode} is not ported to PyTorch yet: {_NOT_PORTED[args.mode]}")
    config = _load_config(args)
    from light_unet_tpu_torch.parallel import distributed

    args.device = distributed.rank_device(config.tpu, args.device)
    owns_group = not distributed.is_distributed_initialized()
    distributed.maybe_distributed_init(config.tpu, args.device)
    workdir = Path(args.workdir)
    # the standard directory tree (main.py:71-77 of the reference)
    for d in (args.data_root, args.processed_dir, args.splits_dir, workdir / "models/checkpoints",
              workdir / "logs", workdir / "inference/prob_maps", workdir / "inference/bboxes"):
        Path(d).mkdir(parents=True, exist_ok=True)

    stages = (["split", "preprocess", "train", "inference", "evaluate"] if args.mode == "all"
              else [args.mode])
    split_file = args.split_file or str(Path(args.splits_dir) / "val_list.txt")
    rc = 0
    for stage in stages:
        if stage in ("split", "preprocess", "evaluate") and distributed.world_rank() != 0:
            print(f"rank {distributed.world_rank()}: stage {stage} runs on rank 0")
        else:
            rc = max(rc, _run_stage(stage, args, config, workdir, split_file))
        distributed.barrier()
    if owns_group:
        distributed.finish()
    return rc


def _run_stage(stage: str, args, config: Config, workdir: Path, split_file: str) -> int:
    if stage == "split":
        if args.skip_split:
            print("Skipping data splitting")
            return 0
        from light_unet_tpu_torch.pipeline.split import split_dataset

        sr = config.data.split_ratio
        split_dataset(
            args.data_root,
            args.output_dir or args.splits_dir,
            train_ratio=args.train_ratio if args.train_ratio is not None else sr.train,
            val_ratio=args.val_ratio if args.val_ratio is not None else sr.val,
            test_ratio=args.test_ratio if args.test_ratio is not None else sr.test,
            seed=config.experiment.seed,
        )
        return 0
    if stage == "preprocess":
        if args.skip_preprocess:
            print("Skipping preprocessing")
            return 0
        from light_unet_tpu_torch.pipeline.preprocess import run_preprocess

        run_preprocess(config, args.data_root, args.processed_dir, args.splits_dir,
                       split=args.split, allow_test=args.allow_test, device=args.device)
        return 0
    if stage == "train":
        from light_unet_tpu_torch.core.trainer import Trainer

        trainer = Trainer(config, workdir=args.workdir, device=args.device)
        if args.resume:
            trainer.resume()
        trainer.train()
        return 0
    if stage == "evaluate":
        from light_unet_tpu_torch.pipeline.evaluate import run_evaluate

        run_evaluate(config, split_file, args.prob_maps_dir or workdir / "inference/prob_maps",
                     args.processed_dir, args.output_dir or workdir / "inference",
                     device=args.device)
        return 0

    from light_unet_tpu_torch.core.inferencer import Inferencer

    model_path = Path(args.model_path)
    if not model_path.is_absolute():
        model_path = workdir / model_path
    inferencer = Inferencer(config, model_path, workdir=args.workdir,
                            save_prob_maps=not args.no_prob_maps, device=args.device)
    if args.case_id:
        ok = inferencer.infer_case(args.case_id, args.processed_dir,
                                   threshold=config.validation.default_threshold)
        return 0 if ok else 1
    result = inferencer.infer_split(split_file, args.processed_dir)
    return 0 if not result["failed"] else 1

if __name__ == "__main__":
    sys.exit(run())
