#!/usr/bin/env python3
"""Graphed data-parallel training of the PyTorch port over NCCL, one rank a
card, on every card of the machine (two or more):

    python3 scripts/check_torch_nccl_graphs.py

Each rank trains a full-width bf16 ``Trainer`` (16^3 patches, batch 2 a
rank, case-sharded corpus) for 5 chains of 4 steps, one capture and 4
replays, with the gradient all-reduce, the loss's
global sums and the corpus reduce-scatter captured; validates; drops it;
then trains a float32 trainer for a captured unit and a replay, and calls
``parallel/distributed.py:finish`` while that trainer and its graphs are
still alive (the process group must go after the graphs).  A rank that has
not finished after 90 s prints its stacks and exits.  Passes when every
rank ends and all ranks saw the same losses.
"""

import json
import socket
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def write_tree(tmp: Path) -> None:
    """Three seeded 20x24x28 phantoms: 0001-0002 train, 0003 validates."""
    from light_unet_tpu_torch.utils import nifti

    rng = np.random.default_rng(5)
    data = tmp / "proc"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in ("0001", "0002", "0003"):
        img = (0.2 * rng.random((20, 24, 28))).astype(np.float32)
        img[3:17, 4:20, 4:24] += 0.3
        lab = np.zeros(img.shape, np.uint8)
        lab[6:10, 8:12, 8:12] = 1
        img[lab > 0] = 0.9
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab, aff), data / f"labels/{cid}.nii.gz")
    splits = tmp / "splits"
    splits.mkdir()
    for name, ids in (("train", ["0001", "0002"]), ("val", ["0003"]), ("test", [])):
        (splits / f"{name}_list.txt").write_text("".join(f"{i}\n" for i in ids))


def rank_main(rank: int, n: int, init: str, work: str) -> None:
    import faulthandler

    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import Trainer
    from light_unet_tpu_torch.parallel import distributed

    faulthandler.dump_traceback_later(90, exit=True)
    work = Path(work)
    fields = dict(distributed=True, coordinator_address=init, num_processes=n, process_id=rank)
    device = f"cuda:{rank}"
    distributed.maybe_distributed_init(Config.from_dict({"tpu": fields}).tpu, device,
                                       backend="nccl")

    def trainer(dtype: str, name: str):
        cfg = {"data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
               "tpu": {"compute_dtype": dtype, "patch_batch": 8, "z_bucket": 16,
                       "steps_per_dispatch": 4, "separable_augment": True,
                       "batch_per_device": True, "shard_corpus": True,
                       **fields},
               "training": {"batch_size": 2, "learning_rate": 1e-3, "use_warmup": False},
               "data_dir": str(work / "proc"), "splits_dir": str(work / "splits")}
        tr = Trainer(Config.from_dict(cfg), workdir=str(work / f"{name}{rank}"), device=device)
        tr.model.train()
        tr._set_lr(1e-3)
        return tr

    t0 = time.perf_counter()
    try:
        tr = trainer("bfloat16", "bf16_")
        draw = tr.train_loader.sample_corners
        units = [np.stack([draw() for _ in range(4)]) for _ in range(5)]
        bf16 = tr._flatten_losses([tr._step_on_batch(u) for u in units])
        replays = tr.graphs.replays
        tr.validate(0)
        del tr
        tr32 = trainer("float32", "f32_")
        unit = next(iter(tr32._dispatch_units(tr32.train_loader)))
        f32 = tr32._flatten_losses([tr32._step_on_batch(unit), tr32._step_on_batch(unit)])
        seconds = time.perf_counter() - t0
    finally:
        t1 = time.perf_counter()
        distributed.finish()
        faulthandler.cancel_dump_traceback_later()
    (work / f"rank{rank}.json").write_text(json.dumps(dict(
        bf16=bf16, f32=f32, replays=replays, f32_replays=tr32.graphs.replays,
        seconds=seconds, finish_s=time.perf_counter() - t1)))


def main() -> int:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print("check_torch_nccl_graphs: needs two or more NVIDIA GPUs", file=sys.stderr)
        return 2
    print(f"{n} x {torch.cuda.get_device_name(0)}, torch {torch.__version__}, NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}", flush=True)
    with tempfile.TemporaryDirectory(prefix="nccl_graphs_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        write_tree(tmp)
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(rank_main, nprocs=n, join=True,
                                    args=(n, f"tcp://localhost:{free_port()}", str(tmp)))
        ranks = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(n)]
    for r, got in enumerate(ranks):
        print(f"rank {r}: bf16 losses {[round(x, 6) for x in got['bf16'][:4]]}..., "
              f"{got['replays']} replays; float32 {[round(x, 6) for x in got['f32'][:2]]}..., "
              f"{got['f32_replays']} replay; {got['seconds']:.1f} s; finish() "
              f"{got['finish_s']:.2f} s", flush=True)
    same = all(g["bf16"] == ranks[0]["bf16"] and g["f32"] == ranks[0]["f32"] for g in ranks)
    ok = same and all(g["replays"] == 4 and g["f32_replays"] == 1 for g in ranks)
    print(f"{'PASSED' if ok else 'FAILED'}: {n} NCCL ranks graphed, losses equal across ranks "
          f"{same}, {time.perf_counter() - t0:.1f} s", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
