#!/usr/bin/env python3
"""Where the time of bf16 serving goes on N ranks of the PyTorch port, one
rank a card over NCCL, patch- and slab-sharded, graphed and eager:

    python3 scripts/profile_torch_multirank_serving.py [--cases 3]

The serving configuration of ``chip_smoke.py`` (full width, bf16,
``fused_block``, uint16 in and out, sparse fetch, 144x144x272 phantoms
preprocessed on cuda:0 first).  Every rank serves each case patch-sharded
through ``Inferencer``'s own steps, each synchronized and timed on the host
clock: load (decode + prepare + upload), dispatch (enqueue), device (the
rank's window share and the psum of prob and count, to the end of the
device work), finalize (the first rank: candidate table, fetch, NIfTI and
JSON writes; the others only join).  Besides, with CUDA events: the rank's
share of the window forward alone (eager, no collective) and one psum of
the two float32 accumulators alone (patch mode).  The first case of each
path pays its captures and is reported apart.  One JSON line per (rank,
mode, path); the first rank's maps compared (graphed and eager bit for
bit, slab within 5e-2 of patch); then the card's name and power limit.
Exits non-zero when a comparison fails.
"""

import argparse
import json
import socket
import subprocess
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


def events_ms(fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# (window mode, graphs): patch-sharded and slab-sharded, each graphed and eager
MODES = [("patch", True), ("patch", False), ("slab", True), ("slab", False)]


def rank_main(rank: int, n: int, init: str, work: str, case_ids: list) -> None:
    import chip_smoke
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.ops.sliding_window import sliding_window_core_parts
    from light_unet_tpu_torch.parallel import distributed
    from light_unet_tpu_torch.parallel.collectives import psum

    work = Path(work)
    fields = dict(distributed=True, coordinator_address=init, num_processes=n, process_id=rank)
    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
    cfg = json.loads(json.dumps(chip_smoke.SERVING))
    cfg["tpu"].update(fields)
    distributed.maybe_distributed_init(Config.from_dict(cfg).tpu, device, backend="nccl")
    out = []
    try:
        for mode, graphs in MODES:
            mcfg = json.loads(json.dumps(cfg))
            mcfg["tpu"]["spatial_shard"] = mode == "slab"
            inf = Inferencer(mcfg, work / "best_model.pth",
                             workdir=str(work / f"{mode}_{graphs}_{rank}"), device=device,
                             graphs=graphs)
            sw = inf.sw
            if sw.spatial_shard != (mode == "slab"):
                raise AssertionError(f"{mode}: spatial_shard {sw.spatial_shard}")
            rows = []
            for cid in case_ids:
                t = {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                inputs = inf._load_case_inputs(cid, work / "processed")
                torch.cuda.synchronize()
                t["load"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                dispatched = inf._dispatch(inputs["prepared"])
                t["dispatch"] = time.perf_counter() - t0
                torch.cuda.synchronize()
                t["device"] = time.perf_counter() - t0 - t["dispatch"]
                t0 = time.perf_counter()
                inf._finalize_case(cid, inputs, dispatched, 0.3)
                torch.cuda.synchronize()
                t["finalize"] = time.perf_counter() - t0
                rows.append(t)
            steady = {k: float(np.mean([r[k] for r in rows[1:]])) for k in rows[0]}
            row = dict(rank=rank, ranks=n, mode=mode, graphs=graphs, first_case=rows[0],
                       steady_mean_s=steady, graph_keys=len(sw.graphs.graphs) if sw.graphs else 0,
                       replays=sw.graphs.replays if sw.graphs else 0)
            if mode == "patch":
                # the rank's window share alone (eager, no collective), the psum alone
                prep = inputs["prepared"]
                per = prep["positions"].shape[0] // sw.mesh.size
                mine = slice(sw.mesh.rank * per, (sw.mesh.rank + 1) * per)
                chunk, tail = prep["chunks"]
                vol = torch.zeros(prep["volume"].shape, dtype=torch.float32, device=device)
                with torch.no_grad():
                    row["share_forward_ms"] = events_ms(lambda: sliding_window_core_parts(
                        vol, prep["positions"][mine], prep["weights"][mine], sw.imp_map,
                        sw.apply_fn, sw.patch_size, chunk, tail))
                acc = [torch.zeros(prep["volume"].shape, dtype=torch.float32, device=device)
                       for _ in range(2)]
                row["psum_prob_count_ms"] = events_ms(lambda: [psum(a, sw.mesh) for a in acc])
                row["windows_a_rank"] = per
            out.append(row)
            del inf, sw
            torch.cuda.empty_cache()
    finally:
        distributed.finish()
    (work / f"rank{rank}.json").write_text(json.dumps(out))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cases", type=int, default=3)
    args = parser.parse_args()
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print("profile_torch_multirank_serving: needs two or more NVIDIA GPUs", file=sys.stderr)
        return 2
    import chip_smoke
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.models.unet3d import build_model, init_weights
    from light_unet_tpu_torch.pipeline.preprocess import run_preprocess
    from light_unet_tpu_torch.pipeline.split import split_dataset

    with tempfile.TemporaryDirectory(prefix="multirank_serving_", dir=ROOT) as tmp:
        tmp = Path(tmp)
        ids = [f"{i + 1:04d}" for i in range(args.cases)]
        chip_smoke.write_raw_cases(tmp / "raw", seed=0, ids=ids)
        split_dataset(tmp / "raw", tmp / "splits", 0.0, 1.0, 0.0, seed=42)
        cfg = Config.from_dict(chip_smoke.SERVING)
        run_preprocess(cfg, tmp / "raw", tmp / "processed", tmp / "splits", split="val",
                       device="cuda:0")
        model = init_weights(build_model(cfg.model, torch.bfloat16, inference=True),
                             torch.Generator().manual_seed(1))
        torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, tmp / "best_model.pth")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.multiprocessing.spawn(rank_main, nprocs=n, join=True,
                                    args=(n, f"tcp://localhost:{free_port()}", str(tmp), ids))
        for r in range(n):
            for row in json.loads((tmp / f"rank{r}.json").read_text()):
                print(json.dumps(row), flush=True)
        # the first rank's maps: graphed equal to eager per mode, slab near patch
        from light_unet_tpu_torch.utils import nifti

        maps = {(m, g): [nifti.load(tmp / f"{m}_{g}_0/inference/prob_maps/{c}_prob.nii.gz")
                         .get_fdata(np.float32) for c in ids] for m, g in MODES}
        same = {m: all(np.array_equal(a, b) for a, b in zip(maps[m, True], maps[m, False]))
                for m in ("patch", "slab")}
        err = max(float(np.abs(a - b).max()) for a, b in zip(maps["patch", True],
                                                             maps["slab", True]))
        print(f"maps: graphed == eager bit for bit: {same}; slab vs patch max abs diff "
              f"{err:.3e} (bar 5e-2)", flush=True)
        ok = all(same.values()) and err <= 5e-2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    print(f"{n} ranks, {time.perf_counter() - t0:.1f} s of spawned serving", flush=True)
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
