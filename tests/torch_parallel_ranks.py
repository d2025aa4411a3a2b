"""Rank functions of the PyTorch port's multi-rank tests
(``tests/test_torch_parallel*.py``).

Each test spawns N gloo ranks on the CPU (``torch.multiprocessing``, a
``file://`` rendezvous in the test's ``tmp_path``, one torch thread per
rank); every rank runs one job of ``JOBS`` on inputs the test wrote to
``tmp_path`` and saves what it saw to ``{job}_{rank}.npz`` there.  This
module imports torch and the port only, so that the children start fast.
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path

import numpy as np
import torch

from light_unet_tpu_torch.config import Config, TpuConfig
from light_unet_tpu_torch.parallel import distributed

PATCH = (16, 16, 16)
ENC = (4, 8, 16, 32)


def spawn(job: str, n: int, tmp: Path) -> list:
    """Run ``job`` on ``n`` ranks; returns each rank's saved arrays."""
    init = f"file://{tmp / f'rendezvous_{job}_{n}'}"
    torch.multiprocessing.spawn(run, args=(n, init, str(tmp), job), nprocs=n, join=True)
    return [dict(np.load(tmp / f"{job}_{r}.npz")) for r in range(n)]


def dist_fields(n: int, rank: int, init: str) -> dict:
    return dict(distributed=True, coordinator_address=init, num_processes=n, process_id=rank)


def dist_config(n: int, rank: int, init: str) -> TpuConfig:
    return TpuConfig(**dist_fields(n, rank, init))


def run(rank: int, n: int, init: str, tmp: str, job: str) -> None:
    torch.set_num_threads(1)
    out: dict = {}
    try:
        JOBS[job](rank, n, init, Path(tmp), out)
    except SystemExit:
        out["parked"] = np.array(True)  # left out of a mesh: idled until the run ended
        raise
    finally:
        np.savez(Path(tmp) / f"{job}_{rank}.npz", **out)
        distributed.finish()


def _window_model(tmp: Path):
    from light_unet_tpu_torch.models.unet3d import Lightweight3DUNet

    model = Lightweight3DUNet(encoder_channels=ENC, dropout_p=0.0)
    model.load_state_dict(torch.load(tmp / "window_model.pt"), strict=True)
    return model.eval()


def parallel_job(rank: int, n: int, init: str, tmp: Path, out: dict) -> None:
    """The collectives, both sharded windows, the sharded gather, a DP step
    and the mesh rules, on one group."""
    from light_unet_tpu_torch.core.trainer import GuardedAdamW
    from light_unet_tpu_torch.datasets.device_corpus import gather_patches, gather_patches_sharded
    from light_unet_tpu_torch.models.losses import get_loss_function
    from light_unet_tpu_torch.models.unet3d import Lightweight3DUNet
    from light_unet_tpu_torch.ops import sliding_window as sw
    from light_unet_tpu_torch.parallel.collectives import ppermute, psum
    from light_unet_tpu_torch.parallel.mesh import (
        create_mesh,
        effective_batch_size,
        mesh_from_config,
        shard_batch,
    )

    cfg = dist_config(n, rank, init)
    out["init"] = np.array([distributed.maybe_distributed_init(cfg, "cpu"),
                            distributed.is_distributed_initialized(),
                            distributed.maybe_distributed_init(cfg, "cpu")])
    out["world"] = np.array([torch.distributed.get_world_size(), torch.distributed.get_rank()])
    inp = dict(np.load(tmp / "inputs.npz"))
    mesh = create_mesh(device="cpu")
    out["backend"] = np.array(mesh.backend)
    out["ppermute"] = ppermute(torch.full((3,), float(rank)), mesh,
                               [(i, (i - 1) % n) for i in range(n)]).numpy()

    # patch-sharded core, the JAX package's chunk schedule for n ranks
    model = _window_model(tmp)
    imp = torch.from_numpy(inp["imp"])
    with torch.no_grad():
        weights = (torch.arange(len(inp["pos"])) < int(inp["n_real"])).float()
        out["core"] = sw.sliding_window_core_sharded(
            torch.from_numpy(inp["pvol"]), torch.from_numpy(inp["pos"]), weights, imp, model,
            PATCH, int(inp["chunk"]), mesh, int(inp["tail"])).numpy()

    # whole engines: slab-sharded (float32 and uint16 transfer), patch-sharded
    vol, body = inp["vol"], inp["body"]
    for name, kw in (("slab_f32", dict(spatial_shard=True)),
                     ("slab_u16", dict(spatial_shard=True, transfer_dtype="uint16")),
                     ("patch_f32", {})):
        engine = sw.SlidingWindowInferencer(model, PATCH, patch_batch=8, z_bucket=16, mesh=mesh,
                                            device="cpu", **kw)
        prep = engine.prepare(vol, body)
        out[f"{name}_slab"] = np.array(prep["slab"])
        got = engine.fetch(engine.dispatch(prep))
        if got is not None:
            out[name] = got
    with warnings.catch_warnings(record=True) as caught:  # slab < patch: patch-sharded
        warnings.simplefilter("always")
        thin = sw.SlidingWindowInferencer(model, PATCH, patch_batch=8, z_bucket=16, mesh=mesh,
                                          spatial_shard=True, device="cpu")
        out["thin_slab"] = np.array(thin.prepare(vol[:, :, :40])["slab"])
    out["thin_warned"] = np.array(any("falling back" in str(w.message) for w in caught))

    # case-sharded gather: this rank's rows of the stacks, the whole corner batch
    rows = inp["corpus_img"].shape[0] // n
    own = slice(rank * rows, (rank + 1) * rows)
    img = torch.from_numpy(inp["corpus_img"].view(np.int16))
    lbl = torch.from_numpy(inp["corpus_lbl"])
    corners = torch.from_numpy(inp["corners"])
    gi, gl = gather_patches_sharded(img[own], lbl[own], corners, PATCH, mesh)
    ri, rl = gather_patches(img, lbl, torch.from_numpy(shard_batch(inp["corners"], mesh)), PATCH)
    out["gather_img"], out["gather_lbl"] = gi.numpy().view(np.uint16), gl.numpy()
    out["gather_equal"] = np.array(torch.equal(gi, ri) and torch.equal(gl, rl))

    # a data-parallel gradient and guarded AdamW step (focal Tversky, global batch 8)
    dp = Lightweight3DUNet(encoder_channels=ENC, dropout_p=0.0)
    dp.load_state_dict(torch.load(tmp / "dp_model.pt"), strict=True)
    params = list(dp.parameters())
    opt = GuardedAdamW(params, 1e-3, 1e-5, mesh=mesh)
    x, y = shard_batch((inp["dp_x"], inp["dp_y"]), mesh)
    loss_cfg = Config.from_dict({"loss": {"name": "FocalTverskyLoss", "use_combined_loss": False}}).loss
    loss = get_loss_function(loss_cfg, mesh)(
        dp(torch.from_numpy(x)), torch.from_numpy(y))
    grads = torch.autograd.grad(loss, params)
    g = torch.cat([t.reshape(-1) for t in grads])
    psum(g, mesh)
    out["dp_loss"], out["dp_grads"] = loss.detach().numpy(), g.numpy()
    out["dp_ok"] = opt.step(grads, loss.detach()).numpy()
    out["dp_params"] = opt.flat.numpy().copy()

    # the mesh rules on the ranks: batch_per_device keeps all, mesh_shape > world raises
    bpd = TpuConfig(batch_per_device=True)
    m = mesh_from_config(bpd, batch_size=2, device="cpu")
    out["bpd"] = np.array([m.size, effective_batch_size(bpd, 2, m)])
    try:
        create_mesh(mesh_shape=[n + 1], device="cpu")
    except ValueError as e:
        out["too_big"] = np.array(str(e))
    # a global batch that n does not divide: the ranks left out idle until
    # the others finish; the rest go on in a smaller mesh
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        small = mesh_from_config(TpuConfig(), batch_size=3 if n == 2 else 2, device="cpu")
    out["small_warned"] = np.array(any("batch_per_device" in str(w.message) for w in caught))
    out["small_size"] = np.array(1 if small is None else small.size)
    if small is not None:
        out["small_psum"] = psum(torch.ones(2), small).numpy()


def _write_yaml(cfg: dict, path: Path) -> Path:
    Config.from_dict(cfg).save(path)
    return path


def trainer_job(rank: int, n: int, init: str, tmp: Path, out: dict) -> None:
    """The CLI's inference stage on n ranks (it makes and ends the group),
    then slab-sharded serving, data-parallel training, a batch the mesh
    does not divide and resume, on a new group."""
    from light_unet_tpu_torch import cli
    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.core.trainer import Trainer

    base = json.loads((tmp / "config.json").read_text())
    tree = json.loads((tmp / "tree.json").read_text())
    serve_cfg = {**base, "tpu": {**base["tpu"], **dist_fields(n, rank, init + "_cli")}}
    yaml = _write_yaml(serve_cfg, tmp / f"serve_{rank}.yaml")
    out["cli_rc"] = np.array(cli.run([
        "--mode", "inference", "--device", "cpu", "--config", str(yaml),
        "--model_path", tree["model"], "--processed_dir", tree["data"],
        "--split_file", tree["val_split"], "--workdir", str(tmp / f"cli_r{rank}")]))
    out["cli_ended"] = np.array(not distributed.is_distributed_initialized())

    cfg = dist_config(n, rank, init)
    distributed.maybe_distributed_init(cfg, "cpu")
    slab_cfg = Config.from_dict({**base, "tpu": {**base["tpu"], "spatial_shard": True}})
    inf = Inferencer(slab_cfg, tree["model"], workdir=str(tmp / f"slab_r{rank}"), device="cpu")
    out["slab_mode"] = np.array(inf.sw.spatial_shard)
    out["slab_result"] = np.array(inf.infer_split(tree["val_split"], tree["data"])["successful"])

    train_cfg = Config.from_dict(json.loads((tmp / "train.json").read_text()))
    tr = Trainer(train_cfg, workdir=str(tmp / f"dp_r{rank}"), device="cpu")
    losses = []
    flatten = tr._flatten_losses
    tr._flatten_losses = lambda device_losses: _record(flatten, device_losses, losses)
    result = tr.train()
    out["losses"] = np.array(losses)
    out["params"] = tr.opt.flat.numpy().copy()
    out["corpus_rows"] = np.array([tr.corpus.images.shape[0], tr.corpus.sharded])
    out["global_batch"] = np.array([tr.global_batch, tr.mesh.size])
    out["history"] = np.array(json.dumps(result["history"]))

    # batch_per_device with the linear learning-rate rule (a replicated corpus)
    train = json.loads((tmp / "train.json").read_text())
    train["tpu"].update(batch_per_device=True, scale_lr_with_devices=True, shard_corpus=False)
    scaled = Trainer(Config.from_dict(train), workdir=str(tmp / f"lr_r{rank}"), device="cpu")
    out["scaled_lr"] = np.array([scaled.global_batch, scaled.base_lr, scaled.scheduler.base_lr,
                                 float(scaled.opt.lr)])
    out["scaled_corpus"] = np.array([scaled.corpus.images.shape[0], scaled.corpus.sharded])

    # a global batch the mesh does not divide: every rank raises
    odd = json.loads((tmp / "train.json").read_text())
    odd["training"]["batch_size"] = 3
    odd["tpu"]["mesh_shape"] = [n]
    try:
        Trainer(Config.from_dict(odd), workdir=str(tmp / f"odd_r{rank}"), device="cpu")
    except ValueError as e:
        out["odd_batch"] = np.array(str(e))

    # resume: only rank 0 wrote checkpoints into its own workdir, so the
    # ranks find different files and all of them raise ...
    try:
        Trainer(train_cfg, workdir=str(tmp / f"dp_r{rank}"), device="cpu").resume()
    except RuntimeError as e:
        out["resume_apart"] = np.array(str(e))
    # ... and from one file all of them read, the last epoch again
    again = Trainer(train_cfg, workdir=str(tmp / f"resume_r{rank}"), device="cpu")
    out["resumed"] = np.array(again.resume(tmp / "dp_r0/models/checkpoints/checkpoint_epoch_001.ckpt"))
    resumed_losses = []
    flatten = again._flatten_losses
    again._flatten_losses = lambda device_losses: _record(flatten, device_losses, resumed_losses)
    again.train()
    out["resume_losses"] = np.array(resumed_losses)
    out["resume_params"] = again.opt.flat.numpy().copy()


def _record(flatten, device_losses, losses):
    vals = flatten(device_losses)
    losses.extend(vals)
    return vals


JOBS = {"parallel": parallel_job, "trainer": trainer_job}
