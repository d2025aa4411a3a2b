"""Entry points: the flagship model for a compile check, and a multi-rank dry
run (counterparts of ``__graft_entry__.py:11-296``).

    python -m light_unet_tpu_torch.entry 4    # dryrun_multichip(4)

``entry`` returns the full-width bf16 inference model and a zero
``[8, 48, 48, 48, 1]`` batch.  ``dryrun_multichip(n)`` spawns ``n`` ranks
(NCCL, one card each, when ``n`` cards exist; else gloo, all ranks on the
first card when there is one, on the CPU when there is none) and runs,
with ``__graft_entry__.py``'s asserts: the ``batch_per_device`` mesh, one
guarded data-parallel step, a step from a replicated corpus, a K = 2
chain, the case-sharded gather equal to the replicated one with 1/n of the
rows per rank, and both sharded sliding windows, whose maps are exactly 0
outside the mask.  The rank function lives here so that spawned children
import it.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from light_unet_tpu_torch.utils.device import resolve_device

PATCH = (16, 16, 16)  # tiny shapes for the dry run


def entry(device="cuda"):
    """(model, example_args): the full-width bf16 inference model with seeded
    weights, and a zero [8, 48, 48, 48, 1] float32 batch, on ``device``."""
    from light_unet_tpu_torch.config import ModelConfig
    from light_unet_tpu_torch.models.unet3d import build_model, init_weights

    dev = resolve_device(device)
    model = init_weights(build_model(ModelConfig(), torch.bfloat16, inference=True),
                         torch.Generator().manual_seed(0))
    return model.to(dev).eval(), (torch.zeros((8, 48, 48, 48, 1), device=dev),)


def dryrun_multichip(n_devices: int) -> None:
    """Spawn ``n_devices`` ranks and run the data-parallel and sharded paths
    once each at tiny shapes (raises if a rank fails)."""
    import torch.multiprocessing as mp

    n = int(n_devices)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    # NCCL refuses two ranks on one card: fewer cards than ranks share cuda:0 over gloo
    backend = "nccl" if cards >= n else "gloo"
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        mp.spawn(dryrun_rank, args=(n, init, backend, cards > 0), nprocs=n, join=True)


def _corners(rng, batch: int, n_cases: int) -> np.ndarray:
    return np.stack([rng.integers(0, n_cases, batch), rng.integers(0, 9, batch),
                     rng.integers(0, 9, batch), rng.integers(0, 9, batch)], axis=1).astype(np.int32)


def dryrun_rank(rank: int, n: int, init_method: str, backend: str, on_card: bool) -> None:
    """One rank of ``dryrun_multichip``."""
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.core.trainer import GuardedAdamW
    from light_unet_tpu_torch.datasets.device_corpus import gather_patches, gather_patches_sharded
    from light_unet_tpu_torch.models.losses import get_loss_function
    from light_unet_tpu_torch.models.unet3d import build_model, init_weights, set_dropout_generator
    from light_unet_tpu_torch.ops.augment import make_augment_fn
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer
    from light_unet_tpu_torch.ops.val_metrics import dequantize_prob
    from light_unet_tpu_torch.parallel.distributed import finish, maybe_distributed_init
    from light_unet_tpu_torch.parallel.mesh import (
        batch_rows,
        effective_batch_size,
        mesh_from_config,
        replicate,
        shard_batch,
        shard_chain,
    )

    if not on_card:
        device = torch.device("cpu")
        torch.set_num_threads(1)  # n ranks share the host's cores
    else:
        device = torch.device(f"cuda:{rank}" if backend == "nccl" else "cuda:0")
    cfg = Config()
    cfg.tpu.distributed = True
    cfg.tpu.coordinator_address = init_method
    cfg.tpu.num_processes = n
    cfg.tpu.process_id = rank
    maybe_distributed_init(cfg.tpu, device, backend=backend)
    try:
        # reference settings: batch_size 2.  With batch_per_device the mesh
        # keeps every rank and the global batch is 2 x n
        cfg.tpu.batch_per_device = True
        mesh = mesh_from_config(cfg.tpu, batch_size=2, device=device)
        n_mesh = 1 if mesh is None else mesh.size
        assert n_mesh == n, f"batch_per_device mesh kept {n_mesh}/{n} devices"
        batch = effective_batch_size(cfg.tpu, 2, mesh)
        assert batch == 2 * n, f"global batch {batch} != 2 x {n}"
        rows = batch_rows(mesh, batch)
        rows = (rows.start, rows.stop, batch)

        dtype = torch.bfloat16 if on_card else torch.float32  # bf16 convs crawl on a CPU
        model = init_weights(build_model(cfg.model, dtype), torch.Generator().manual_seed(0))
        model = model.to(device).train()
        loss_fn = get_loss_function(cfg.loss, mesh)
        augment = make_augment_fn(cfg.augmentation, PATCH)
        params = list(model.parameters())
        opt = GuardedAdamW(params, cfg.training.learning_rate, cfg.training.weight_decay,
                           mesh=mesh)
        replicate(opt.flat, mesh)
        gen = torch.Generator(device=device).manual_seed(1)
        set_dropout_generator(model, gen, rows)

        def step(images, labels):
            """The trainer's guarded step on this rank's rows of a global batch."""
            if images.dtype == torch.int16:
                images = dequantize_prob(images)
            with torch.no_grad():
                images, labels = augment(gen, images.float(), labels.float(), rows)
            loss = loss_fn(model(images), labels)
            grads = torch.autograd.grad(loss, params)
            loss = loss.detach()
            ok = opt.step(grads, loss)
            loss = float(loss)
            assert np.isfinite(loss) and float(ok) == 1.0, f"step: loss {loss}, finite flag {ok}"
            return loss

        rng = np.random.default_rng(0)
        images = rng.random((batch, *PATCH, 1), dtype=np.float32)
        labels = (rng.random((batch, *PATCH, 1)) > 0.8).astype(np.float32)
        x, y = shard_batch((images, labels), mesh)
        # every rank must hold a non-empty batch shard (2 samples each)
        assert x.shape[0] == batch // n, x.shape
        loss = step(torch.from_numpy(x).to(device), torch.from_numpy(y).to(device))

        # device-corpus path: the stacks replicated, this rank's corner rows
        corpus_img = torch.from_numpy(
            (rng.random((3, 24, 24, 24)) * 65535).astype(np.uint16).view(np.int16)).to(device)
        corpus_lbl = torch.from_numpy((rng.random((3, 24, 24, 24)) > 0.8).astype(np.uint8)).to(device)
        replicate([corpus_img, corpus_lbl], mesh)
        corners = _corners(rng, batch, 3)
        mine = torch.from_numpy(shard_batch(corners, mesh)).to(device)
        assert mine.shape[0] == batch // n, "corner shards missing devices"
        gi, gl = gather_patches(corpus_img, corpus_lbl, mine, PATCH)
        assert gi.shape[0] == batch // n, "gathered patches missing devices"
        step(gi, gl)

        # K-step chain: the [K, B, 4] chain split on its batch axis
        corners_k = np.stack([_corners(rng, batch, 3) for _ in range(2)])
        chain = torch.from_numpy(np.ascontiguousarray(shard_chain(corners_k, mesh))).to(device)
        chain_losses = [step(*gather_patches(corpus_img, corpus_lbl, chain[k], PATCH))
                        for k in range(chain.shape[0])]
        assert len(chain_losses) == 2 and np.isfinite(chain_losses).all()

        # case-sharded corpus: 3 real cases padded to a multiple of n rows,
        # each rank holding 1/n of them; bit-identical to the replicated gather
        n_rows = -(-3 // n) * n
        host_img = np.zeros((n_rows, 24, 24, 24), np.uint16)
        host_lbl = np.zeros((n_rows, 24, 24, 24), np.uint8)
        host_img[:3] = (rng.random((3, 24, 24, 24)) * 65535).astype(np.uint16)
        host_lbl[:3] = (rng.random((3, 24, 24, 24)) > 0.8).astype(np.uint8)
        per = n_rows // n
        own = slice(mesh.rank * per, (mesh.rank + 1) * per)
        cs_img = torch.from_numpy(host_img[own].view(np.int16)).to(device)
        cs_lbl = torch.from_numpy(host_lbl[own]).to(device)
        assert cs_img.shape[0] == n_rows // n
        corners = _corners(rng, batch, 3)
        gi_s, gl_s = gather_patches_sharded(cs_img, cs_lbl, torch.from_numpy(corners).to(device),
                                            PATCH, mesh)
        gi_r, gl_r = gather_patches(torch.from_numpy(host_img.view(np.int16)).to(device),
                                    torch.from_numpy(host_lbl).to(device),
                                    torch.from_numpy(shard_batch(corners, mesh)).to(device), PATCH)
        assert torch.equal(gi_s, gi_r) and torch.equal(gl_s, gl_r), "sharded gather != replicated"
        step(gi_s, gl_s)

        # sharded sliding windows over the same mesh: patch-sharded with the
        # serving transfers (uint16 both ways, packed mask, sparse fetch),
        # then z-slabs with halo exchange (the output stays sharded)
        model.eval()
        kw = dict(patch_size=PATCH, overlap=0.5, patch_batch=8, z_bucket=PATCH[2],
                  transfer_dtype=cfg.tpu.transfer_dtype, fetch_dtype=cfg.tpu.fetch_dtype,
                  mesh=mesh, device=device)
        sw = SlidingWindowInferencer(model, sparse_fetch=True, **kw)
        vol = rng.random((24, 20, 18), dtype=np.float32)
        body = (rng.random((24, 20, 18)) > 0.3).astype(np.float32)
        prob = sw.fetch(sw.dispatch(sw.prepare(vol, body)))
        assert prob.shape == (24, 20, 18) and np.isfinite(prob).all()
        assert prob.dtype == np.float32  # fetch dequantizes on the host
        assert (prob[body < 0.5] == 0).all()  # masked region exactly zero

        sw_slab = SlidingWindowInferencer(model, spatial_shard=True, **kw)
        zext = PATCH[2] * n + 2  # pads so that each slab is at least one patch
        vol_z = rng.random((20, 20, zext), dtype=np.float32)
        body_z = (rng.random((20, 20, zext)) > 0.3).astype(np.float32)
        prep = sw_slab.prepare(vol_z, body_z)
        assert prep["slab"] and prep["volume"].shape[2] == prep["slab"]
        prob_z = sw_slab.fetch(sw_slab.dispatch(prep))
        if mesh.is_root:
            assert prob_z.shape == vol_z.shape and np.isfinite(prob_z).all()
            assert (prob_z[body_z < 0.5] == 0).all()
            print(f"dryrun_multichip OK: {n}-rank mesh ({mesh.backend}, {device.type}), "
                  f"batch {batch}, loss {loss:.4f}, sharded sliding windows OK", flush=True)
        else:
            assert prob_z is None
    finally:
        finish()


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
