"""PyTorch port, the multi-rank entry points on 2 gloo ranks on the CPU,
held against the port's own one-process runs (exact semantics, float32):

* ``Trainer`` with a case-sharded corpus, K = 4, augmentation and dropout
  on, at the one-process run's global batch: per-step losses <= 1e-4
  relative, parameters bit-identical across ranks, and only rank 0 writes
  checkpoints, the best model, TensorBoard and the history; a batch the
  mesh does not divide raises, and resume needs every rank to find the
  same checkpoint (else all of them raise) and continues bit for bit;
* ``--mode inference`` of the CLI (it makes the process group from the
  YAML's ``tpu:`` fields and ends it) and ``Inferencer.infer_split`` in slab
  mode: rank 0 alone writes ``{id}_prob.nii.gz`` / ``{id}_bboxes.json``,
  equal to the one-process files (maps <= 1e-5, boxes equal);
* ``entry.dryrun_multichip`` on 2 and 4 ranks, and ``entry``."""

import json

import numpy as np
import pytest
import torch

from light_unet_tpu.utils import nifti as jax_nifti
from light_unet_tpu_torch import entry
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.inferencer import Inferencer
from light_unet_tpu_torch.core.trainer import Trainer
from light_unet_tpu_torch.models.unet3d import build_model, init_weights
from light_unet_tpu_torch.utils import nifti
from tests import torch_parallel_ranks as ranks
from tests.synthetic import make_phantom, write_split_files
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

IDS = ["0001", "0002", "0003", "0004"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank job and the one-process references on the same tree."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(8)
    data = tmp / "proc"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in IDS:
        img, lab = make_phantom(rng, shape=(20, 24, 28))
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        jax_nifti.save(jax_nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        jax_nifti.save(jax_nifti.Nifti1Image(lab.astype(np.uint8), aff), data / f"labels/{cid}.nii.gz")
    write_split_files(tmp / "splits", IDS[:2], IDS[2:])
    base = {
        "data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
        "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
        "tpu": {"compute_dtype": "float32", "patch_batch": 16, "z_bucket": 16,
                "fetch_dtype": "float32"},
        "data_dir": str(data), "splits_dir": str(tmp / "splits"),
    }
    train = {**base, "tpu": {**base["tpu"], "shard_corpus": True, "steps_per_dispatch": 4},
             "training": {"batch_size": 2, "epochs": 2, "learning_rate": 1e-3,
                          "warmup_epochs": 1},
             "output": {"save_every_n_epochs": 1}}
    model = init_weights(build_model(Config.from_dict(base).model, inference=True),
                         torch.Generator().manual_seed(5))
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, tmp / "best_model.pth")
    tree = {"model": str(tmp / "best_model.pth"), "data": str(data),
            "val_split": str(tmp / "splits/val_list.txt")}
    for name, obj in (("config", base), ("train", train), ("tree", tree)):
        (tmp / f"{name}.json").write_text(json.dumps(obj))

    got = ranks.spawn("trainer", 2, tmp)

    one = Trainer(Config.from_dict(train), workdir=str(tmp / "one"), device="cpu")
    losses = []
    flatten = one._flatten_losses
    one._flatten_losses = lambda device_losses: ranks._record(flatten, device_losses, losses)
    one.train()
    inf = Inferencer(Config.from_dict(base), tmp / "best_model.pth", workdir=str(tmp / "serve1"),
                     device="cpu")
    assert inf.mesh is None and not inf.infer_split(tree["val_split"], data)["failed"]
    return {"tmp": tmp, "ranks": got, "losses": losses, "one": one}


def test_two_ranks_train_as_one_process(runs):
    r0, r1 = runs["ranks"]
    assert r0["global_batch"].tolist() == [2, 2] and r1["global_batch"].tolist() == [2, 2]
    # case-sharded: 2 training cases, one row per rank
    assert r0["corpus_rows"].tolist() == [1, 1] and r1["corpus_rows"].tolist() == [1, 1]
    want = np.array(runs["losses"])
    assert len(want) == len(r0["losses"]) > 2 and np.isfinite(want).all()
    np.testing.assert_array_equal(r0["losses"], r1["losses"])  # the same global loss
    assert np.abs(r0["losses"] - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_array_equal(r0["params"], r1["params"])
    # Adam turns last-bit gradient differences into up to lr-sized steps
    # where a gradient is near 0: after 40 steps at lr 1e-3 the parameters
    # agree to a small share of the distance they moved
    assert np.abs(r0["params"] - runs["one"].opt.flat.numpy()).mean() <= 1e-3
    h0, h1 = json.loads(str(r0["history"])), json.loads(str(r1["history"]))
    assert h0 == h1 and len(h0["train_loss"]) == 2
    np.testing.assert_allclose(h0["train_loss"], runs["one"].history["train_loss"], rtol=1e-4)


def test_batch_per_device_scales_the_learning_rate(runs):
    """``tests/unit/test_parallel.py:179``'s rule on 2 ranks: the global batch
    is batch_size x 2 and ``scale_lr_with_devices`` doubles the base rate,
    which the schedule and the optimizer take."""
    lr = runs["one"].config.training.learning_rate
    for got in runs["ranks"]:
        batch, base, sched, opt = got["scaled_lr"].tolist()
        assert batch == 4 and base == pytest.approx(2 * lr)
        assert sched == pytest.approx(base) and opt == pytest.approx(base)


def test_a_batch_the_mesh_does_not_divide_raises(runs):
    """``mesh_shape`` [2] at batch 3: every rank raises ``ValueError``, as
    JAX's placement of the batch does, instead of dropping a row."""
    for got in runs["ranks"]:
        assert "a global batch of 3 does not split over the 2 ranks" in str(got["odd_batch"])
    # the replicated corpus (checked equal across ranks, not broadcast)
    for got in runs["ranks"]:
        assert got["scaled_corpus"].tolist() == [2, 0]


def test_resume_on_two_ranks(runs):
    """Ranks that find different checkpoints (rank 1 has none) all raise
    instead of waiting on each other; from one file every rank reads, the
    resumed run repeats the last epoch's losses and parameters bit for bit."""
    r0, r1 = runs["ranks"]
    for got in (r0, r1):
        assert "differ on 1 of the 2 ranks" in str(got["resume_apart"])
        assert bool(got["resumed"])
        np.testing.assert_array_equal(got["resume_params"], r0["params"])
    n = len(r0["resume_losses"])
    assert 0 < n < len(r0["losses"])
    np.testing.assert_array_equal(r0["resume_losses"], r0["losses"][-n:])
    np.testing.assert_array_equal(r1["resume_losses"], r0["resume_losses"])


def test_only_rank_0_writes_training_files(runs):
    tmp = runs["tmp"]
    r0, r1 = tmp / "dp_r0", tmp / "dp_r1"
    assert sorted(p.name for p in (r0 / "models/checkpoints").iterdir()) == [
        "checkpoint_epoch_001.ckpt", "checkpoint_epoch_002.ckpt"]
    assert (r0 / "models/best_model.pth").exists() and (r0 / "logs/training_history.json").exists()
    assert not r1.exists() or not [p for p in r1.rglob("*") if p.is_file()]


@pytest.mark.parametrize("mode", ["cli", "slab"])
def test_only_rank_0_serves_files_equal_to_one_process(runs, mode):
    tmp = runs["tmp"]
    r0, r1 = runs["ranks"]
    if mode == "cli":
        assert int(r0["cli_rc"]) == int(r1["cli_rc"]) == 0
        assert bool(r0["cli_ended"]) and bool(r1["cli_ended"])  # the CLI ends the group
    else:
        assert bool(r0["slab_mode"]) and int(r0["slab_result"]) == int(r1["slab_result"]) == 2
    root, other = tmp / f"{mode}_r0/inference", tmp / f"{mode}_r1/inference"
    assert not other.exists() or not [p for p in other.rglob("*") if p.is_file()]
    for cid in IDS[2:]:
        got = nifti.load(root / f"prob_maps/{cid}_prob.nii.gz").get_fdata(np.float32)
        want = nifti.load(tmp / f"serve1/inference/prob_maps/{cid}_prob.nii.gz").get_fdata(np.float32)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1e-5
        gb = json.loads((root / f"bboxes/{cid}_bboxes.json").read_text())
        wb = json.loads((tmp / f"serve1/inference/bboxes/{cid}_bboxes.json").read_text())
        assert [c["bbox_voxel"] for c in gb["candidates"]] == [c["bbox_voxel"] for c in wb["candidates"]]
        assert gb["num_candidates"] == wb["num_candidates"]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capfd):
    entry.dryrun_multichip(n)
    assert f"dryrun_multichip OK: {n}-rank mesh (gloo, cpu), batch {2 * n}" in capfd.readouterr().out


def test_entry_returns_the_full_width_bf16_model():
    model, (x,) = entry.entry(device="cpu")
    assert x.shape == (8, 48, 48, 48, 1) and x.dtype == torch.float32
    assert model.compute_dtype == torch.bfloat16 and not model.training
    assert sum(p.numel() for p in model.parameters()) == 217_228
    with torch.no_grad():
        out = model(x[:1, :16, :16, :16])
    assert out.shape == (1, 16, 16, 16, 1) and torch.isfinite(out).all()
