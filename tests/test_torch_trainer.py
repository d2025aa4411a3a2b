"""PyTorch port, the train stage end to end on the CPU: ``Trainer.train`` for
two epochs (augmentation, dropout, device corpus and K-step grouping on),
its files, resume, K-step grouping, the validation input cache, the
sliding window's ``host_prefetch``, and ``--mode all`` of the CLI.

Everything here is the port against itself, and exact: the CPU run is
deterministic, so a resumed run must reproduce the uninterrupted one bit
for bit."""

import json

import numpy as np
import pytest
import torch

from light_unet_tpu.utils import nifti
from light_unet_tpu_torch import cli
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.trainer import Trainer
from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer
from tests.synthetic import build_raw_dataset, make_phantom, write_split_files
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

IDS = ["0001", "0002", "0003", "0004"]


def _cfg(tmp, **tpu):
    return {
        "data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
        "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
        "tpu": {"compute_dtype": "float32", "patch_batch": 16, "z_bucket": 16,
                "steps_per_dispatch": 4, **tpu},
        "training": {"batch_size": 2, "epochs": 2, "learning_rate": 1e-3, "warmup_epochs": 1},
        "output": {"save_every_n_epochs": 1, "keep_last_n_checkpoints": 2},
        "data_dir": str(tmp / "proc"), "splits_dir": str(tmp / "splits"),
    }


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    rng = np.random.default_rng(8)
    data = tmp / "proc"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in IDS:
        img, lab = make_phantom(rng, shape=(20, 24, 28))
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab.astype(np.uint8), aff), data / f"labels/{cid}.nii.gz")
    write_split_files(tmp / "splits", IDS[:2], IDS[2:])
    return tmp


def _trainer(tree, name, epochs=2, **tpu):
    cfg = _cfg(tree, **tpu)
    cfg["training"]["epochs"] = epochs
    return Trainer(Config.from_dict(cfg), workdir=str(tree / name), device="cpu")


def test_train_two_epochs_writes_history_and_checkpoints(tree):
    tr = _trainer(tree, "two")
    assert tr.corpus is not None and tr._chain == 4
    result = tr.train()
    work = tree / "two"
    hist = json.loads((work / "logs/training_history.json").read_text())
    assert list(hist) == ["train_loss", "val_loss", "val_recall", "val_precision", "val_dsc",
                          "val_fp_per_case", "val_best_threshold", "learning_rate"]
    assert all(len(v) == 2 for v in hist.values()) and np.isfinite(hist["train_loss"]).all()
    assert hist == result["history"]
    assert sorted(p.name for p in (work / "models/checkpoints").iterdir()) == [
        "checkpoint_epoch_001.ckpt", "checkpoint_epoch_002.ckpt"]
    assert (work / "models/best_model.pth").exists()
    assert result["skipped_steps_total"] == 0
    assert [h["device"] + h["host"] for h in result["val_fallback_history"]] == [2, 2]
    assert tr._global_step == 2 * len(tr.train_loader)
    # the best model is what the serving path reads
    from light_unet_tpu_torch.core.checkpoint import load_checkpoint

    state, meta = load_checkpoint(work / "models/best_model.pth")
    assert set(state) == set(tr.model.state_dict()) and meta["best_epoch"] == result["best_epoch"]


def test_resume_continues_the_uninterrupted_run(tree):
    full = _trainer(tree, "full", epochs=3)
    full.train()
    part = _trainer(tree, "part", epochs=2)
    part.train()
    resumed = _trainer(tree, "part", epochs=3)
    assert resumed.resume()
    assert resumed.start_epoch == 2 and int(resumed.opt.count) == int(part.opt.count)
    resumed.train()
    assert resumed.history["train_loss"] == full.history["train_loss"]
    assert resumed.history["val_loss"] == full.history["val_loss"]
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    # keep-last-2 rotation
    names = sorted(p.name for p in (tree / "part/models/checkpoints").iterdir())
    assert names == ["checkpoint_epoch_002.ckpt", "checkpoint_epoch_003.ckpt"]
    assert not _trainer(tree, "empty").resume()


def _epoch_losses(tr):
    tr.model.train()
    return tr._flatten_losses([tr._step_on_batch(u) for u in tr._dispatch_units(tr.train_loader)])


def test_k_step_grouping_keeps_the_losses(tree):
    """K = 4 (corner chains, tail shorter) gives K = 1's per-step losses."""
    k4, k1 = _trainer(tree, "k4"), _trainer(tree, "k1", steps_per_dispatch=1)
    units = list(k4._dispatch_units(iter([np.zeros((2, 4), np.int32)] * 9)))
    assert [u.shape for u in units] == [(4, 2, 4), (4, 2, 4), (2, 4)]
    a, b = _epoch_losses(k4), _epoch_losses(k1)
    assert len(a) == len(k4.train_loader) and a == b
    host = _trainer(tree, "host", device_corpus=False)  # host batches: no grouping
    assert host.corpus is None and host._chain == 1
    assert np.isfinite(_epoch_losses(host)).all()


def test_validation_inputs_stay_resident(tree):
    tr = _trainer(tree, "resident")
    calls = []
    orig = tr.sw.prepare
    tr.sw.prepare = lambda *a, **k: calls.append(1) or orig(*a, **k)
    _, m1 = tr.validate(0)
    assert len(calls) == 2 and tr._val_prep_bytes > 0
    _, m2 = tr.validate(1)
    assert len(calls) == 2 and m1 == m2
    none = _trainer(tree, "nobudget", device_val_budget_gb=0.0)
    none.model.load_state_dict(tr.model.state_dict())
    calls0 = []
    orig0 = none.sw.prepare
    none.sw.prepare = lambda *a, **k: calls0.append(1) or orig0(*a, **k)
    assert none.validate(0)[1] == m1 and none.validate(1)[1] == m1
    assert len(calls0) == 4


@pytest.mark.parametrize("fetch", ["uint16", "float32"])
def test_host_prefetch_keeps_the_maps(fetch):
    from light_unet_tpu_torch.models.unet3d import build_model, init_weights

    model_cfg = Config.from_dict({"model": {"encoder_channels": [4, 8, 16, 32], "groups": 4}}).model
    model = init_weights(build_model(model_cfg, inference=True), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    vol = rng.random((20, 18, 30), dtype=np.float32)
    maps = []
    for prefetch in (True, False):
        sw = SlidingWindowInferencer(model.eval(), (16, 16, 16), patch_batch=8, z_bucket=16,
                                     transfer_dtype="uint16", fetch_dtype=fetch,
                                     host_prefetch=prefetch, device="cpu")
        out = sw.dispatch(sw.prepare(vol))
        assert isinstance(out[0], torch.Tensor)  # the pinned copy is for a card only
        maps.append(sw.fetch(out))
    np.testing.assert_array_equal(maps[0], maps[1])
    assert maps[0].shape == vol.shape and maps[0].dtype == np.float32


def test_cli_all_on_the_cpu(tmp_path):
    """``--mode all --device cpu`` on a tiny raw tree: the artifact contract."""
    ids = [f"{i:04d}" for i in range(1, 7)]
    build_raw_dataset(tmp_path / "raw", ids, shape=(24, 24, 40), seed=0)
    cfg = Config.from_dict({
        "data": {"patch_size": [16, 16, 16],
                 "split_ratio": {"train": 0.5, "val": 0.34, "test": 0.16}},
        "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
        "tpu": {"compute_dtype": "float32", "patch_batch": 16, "z_bucket": 16},
        "training": {"epochs": 1},
    })
    cfg.save(tmp_path / "cfg.yaml")
    work = tmp_path / "work"
    rc = cli.run(["--mode", "all", "--device", "cpu", "--config", str(tmp_path / "cfg.yaml"),
                  "--data_root", str(tmp_path / "raw"), "--processed_dir", str(tmp_path / "processed"),
                  "--splits_dir", str(tmp_path / "splits"), "--workdir", str(work)])
    assert rc == 0
    val = (tmp_path / "splits/val_list.txt").read_text().split()
    assert (tmp_path / "splits/train_list.txt").exists() and (tmp_path / "split_manifest.json").exists()
    for sub in ("images", "labels", "body_masks", "metadata"):
        assert any((tmp_path / "processed" / sub).iterdir()), sub
    assert (work / "models/best_model.pth").exists()
    assert (work / "logs/training_history.json").exists()
    for cid in val:
        assert (work / f"inference/prob_maps/{cid}_prob.nii.gz").exists()
        assert (work / f"inference/bboxes/{cid}_bboxes.json").exists()
    assert (work / "inference/metrics.csv").read_text().startswith("threshold,recall,")
    detailed = json.loads((work / "inference/detailed_results.json").read_text())
    assert sorted(detailed["per_case"]) == sorted(val)


def test_cli_bench_and_mixed_training_name_the_roadmap(tree):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        cli.run(["--mode", "bench"])
    cfg = Config.from_dict({**_cfg(tree), "training": {"mixed_domains": {"enabled": True}}})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 14"):
        Trainer(cfg, workdir=str(tree / "mixed"), device="cpu")
    multi = Config.from_dict({**_cfg(tree), "tpu": {"mesh_shape": [2]}})
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
        Trainer(multi, workdir=str(tree / "multi"), device="cpu")
