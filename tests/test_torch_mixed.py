"""PyTorch port, mixed FL + DLBCL training (``training.mixed_domains``) on the
CPU: ``MixedPatchSampler`` and both mixed modes of ``get_data_loader``
against the JAX package, one epoch of ``probabilistic`` and of
``fl_epoch_plus_dlbcl`` against the JAX trainer, and the port against
itself (K = 4 against K = 1, resume, the host path, an empty DLBCL split,
the CLI, and ``chip_smoke.py``'s mixed config against the shipped YAML).

Tolerances: samplers, loader batches, corners, step and sample counts are
exact.  Per-step losses against JAX <= 1e-4 relative: both trainers run
float32 (JAX at ``highest``, torch without TF32) with augmentation and
dropout off, from the same seeded weights.  K = 4 against K = 1, and a
resumed run against the uninterrupted one, are equal bit for bit.

The JAX epoch of ``fl_epoch_plus_dlbcl`` uses a name it never defines
(``total_steps``, ``light_unet_tpu/core/trainer.py:801``) and so ends in a
``NameError``.  The tests give that module a global of the name
(``monkeypatch.setattr(..., "total_steps", 1, raising=False)``), so the
epoch runs to its end; the two ``Domain/*_ratio`` scalars it then writes
are not compared.
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import light_unet_tpu.core.trainer as jax_trainer_mod
from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.datasets import loader as JL
from light_unet_tpu.datasets.patch_sampler import MixedPatchSampler as JaxMixed
from light_unet_tpu.datasets.patch_sampler import PatchSampler as JaxSampler
from light_unet_tpu.datasets.volume_cache import VolumeCache as JaxCache
from light_unet_tpu.utils import nifti
from light_unet_tpu_torch import cli
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.trainer import Trainer
from light_unet_tpu_torch.datasets import loader as TL
from light_unet_tpu_torch.datasets.patch_sampler import MixedPatchSampler
from light_unet_tpu_torch.datasets.volume_cache import VolumeCache
from light_unet_tpu_torch.tools.weights import from_jax_params
from tests.synthetic import make_phantom, write_split_files
from tests.torch_parity import one_torch_thread, random_params  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parent.parent
FL, DLBCL = ["0001", "0002"], ["1001", "1002"]
VAL = ["0003", "1003"]  # validation reads FL only: 1003 is left out
PATCH = (16, 16, 16)
LR = 1e-3
MODES = ["probabilistic", "fl_epoch_plus_dlbcl"]
AUG_OFF = {k: {"enabled": False} for k in (
    "random_flip", "random_rotation", "random_scale", "intensity_shift", "gaussian_noise")}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A processed tree of 20x24x28 phantoms: FL 0001-0003, DLBCL 1001-1003;
    ``splits`` trains on FL + DLBCL, ``splits_fl`` on FL alone."""
    tmp = tmp_path_factory.mktemp("mixed")
    rng = np.random.default_rng(21)
    data = tmp / "proc"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in FL + DLBCL + VAL:
        img, lab = make_phantom(rng, shape=(20, 24, 28))
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab.astype(np.uint8), aff), data / f"labels/{cid}.nii.gz")
    write_split_files(tmp / "splits", FL + DLBCL, VAL)
    write_split_files(tmp / "splits_fl", FL, VAL)
    return tmp


def _cfg(tree, mode, splits="splits", parity=False, tpu=None, **mixed):
    """Tiny mixed config; ``parity``: float32 from JAX's weights, no
    augmentation, no dropout, K = 1."""
    cfg = {
        "data": {"patch_size": list(PATCH), "body_mask": {"enabled": False}},
        "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
        "tpu": {"compute_dtype": "float32", "mesh_shape": [1], "patch_batch": 16,
                "z_bucket": 16, "steps_per_dispatch": 4, **(tpu or {})},
        "training": {"batch_size": 4, "epochs": 2, "learning_rate": LR, "warmup_epochs": 1,
                     "mixed_domains": {"enabled": True, "mode": mode, **mixed}},
        "output": {"save_every_n_epochs": 1},
        "data_dir": str(tree / "proc"), "splits_dir": str(tree / splits),
    }
    if parity:
        cfg["model"]["use_dropout"] = False
        cfg["augmentation"] = AUG_OFF
        cfg["tpu"]["steps_per_dispatch"] = 1
    return cfg


class Scalars:
    """A TensorBoard writer that keeps what it is given."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))

    def close(self):
        pass

    def get(self, tag):
        return [v for t, v, _ in self.rows if t == tag]


def _port(tree, name, cfg):
    tr = Trainer(Config.from_dict(cfg), workdir=str(tree / name), device="cpu")
    tr.writer.close()
    tr.writer = Scalars()
    return tr


@pytest.fixture(scope="module")
def jax_steps():
    """The first JAX trainer's compiled step and gather, reused by the next
    ones (the configs differ only in their data, so the programs are the
    same): each JAX trainer would otherwise compile its step anew."""
    return {}


def _jax(tree, name, jax_steps, cfg):
    """A JAX trainer at LR from seeded weights, and those weights for the port."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_mod, "init_params",
                   lambda model, key, patch: random_params(model, (1, *patch, 1), seed=4,
                                                           train=False))
        jt = jax_trainer_mod.Trainer(JaxConfig.from_dict(cfg), workdir=str(tree / name))
    if jax_steps:
        jt._train_step, jt._gather_patches = jax_steps["step"], jax_steps["gather"]
    else:
        jax_steps.update(step=jt._train_step, gather=jt._gather_patches)
    jt.writer.close()
    jt.writer = Scalars()
    jt._set_lr(LR)
    assert jt.corpus is not None
    return jt, from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params))


def _port_from(tree, name, cfg, state):
    tt = _port(tree, name, cfg)
    tt.model.load_state_dict(state)
    tt._set_lr(LR)
    assert tt.corpus is not None
    return tt


def _jax_streams(jt):
    if jt.mode == "fl_epoch_plus_dlbcl":
        return [jt.fl_loader.sampler.rng, jt.dlbcl_loader.sampler.rng]
    ds = jt.train_dataset
    return [ds.rng, ds.fl_sampler.rng, ds.dlbcl_sampler.rng]


def _epoch_corners(trainer, loaders):
    """Every corner batch of one pass of ``loaders``, then the streams back
    where they were."""
    streams = trainer.streams if isinstance(trainer, Trainer) else _jax_streams(trainer)
    saved = [s.bit_generator.state for s in streams]
    out = [c for name in loaders for c in getattr(trainer, name)]
    for s, state in zip(streams, saved):
        s.bit_generator.state = state
    return out


def _assert_close(got, want, what):
    assert len(got) == len(want) > 0, what
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
    assert rel <= 1e-4, (what, rel)


# --- samplers and loaders against JAX ----------------------------------------

@pytest.mark.parametrize("fl_ratio", [0.5, 0.8])
def test_mixed_sampler_matches_jax(tree, fl_ratio):
    split = tree / "splits/train_list.txt"
    ours = MixedPatchSampler(tree / "proc", split, PATCH, 0.5, 7, None, fl_ratio, None,
                             VolumeCache())
    theirs = JaxMixed(tree / "proc", split, PATCH, 0.5, 7, None, fl_ratio, None, JaxCache())
    for sub, ids in (("fl_sampler", FL), ("dlbcl_sampler", DLBCL)):
        a, b = getattr(ours, sub), getattr(theirs, sub)
        assert [c.case_id for c in a.cases] == [c.case_id for c in b.cases] == ids
        for x, y in ((a.lesion_locations, b.lesion_locations),
                     (a.background_locations, b.background_locations)):
            assert len(x) == len(y) > 0
            assert all(i == j and np.array_equal(c, d) for (i, c), (j, d) in zip(x, y))
    assert len(ours) == len(theirs) and ours.patch_size == theirs.patch_size == PATCH
    for _ in range(60):
        (w, i, c), (w2, i2, c2) = ours.draw_index(), theirs.draw_index()
        assert (w, i) == (w2, i2) and np.array_equal(c, c2)
    for _ in range(3):
        for x, y in zip(ours.sample_batch(3), theirs.sample_batch(3)):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    counts = ours.get_sample_counts()
    assert counts == theirs.get_sample_counts() and counts["total_samples"] == 69
    assert counts["fl_samples"] > 0 and counts["dlbcl_samples"] > 0
    ours.reset_sample_counts()
    assert ours.get_sample_counts() == {"fl_samples": 0, "dlbcl_samples": 0, "total_samples": 0}


def test_mixed_sampler_falls_back_to_fl_without_dlbcl(tree):
    split = tree / "splits_fl/train_list.txt"
    ours = MixedPatchSampler(tree / "proc", split, PATCH, 0.5, 3, None, 0.5, None, VolumeCache())
    theirs = JaxMixed(tree / "proc", split, PATCH, 0.5, 3, None, 0.5, None, JaxCache())
    assert len(ours.dlbcl_sampler) == len(theirs.dlbcl_sampler) == 0
    for _ in range(30):
        (w, i, c), (w2, i2, c2) = ours.draw_index(), theirs.draw_index()
        assert w == w2 == 0 and i == i2 and np.array_equal(c, c2)
    assert ours.get_sample_counts() == theirs.get_sample_counts() == {
        "fl_samples": 30, "dlbcl_samples": 0, "total_samples": 30}


@pytest.mark.parametrize("transfer", ["uint16", "float32"])
@pytest.mark.parametrize("mode", MODES)
def test_loader_factory_matches_jax(tree, mode, transfer):
    """Mode tag, keys, loader lengths, case lists and every host batch."""
    cfg = _cfg(tree, mode, tpu={"transfer_dtype": transfer, "prefetch_depth": 2})
    split = tree / "splits/train_list.txt"
    ours = TL.get_data_loader(tree / "proc", split, Config.from_dict(cfg), is_train=True)
    theirs = JL.get_data_loader(tree / "proc", split, JaxConfig.from_dict(cfg), is_train=True)
    assert ours["mode"] == theirs["mode"] == mode and set(ours) == set(theirs)
    if mode == "probabilistic":
        loaders = ["train_loader"]
        mixes = ours["train_dataset"], theirs["train_dataset"]
        samplers = [(m.fl_sampler, m.dlbcl_sampler) for m in mixes]
    else:
        loaders = ["fl_loader", "dlbcl_loader"]
        samplers = [(r["fl_dataset"], r["dlbcl_dataset"]) for r in (ours, theirs)]
    (fl, db), (jfl, jdb) = samplers
    assert [c.case_id for c in fl.cases] == [c.case_id for c in jfl.cases] == FL
    assert [c.case_id for c in db.cases] == [c.case_id for c in jdb.cases] == DLBCL
    for a, b in ((fl, jfl), (db, jdb)):
        assert a.rng.bit_generator.state == b.rng.bit_generator.state
    for name in loaders:
        lo, lj = ours[name], theirs[name]
        assert len(lo) == len(lj) > 1
        n = 0
        for x, y in zip(lo, lj):
            for a, b in zip(x, y):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            n += 1
        assert n == len(lj)
    val = TL.get_data_loader(tree / "proc", tree / "splits/val_list.txt", Config.from_dict(cfg),
                             is_train=False)
    assert val["mode"] == "validation" and [s.case_id for s in val["val_loader"]] == ["0003"]


# --- one epoch against the JAX trainer ----------------------------------------

def test_probabilistic_epoch_matches_jax(tree, jax_steps):
    cfg = _cfg(tree, "probabilistic", parity=True)
    jt, state = _jax(tree, "prob_jax", jax_steps, cfg)
    tt = _port_from(tree, "prob_port", cfg, state)
    corners = _epoch_corners(tt, ["train_loader"])
    assert len(corners) == len(tt.train_loader) == len(jt.train_loader)
    for a, b in zip(corners, _epoch_corners(jt, ["train_loader"])):
        np.testing.assert_array_equal(a, b)
    assert {int(r) for c in corners for r in c[:, 0]} == {0, 1, 2, 3}  # rows of both domains
    jt.train_epoch(0)
    tt.train_epoch(0)
    steps = len(tt.train_loader)
    _assert_close(tt.writer.get("Loss/train_step"), jt.writer.get("Loss/train_step"), "steps")
    assert len(tt.writer.get("Loss/train_step")) == steps
    for tag in ("fl_samples", "dlbcl_samples", "fl_ratio", "dlbcl_ratio"):
        assert tt.writer.get(f"Domain/{tag}") == jt.writer.get(f"Domain/{tag}"), tag
    fl, db = tt.writer.get("Domain/fl_samples")[0], tt.writer.get("Domain/dlbcl_samples")[0]
    assert fl + db == steps * 4 and fl > 0 and db > 0


@pytest.fixture(scope="module")
def jax_fl_epoch(tree, jax_steps):
    """One real JAX ``fl_epoch_plus_dlbcl`` epoch at ratio 2.5, the longest
    case: every case's FL steps and first DLBCL steps are this epoch's (the
    same weights, seeds and streams), so each port run is held against a
    prefix of it.  Returns the JAX trainer, its corners of the epoch and
    the initial weights."""
    cfg = _cfg(tree, "fl_epoch_plus_dlbcl", parity=True, dlbcl_steps_ratio=2.5)
    jt, state = _jax(tree, "fl_jax", jax_steps, cfg)
    corners = _epoch_corners(jt, ["fl_loader", "dlbcl_loader"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_trainer_mod, "total_steps", 1, raising=False)
        jt.train_epoch(0)
    return jt, corners, state


@pytest.mark.parametrize("steps", [{"dlbcl_steps_ratio": 0.5}, {"dlbcl_steps_ratio": 1.0},
                                   {"dlbcl_steps_ratio": 2.5}, {"dlbcl_steps": 3}],
                         ids=["ratio0.5", "ratio1.0", "ratio2.5", "steps3"])
def test_fl_epoch_plus_dlbcl_epoch_matches_jax(tree, jax_fl_epoch, monkeypatch, steps):
    """Per-step FL and DLBCL losses against the JAX epoch; the step counts
    against JAX's own epoch loop at this case's setting (run again with a
    stand-in step: only its counting is read)."""
    jt, jax_corners, state = jax_fl_epoch
    ref = jt.writer
    cfg = _cfg(tree, "fl_epoch_plus_dlbcl", parity=True, **steps)
    tt = _port_from(tree, f"fl_{'_'.join(map(str, steps.values()))}", cfg, state)
    fl_batches = len(tt.fl_loader)
    assert fl_batches == len(jt.fl_loader) and len(tt.dlbcl_loader) == len(jt.dlbcl_loader)
    for a, b in zip(_epoch_corners(tt, ["fl_loader", "dlbcl_loader"]), jax_corners):
        np.testing.assert_array_equal(a, b)
    want = steps.get("dlbcl_steps", round(fl_batches * steps.get("dlbcl_steps_ratio", 0)))
    combined = tt.train_epoch(0)
    fl, db = tt.writer.get("Loss/fl_step"), tt.writer.get("Loss/dlbcl_step")
    assert len(fl) == fl_batches and len(db) == want
    _assert_close(fl, ref.get("Loss/fl_step"), "fl")
    _assert_close(db, ref.get("Loss/dlbcl_step")[:want], "dlbcl")
    assert tt.writer.get("Loss/train_step") == fl + db
    assert combined == tt.writer.get("Loss/combined")[0] == pytest.approx(np.mean(fl + db))
    assert tt.writer.get("Domain/fl_ratio") == [fl_batches / (fl_batches + want)]
    if steps.get("dlbcl_steps_ratio") == 2.5:
        assert want > 2 * len(tt.dlbcl_loader)  # the DLBCL loader restarted twice
        _assert_close(tt.writer.get("Loss/combined"), ref.get("Loss/combined"), "combined")

    monkeypatch.setattr(jax_trainer_mod, "total_steps", 1, raising=False)
    monkeypatch.setattr(jt, "writer", Scalars())
    monkeypatch.setattr(jt, "_step_on_batch", lambda b: np.ones(jt._unit_steps(b), np.float32))
    for key, value in steps.items():
        monkeypatch.setattr(jt.config.training.mixed_domains, key, value)
    jt.train_epoch(1)
    for tag in ("Domain/fl_steps", "Domain/dlbcl_steps"):
        assert tt.writer.get(tag) == jt.writer.get(tag), tag
    assert tt.writer.get("Domain/dlbcl_steps") == [want]


# --- the port against itself ---------------------------------------------------

def _losses(tr):
    tr.train_epoch(0)
    return tr.writer.get("Loss/train_step")


@pytest.mark.parametrize("mode", MODES)
def test_k_step_grouping_keeps_the_losses(tree, mode):
    """K = 4 chains give K = 1's per-step losses; the DLBCL loader holds 10
    batches, so the chain of DLBCL steps 9-12 spans its restart."""
    cfg = _cfg(tree, mode, dlbcl_steps=14)
    k4 = _port(tree, f"k4_{mode}", cfg)
    cfg["tpu"]["steps_per_dispatch"] = 1
    k1 = _port(tree, f"k1_{mode}", cfg)
    assert k4._chain == 4 and k1._chain == 1
    if mode == "fl_epoch_plus_dlbcl":
        assert len(k4.dlbcl_loader) % 4 != 0
    a, b = _losses(k4), _losses(k1)
    assert a == b and np.isfinite(a).all()
    assert len(a) == (len(k4.fl_loader) + 14 if mode == "fl_epoch_plus_dlbcl"
                      else len(k4.train_loader))


@pytest.mark.parametrize("mode", MODES)
def test_resume_continues_the_uninterrupted_run(tree, mode):
    """A fresh trainer resumes from the checkpoint the run wrote after epoch
    1 of 2: the same epoch-2 losses, weights and numpy streams as the run
    that went on."""
    full = _port(tree, f"full_{mode}", _cfg(tree, mode))
    full.train()
    resumed = _port(tree, f"resumed_{mode}", _cfg(tree, mode))
    assert resumed.resume(tree / f"full_{mode}/models/checkpoints/checkpoint_epoch_001.ckpt")
    assert resumed.start_epoch == 1 and resumed.history["train_loss"] == full.history["train_loss"][:1]
    resumed.train()
    assert len(resumed.streams) == (3 if mode == "probabilistic" else 2)
    assert resumed.history == full.history
    epoch2 = resumed.writer.get("Loss/train_step")
    assert epoch2 == full.writer.get("Loss/train_step")[-len(epoch2):]
    assert len(full.writer.get("Loss/train_step")) == 2 * len(epoch2)
    for k, v in full.model.state_dict().items():
        assert torch.equal(resumed.model.state_dict()[k], v), k
    for a, b in zip(resumed.streams, full.streams):
        assert a.bit_generator.state == b.bit_generator.state
    assert torch.equal(resumed.gen.get_state(), full.gen.get_state())
    assert [h["n_cases"] for h in full.val_fallback_history] == [1, 1]  # FL-only validation


@pytest.mark.parametrize("mode", MODES)
def test_host_path_counts_its_steps(tree, mode):
    """Without the corpus the loaders stream host batches (prefetch thread):
    the step counts hold and the losses are finite (the DLBCL stream's
    position after a cut loader epoch depends on the thread, in both
    packages, so nothing more is compared)."""
    tr = _port(tree, f"host_{mode}", _cfg(tree, mode, tpu={"transfer_dtype": "float32"},
                                          dlbcl_steps_ratio=1.5))
    assert tr.corpus is None and tr._chain == 1
    losses = _losses(tr)
    assert np.isfinite(losses).all()
    if mode == "fl_epoch_plus_dlbcl":
        fl = len(tr.fl_loader)
        assert tr.writer.get("Domain/fl_steps") == [fl]
        assert tr.writer.get("Domain/dlbcl_steps") == [round(1.5 * fl)] and len(losses) == fl + round(
            1.5 * fl)
    else:
        assert len(losses) == len(tr.train_loader)
        assert sum(tr.writer.get(f"Domain/{d}_samples")[0] for d in ("fl", "dlbcl")) == 4 * len(
            losses)


def test_empty_dlbcl_split(tree):
    """``probabilistic`` trains on FL alone; ``fl_epoch_plus_dlbcl`` stops at
    its first DLBCL draw with the JAX sampler's error (``rng.integers(0)``)."""
    prob = _port(tree, "empty_prob", _cfg(tree, "probabilistic", splits="splits_fl"))
    n = len(_losses(prob))
    assert prob.writer.get("Domain/fl_samples") == [4 * n]
    assert prob.writer.get("Domain/dlbcl_samples") == [0]
    tr = _port(tree, "empty_fl", _cfg(tree, "fl_epoch_plus_dlbcl", splits="splits_fl"))
    assert len(tr.dlbcl_loader) == 1 and not tr._samplers[1].cases
    with pytest.raises(ValueError) as ours:
        tr.train_epoch(0)
    jax_db = JaxSampler(tree / "proc", tree / "splits_fl/train_list.txt", PATCH, 0.5, 43,
                        {"domain": "dlbcl"}, None, JaxCache())
    with pytest.raises(ValueError) as theirs:
        jax_db.draw_index()
    assert str(ours.value) == str(theirs.value)


def test_cli_trains_a_mixed_config_on_the_cpu(tree):
    cfg = _cfg(tree, "fl_epoch_plus_dlbcl")
    cfg["training"]["epochs"] = 1
    Config.from_dict(cfg).save(tree / "mixed.yaml")
    work = tree / "cli"
    argv = ["--mode", "train", "--config", str(tree / "mixed.yaml"), "--processed_dir",
            str(tree / "proc"), "--splits_dir", str(tree / "splits"), "--workdir", str(work)]
    assert cli.run(argv + ["--device", "cpu"]) == 0
    hist = json.loads((work / "logs/training_history.json").read_text())
    assert len(hist["train_loss"]) == 1 and np.isfinite(hist["train_loss"]).all()
    assert (work / "models/checkpoints/checkpoint_epoch_001.ckpt").exists()
    if not torch.cuda.is_available():  # the CLI's default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.run(argv)


def test_chip_smoke_mixed_config_is_the_shipped_yaml(tree):
    """The card machine has no PyYAML, so ``chip_smoke.py`` states the mixed
    config as a dict; it equals the YAML on every ``training`` and ``tpu``
    field it does not deliberately override."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ours = Config.from_dict(smoke.mixed_train_config(tree / "proc", tree / "splits")).to_dict()
    want = Config.load(REPO / "configs/unet_mixed_fl_dlbcl.yaml").to_dict()
    overridden = {"training": {"epochs", "learning_rate", "use_warmup"},
                  "tpu": {"use_pallas", "fused_block"}}
    for section, skip in overridden.items():
        assert set(ours[section]) == set(want[section])
        for key in set(want[section]) - skip:
            assert ours[section][key] == want[section][key], (section, key)
    assert ours["training"]["mixed_domains"]["mode"] == "fl_epoch_plus_dlbcl"
    assert ours["data"]["domains"] == want["data"]["domains"]
    assert ours["model"] == want["model"]
