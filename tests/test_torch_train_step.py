"""PyTorch port, the train stage against the JAX package: the training step
and ``Trainer.validate`` of the port's ``Trainer(device="cpu")`` on the same
processed cases, the same corner batches and the JAX trainer's weights.

Both trainers run float32 (JAX at ``highest`` precision, torch without
TF32), augmentation and dropout off.  Tolerances:

* per-step losses <= 1e-4 relative;
* Adam moments relative to the model's largest entry of each: the first
  moment <= 1e-5, the second <= 2e-5 (it is quadratic in the gradient, so
  it carries twice the gradient's relative rounding); step counts equal.
  The bound is model-wide because float32 accumulation noise in a weight
  gradient is set by the largest terms of its sum, not by the entry itself;
* parameters within 2 * lr * steps: AdamW divides the first moment by the
  root of the second, so where a gradient entry is near zero the rounding
  of the two frameworks can move that weight by up to lr per step each way;
* validation: lesion counts, recall, precision, FP per case and the best
  threshold equal; DSC <= 1e-6; the validation loss <= 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

import light_unet_tpu.core.trainer as jax_trainer_mod
from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.utils import nifti
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.trainer import Trainer
from light_unet_tpu_torch.ops import val_metrics as vm
from light_unet_tpu_torch.tools.weights import from_jax_params
from tests.synthetic import make_phantom, write_split_files
from tests.torch_parity import one_torch_thread, random_params  # noqa: F401 (fixture)

N_STEPS = 4
LR = 1e-3
AUG_OFF = {k: {"enabled": False} for k in (
    "random_flip", "random_rotation", "random_scale", "intensity_shift", "gaussian_noise")}


def _config(tmp):
    return {
        "data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
        "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4, "use_dropout": False},
        "tpu": {"compute_dtype": "float32", "mesh_shape": [1], "patch_batch": 16,
                "z_bucket": 16, "steps_per_dispatch": 1},
        "augmentation": AUG_OFF,
        "training": {"batch_size": 2, "learning_rate": LR},
        "data_dir": str(tmp / "proc"), "splits_dir": str(tmp / "splits"),
    }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX trainer, port trainer with the JAX trainer's initial weights, config)."""
    tmp = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(3)
    ids = ["0001", "0002", "0003"]
    data = tmp / "proc"
    (data / "images").mkdir(parents=True)
    (data / "labels").mkdir()
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in ids:
        img, lab = make_phantom(rng, shape=(24, 24, 32))
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab.astype(np.uint8), aff), data / f"labels/{cid}.nii.gz")
    write_split_files(tmp / "splits", ids[:1], ids[1:])
    cfg = _config(tmp)
    with pytest.MonkeyPatch.context() as mp:
        # seeded numpy weights through jax.eval_shape: nothing to compile
        mp.setattr(jax_trainer_mod, "init_params",
                   lambda model, key, patch: random_params(model, (1, *patch, 1), seed=4,
                                                           train=False))
        jt = jax_trainer_mod.Trainer(JaxConfig.from_dict(cfg), workdir=str(tmp / "jax"))
    tt = Trainer(Config.from_dict(cfg), workdir=str(tmp / "port"), device="cpu")
    tt.model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params)))
    yield jt, tt, cfg, tmp
    jt.writer.close()
    tt.writer.close()


def _port_moments(tt):
    sd = tt.opt.state_dict()["state"]
    names = [n for n, _ in tt.model.named_parameters()]
    return ({n: sd[i]["exp_avg"] for i, n in enumerate(names)},
            {n: sd[i]["exp_avg_sq"] for i, n in enumerate(names)})


def test_history_keys_match_jax(pair):
    jt, tt, _, _ = pair
    assert list(tt.history) == list(jt.history)


def test_train_step_matches_jax(pair):
    jt, tt, _, _ = pair
    assert jt.corpus is not None and tt.corpus is not None
    jt._set_lr(LR)
    tt._set_lr(LR)
    corners = [tt.train_loader.sample_corners() for _ in range(N_STEPS)]
    for step, c in enumerate(corners):
        loss_j = float(jt._step_on_batch(c))
        loss_t = float(tt._step_on_batch(c))
        assert abs(loss_t - loss_j) <= 1e-4 * abs(loss_j), (step, loss_t, loss_j)
    adam = jt.opt_state.inner_state[0]
    assert int(adam.count) == int(tt.opt.count) == N_STEPS
    mu_t, nu_t = _port_moments(tt)
    for jax_tree, port, tol in ((adam.mu, mu_t, 1e-5), (adam.nu, nu_t, 2e-5)):
        want = from_jax_params(jax.tree_util.tree_map(np.asarray, jax_tree))
        assert set(want) == set(port)
        scale = max(float(w.abs().max()) for w in want.values())
        for k, w in want.items():
            assert (port[k] - w).abs().max() <= tol * scale, k
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params))
    got = tt.model.state_dict()
    for k, w in want.items():
        assert (got[k] - w).abs().max() <= 2 * LR * N_STEPS, k
    tt._epoch_oks.clear()
    jt._epoch_oks.clear()


def _bridge(jt, tt):
    tt.model.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, jt.params)))


def test_validate_matches_jax(pair):
    jt, tt, _, _ = pair
    _bridge(jt, tt)
    loss_j, m_j = jt.validate(0)
    loss_t, m_t = tt.validate(0)
    assert tt.val_fallback_history[-1]["device"] == 2 and tt.val_fallback_history[-1]["host"] == 0
    assert abs(loss_t - loss_j) <= 1e-5 * abs(loss_j)
    assert set(m_t) == set(m_j)
    for k, v in m_j.items():
        if "dsc" in k:
            assert m_t[k] == pytest.approx(v, abs=1e-6), k
        else:
            assert m_t[k] == v, k
    assert m_t["tp"] + m_t["fn"] > 0


def test_validate_escalated_and_host_paths(pair, monkeypatch):
    """The 4x-cap tier recovers a forced component overflow on the device;
    a cap-independent overflow goes to the exact host path; both give the
    device sweep's metrics."""
    jt, tt, _, _ = pair
    _bridge(jt, tt)
    tt._val_overflow_backoff.clear()
    _, m_ref = tt.validate(0)
    orig = vm.DeviceValidationSweep.case_metrics

    def overflow_on_small(self, *a, **k):
        if self.max_components <= 4096:
            self.last_overflow_reason = "components"
            return None
        return orig(self, *a, **k)

    monkeypatch.setattr(vm.DeviceValidationSweep, "case_metrics", overflow_on_small)
    tt.val_fallback_history.clear()
    _, m_esc = tt.validate(0)
    fb = tt.val_fallback_history[0]
    assert fb["escalated"] == fb["n_cases"] == 2 and fb["host"] == 0
    assert tt._val_sweep_big.max_components == 4 * tt._val_sweep.max_components
    assert m_esc == m_ref

    def overflow_envelope(self, *a, **k):
        self.last_overflow_reason = "envelope"
        return None

    monkeypatch.setattr(vm.DeviceValidationSweep, "case_metrics", overflow_envelope)
    tt._val_sweep_big = None
    tt._val_overflow_backoff.clear()
    tt.val_fallback_history.clear()
    _, m_host = tt.validate(0)
    fb = tt.val_fallback_history[0]
    assert fb["escalated"] == 0 and fb["host"] == fb["n_cases"] == 2
    assert fb["host_fetch_bytes"] > 0 and tt._val_sweep_big is None
    assert set(tt._val_overflow_backoff.values()) == {3}  # retried only every few epochs
    for k, v in m_ref.items():
        assert m_host[k] == pytest.approx(v, abs=1e-9), k
