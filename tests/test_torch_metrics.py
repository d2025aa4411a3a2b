"""PyTorch port: host metrics, the device-memory ledger, the LR schedule and
the losses, each held against the JAX package on the same seeded inputs.

Tolerances: metrics and schedule exact (dict / sequence equality); losses
<= 1e-6 relative in value and <= 1e-5 relative (to the largest gradient
entry) in gradient, float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.core.schedule import LRScheduler as JaxLRScheduler
from light_unet_tpu.models import losses as JL
from light_unet_tpu.models import metrics as JM
from light_unet_tpu.utils.hbm_ledger import HbmLedger as JaxLedger
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.schedule import LRScheduler
from light_unet_tpu_torch.models import losses as TL
from light_unet_tpu_torch.models import metrics as TM
from light_unet_tpu_torch.utils.hbm_ledger import HbmLedger, tree_nbytes
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

SPACINGS = [(4.0, 4.0, 4.0), (2.0, 3.0, 5.0)]


def _case(rng, shape=(20, 22, 26), n_lesions=4):
    target = np.zeros(shape, np.float32)
    for _ in range(n_lesions):
        c = rng.integers(3, np.array(shape) - 3)
        target[c[0] - 2:c[0] + 2, c[1] - 1:c[1] + 2, c[2] - 2:c[2] + 1] = 1
    prob = np.clip(target * rng.uniform(0.4, 1.0) + rng.random(shape, dtype=np.float32) * 0.4,
                   0, 1).astype(np.float32)
    return prob, target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    probs, targets = zip(*(_case(rng) for _ in range(3)))
    thresholds = [0.2, 0.3, 0.5, 0.7]
    for sp in SPACINGS:
        assert TM.calculate_metrics(list(probs), list(targets), 0.5, sp) == \
            JM.calculate_metrics(list(probs), list(targets), 0.5, sp)
        assert TM.calculate_metrics_sweep(list(probs), list(targets), thresholds, sp) == \
            JM.calculate_metrics_sweep(list(probs), list(targets), thresholds, sp)
        assert TM.lesion_metrics_sweep(probs[0], targets[0], thresholds, spacing=sp) == \
            JM.lesion_metrics_sweep(probs[0], targets[0], thresholds, spacing=sp)
        for min_size in (0, 5):
            assert TM.calculate_lesion_metrics(probs[1], targets[1], 0.4, min_size, spacing=sp) == \
                JM.calculate_lesion_metrics(probs[1], targets[1], 0.4, min_size, spacing=sp)
    pred_lab, n = TM.get_connected_components(probs[2] >= 0.5)
    tgt_lab, _ = TM.get_connected_components(targets[2])
    assert n > 0
    assert TM.match_components(pred_lab, tgt_lab) == JM.match_components(pred_lab, tgt_lab)
    assert TM.calculate_dsc(probs[0] > 0.5, targets[0]) == JM.calculate_dsc(probs[0] > 0.5, targets[0])
    assert TM.calculate_iou(probs[0] > 0.5, targets[0] > 0) == \
        JM.calculate_iou(probs[0] > 0.5, targets[0] > 0)
    np.testing.assert_array_equal(TM._component_centers(tgt_lab, int(tgt_lab.max())),
                                  JM._component_centers(tgt_lab, int(tgt_lab.max())))


def test_metrics_empty_cases_match_jax():
    empty = np.zeros((8, 8, 8), np.float32)
    one = empty.copy()
    one[2:4, 2:4, 2:4] = 1
    for pred, tgt in ((empty, empty), (one, empty), (empty, one), (one, one)):
        assert TM.calculate_lesion_metrics(pred, tgt) == JM.calculate_lesion_metrics(pred, tgt)
        assert TM.calculate_metrics([pred], [tgt]) == JM.calculate_metrics([pred], [tgt])
    assert TM.DEFAULT_SPACING == JM.DEFAULT_SPACING and TM.SMOOTH == JM.SMOOTH


def test_ledger_matches_jax():
    gb = 1 << 30
    ours, theirs = HbmLedger(capacity_bytes=4 * gb), JaxLedger(capacity_bytes=4 * gb)
    for led in (ours, theirs):
        led.charge("params+opt_state", 3 * 2**20)
        assert led.try_charge("train_corpus", int(2.5 * gb))
        assert not led.try_charge("val_inputs", gb)  # 0.15 reserve leaves < 1 GB
        assert led.try_charge("val_gt_ids", 2**20)
        led.release("val_gt_ids")
    assert ours.summary() == theirs.summary()
    assert ours.remaining() == theirs.remaining() and ours.reserve == theirs.reserve
    assert ours.remaining_gb() == theirs.remaining_gb()


def test_ledger_capacity_and_tree_nbytes(monkeypatch):
    monkeypatch.setenv("LIGHT_UNET_HBM_GB", "2")
    assert HbmLedger().capacity == 2 * (1 << 30)
    monkeypatch.delenv("LIGHT_UNET_HBM_GB")
    assert HbmLedger(device="cpu").capacity == 16 * (1 << 30)  # the CPU: JAX's default
    sd = {"a": torch.zeros(3, 4), "b": [torch.zeros(2, dtype=torch.int16), np.zeros(5, np.uint8)]}
    assert tree_nbytes(sd) == 48 + 4 + 5


@pytest.mark.parametrize("name, warmup, plateau_metrics", [
    ("CosineAnnealingLR", True, None),
    ("CosineAnnealingLR", False, None),
    ("ReduceLROnPlateau", True, [0.1, 0.2, 0.2, 0.2, 0.15, 0.2, 0.2, 0.3] * 4),
    ("ReduceLROnPlateau", False, [0.5] * 30),
])
def test_schedule_matches_jax(name, warmup, plateau_metrics):
    cfg = {"training": {"scheduler": {"name": name, "T_max": 20, "patience": 2, "factor": 0.5,
                                      "min_lr": 1e-5}}}
    ours = LRScheduler(Config.from_dict(cfg).training.scheduler, 1e-3, warmup, 5)
    theirs = JaxLRScheduler(JaxConfig.from_dict(cfg).training.scheduler, 1e-3, warmup, 5)
    seq_o, seq_t = [ours.current_lr()], [theirs.current_lr()]
    for e in range(30):
        m = plateau_metrics[e] if plateau_metrics else None
        seq_o.append(ours.step(m))
        seq_t.append(theirs.step(m))
    assert seq_o == seq_t
    assert ours.state_dict() == theirs.state_dict()
    fresh = LRScheduler(Config.from_dict(cfg).training.scheduler, 1e-3, warmup, 5)
    fresh.load_state_dict(theirs.state_dict())
    assert fresh.current_lr() == theirs.current_lr()


def _loss_inputs(seed, shape=(2, 8, 8, 8, 1), saturate=False):
    rng = np.random.default_rng(seed)
    target = (rng.random(shape) < 0.2).astype(np.float32)
    pred = rng.uniform(0.02, 0.98, shape).astype(np.float32)
    if saturate:  # a perfect batch: tversky == 1, the focal base is 0
        pred = target.copy()
    mask = np.ones(shape, np.float32)
    mask[..., 5:, :] = 0.0
    return pred, target, mask


LOSS_CFGS = [
    {"name": "FocalTverskyLoss", "use_combined_loss": False},
    {"name": "FocalTverskyLoss", "use_combined_loss": True},
    {"name": "DiceLoss", "use_combined_loss": False},
]


@pytest.mark.parametrize("loss_cfg", LOSS_CFGS)
@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(loss_cfg, seed):
    pred, target, mask = _loss_inputs(seed)
    lc_t = Config.from_dict({"loss": loss_cfg}).loss
    lc_j = JaxConfig.from_dict({"loss": loss_cfg}).loss
    fn_t, fn_j = TL.get_loss_function(lc_t), JL.get_loss_function(lc_j)
    mfn_t, mfn_j = TL.get_masked_loss_function(lc_t), JL.get_masked_loss_function(lc_j)

    pt = torch.tensor(pred, requires_grad=True)
    val_t = fn_t(pt, torch.tensor(target))
    (g_t,) = torch.autograd.grad(val_t, pt)
    val_j, g_j = jax.value_and_grad(lambda p: fn_j(p, jnp.asarray(target)))(jnp.asarray(pred))
    assert abs(float(val_t.detach()) - float(val_j)) <= 1e-6 * abs(float(val_j))
    g_j = np.asarray(g_j)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-5 * np.abs(g_j).max()

    m_t = mfn_t(torch.tensor(pred), torch.tensor(target), torch.tensor(mask))
    m_j = mfn_j(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask))
    assert abs(float(m_t) - float(m_j)) <= 1e-6 * abs(float(m_j))
    assert TL.host_val_loss(pred, target, lc_t) == JL.host_val_loss(pred, target, lc_j)


def test_focal_pow_gradient_is_zero_at_the_minimum():
    """A perfectly predicted batch: value 0, gradient finite and equal to JAX's."""
    pred, target, _ = _loss_inputs(3, saturate=True)
    pt = torch.tensor(pred, requires_grad=True)
    val_t = TL.focal_tversky_loss(pt, torch.tensor(target))
    (g_t,) = torch.autograd.grad(val_t, pt)
    val_j, g_j = jax.value_and_grad(
        lambda p: JL.focal_tversky_loss(p, jnp.asarray(target)))(jnp.asarray(pred))
    assert float(val_t.detach()) == float(val_j) == 0.0
    assert torch.isfinite(g_t).all()
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    base = torch.zeros(3, requires_grad=True)
    (g,) = torch.autograd.grad(TL._focal_pow(base, 0.75).sum(), base)
    assert torch.equal(g, torch.zeros(3))


def test_unknown_loss_raises():
    lc = Config.from_dict({"loss": {"name": "FocalTverskyLoss"}}).loss
    lc.name = "Nope"
    with pytest.raises(ValueError):
        TL.get_loss_function(lc)
