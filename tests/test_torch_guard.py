"""PyTorch port: ``GuardedAdamW`` against ``optax.inject_hyperparams(
optax.adamw)`` + the JAX package's ``_guarded_apply`` on the same gradients,
and the guard's skip semantics (``tests/unit/test_train_guard.py``).

Tolerances: parameters and moments <= 1e-6 relative to the tensor's largest
entry after five float32 updates (the two frameworks' ``pow`` of the bias
correction may differ in the last bit); a skipped step leaves everything
bit-identical."""

import types

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from light_unet_tpu.core.trainer import Trainer as JaxTrainer
from light_unet_tpu.core.trainer import _guarded_apply
from light_unet_tpu_torch.core.trainer import GuardedAdamW, Trainer, _NullWriter
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

LR, WD = 1e-2, 1e-4


def _setup(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    params = [torch.nn.Parameter(torch.tensor(w)), torch.nn.Parameter(torch.tensor(b))]
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=LR, weight_decay=WD)
    jparams = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    return params, GuardedAdamW(params, LR, WD), tx, jparams, tx.init(jparams)


def _grads(rng, bad=None):
    g = [rng.standard_normal((3, 4)).astype(np.float32), rng.standard_normal(5).astype(np.float32)]
    if bad is not None:
        g[0][1, 2] = bad
    return g


def _close(a, b, rel=1e-6):
    b = np.asarray(b)
    assert np.abs(a.detach().numpy() - b).max() <= rel * max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("lr_schedule", [[LR] * 5, [LR, 2e-3, 5e-4, 5e-4, 1e-2]])
def test_adamw_matches_optax(lr_schedule):
    params, opt, tx, jparams, jstate = _setup()
    rng = np.random.default_rng(1)
    for step, lr in enumerate(lr_schedule):
        g = _grads(rng, bad=np.nan if step == 2 else None)  # step 2 is skipped
        loss = 0.5 + step
        opt.set_lr(lr)
        jstate.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        ok = opt.step([torch.tensor(x) for x in g], torch.tensor(loss))
        jparams, jstate, jok = _guarded_apply(
            tx, jparams, jstate, {"w": jnp.asarray(g[0]), "b": jnp.asarray(g[1])},
            jnp.float32(loss))
        assert float(ok) == float(jok) == (0.0 if step == 2 else 1.0)
    adam = jstate.inner_state[0]
    assert int(opt.count) == int(adam.count) == 4
    for p, k in zip(params, ("w", "b")):
        _close(p, jparams[k])
    sd = opt.state_dict()["state"]
    for i, k in enumerate(("w", "b")):
        _close(sd[i]["exp_avg"], adam.mu[k])
        _close(sd[i]["exp_avg_sq"], adam.nu[k])
        assert float(sd[i]["step"]) == 4.0


@pytest.mark.parametrize("bad, loss", [(np.nan, 0.5), (np.inf, 0.5), (None, np.inf),
                                       (None, np.nan)])
def test_nonfinite_step_skips_everything(bad, loss):
    params, opt, *_ = _setup()
    rng = np.random.default_rng(2)
    opt.step([torch.tensor(x) for x in _grads(rng)], torch.tensor(0.3))  # one real step
    before = [t.clone() for t in (opt.flat, opt.mu, opt.nu, opt.count)]
    ok = opt.step([torch.tensor(x) for x in _grads(rng, bad)], torch.tensor(loss))
    assert float(ok) == 0.0
    for new, old in zip((opt.flat, opt.mu, opt.nu, opt.count), before):
        assert torch.equal(new, old)
    ok = opt.step([torch.tensor(x) for x in _grads(rng)], torch.tensor(0.3))  # recovery
    assert float(ok) == 1.0 and int(opt.count) == 2
    assert torch.isfinite(opt.flat).all() and not torch.equal(opt.flat, before[0])


def test_params_are_views_of_the_flat_buffer():
    params, opt, *_ = _setup()
    opt.flat.add_(1.0)
    assert torch.equal(torch.cat([p.detach().reshape(-1) for p in params]), opt.flat)
    state = opt.state_dict()
    fresh_params, fresh, *_ = _setup(seed=3)
    fresh.load_state_dict(state)
    assert torch.equal(fresh.mu, opt.mu) and int(fresh.count) == int(opt.count)
    assert float(fresh.lr) == float(opt.lr)


def test_drain_skipped_counts_and_accumulates(capsys):
    fake = types.SimpleNamespace(
        _epoch_oks=[torch.tensor([1.0, 0.0, 1.0]), torch.tensor(0.0)],
        skipped_steps_total=0,
        writer=_NullWriter(),
    )
    assert Trainer._drain_skipped(fake, epoch=3) == 2
    assert fake.skipped_steps_total == 2 and fake._epoch_oks == []
    assert "skipped 2 non-finite update(s)" in capsys.readouterr().out
    assert Trainer._drain_skipped(fake, epoch=4) == 0
    jfake = types.SimpleNamespace(_epoch_oks=[jnp.asarray([1.0, 0.0, 1.0]), jnp.float32(0.0)],
                                  skipped_steps_total=0, writer=_NullWriter())
    assert JaxTrainer._drain_skipped(jfake, epoch=3) == 2


@pytest.mark.parametrize("losses", [[1.0, float("nan"), 3.0], [], [float("inf"), float("nan")],
                                    [0.25, 0.5]])
def test_finite_mean_matches_jax(losses):
    ours, theirs = Trainer._finite_mean(losses), JaxTrainer._finite_mean(losses)
    assert ours == theirs or (np.isnan(ours) and np.isnan(theirs))


def test_flatten_losses_keeps_step_order():
    got = Trainer._flatten_losses([torch.tensor(1.0), torch.tensor([2.0, 3.0]), torch.tensor(4.0)])
    assert got == [1.0, 2.0, 3.0, 4.0]
    assert Trainer._flatten_losses([]) == []
