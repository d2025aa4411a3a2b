"""PyTorch port: on-device augmentation (``ops/augment.py``) against the JAX
package's resample functions at fixed parameters, on the CPU.

Tolerances: images <= 1e-5 abs (float32, JAX at ``highest`` precision),
labels equal; flips, shifts and inactive transforms exact."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.ops import augment as JA
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.ops import augment as TA
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

PAIRS = ((0, 1), (0, 2), (1, 2))
SHAPE = (12, 14, 16)
AUG_KEYS = ("random_flip", "random_rotation", "random_scale", "intensity_shift", "gaussian_noise")


def _volumes(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    image = rng.random(shape, dtype=np.float32)
    label = np.zeros(shape, np.float32)
    label[3:9, 4:10, 5:12] = 1.0
    label[rng.random(shape) < 0.05] = 1.0
    return image, label


CASES = [(a, p, s) for a, p, s in itertools.product((0.0, 0.21, -0.26), range(3), (1.0, 0.93, 1.08))]


@pytest.mark.parametrize("separable", [True, False])
def test_resample_matches_jax(separable):
    image, label = _volumes(0)
    jax_fn = jax.jit(JA._affine_resample_separable if separable else JA._affine_resample,
                     static_argnums=(5,))
    torch_fn = TA.affine_resample_separable if separable else TA.affine_resample
    # the whole parameter grid as one batch (per-sample plane selection)
    n = len(CASES)
    angle = torch.tensor([c[0] for c in CASES], dtype=torch.float32)
    pair = torch.tensor([c[1] for c in CASES])
    scale = torch.tensor([c[2] for c in CASES], dtype=torch.float32)
    img_t, lbl_t = torch_fn(torch.from_numpy(image).expand(n, *SHAPE),
                            torch.from_numpy(label).expand(n, *SHAPE), angle, pair, scale, PAIRS)
    for i, (a, p, s) in enumerate(CASES):
        img_j, lbl_j = jax_fn(jnp.asarray(image), jnp.asarray(label), jnp.float32(a),
                              jnp.int32(p), jnp.float32(s), PAIRS)
        assert np.abs(img_t[i].numpy() - np.asarray(img_j)).max() <= 1e-5, (a, p, s)
        np.testing.assert_array_equal(lbl_t[i].numpy(), np.asarray(lbl_j), err_msg=str((a, p, s)))
        if a == 0.0 and s == 1.0:  # inactive: exact identity
            assert torch.equal(img_t[i], torch.from_numpy(image))
            assert torch.equal(lbl_t[i], torch.from_numpy(label))


def test_separable_equals_map_coordinates_form():
    image, label = _volumes(1)
    n = len(CASES)
    args = (torch.from_numpy(image).expand(n, *SHAPE), torch.from_numpy(label).expand(n, *SHAPE),
            torch.tensor([c[0] for c in CASES]), torch.tensor([c[1] for c in CASES]),
            torch.tensor([c[2] for c in CASES]), PAIRS)
    img_s, lbl_s = TA.affine_resample_separable(*args)
    img_m, lbl_m = TA.affine_resample(*args)
    assert (img_s - img_m).abs().max() <= 1e-5
    assert (lbl_s != lbl_m).float().mean() <= 1e-3  # round-half rule differs (even vs away)


def _cfg(**enabled):
    cfg = Config().augmentation
    for k in AUG_KEYS:
        getattr(cfg, k)["enabled"] = enabled.get(k, False)
    return cfg


def _batch(seed, b=4):
    image, label = _volumes(seed)
    imgs = torch.from_numpy(np.stack([np.roll(image, i, 0) for i in range(b)]))[..., None]
    lbls = torch.from_numpy(np.stack([np.roll(label, i, 0) for i in range(b)]))[..., None]
    return imgs, lbls


def test_disabled_augmentation_is_identity():
    imgs, lbls = _batch(2)
    fn = TA.make_augment_fn(_cfg(), SHAPE, separable=True)
    out_i, out_l = fn(torch.Generator().manual_seed(0), imgs, lbls)
    assert torch.equal(out_i, imgs) and torch.equal(out_l, lbls)


def test_flips_are_exact_and_drawn_per_sample():
    imgs, lbls = _batch(3, b=16)
    cfg = _cfg(random_flip=True)
    cfg.random_flip["prob"] = 0.5
    out_i, out_l = TA.make_augment_fn(cfg, SHAPE)(torch.Generator().manual_seed(1), imgs, lbls)
    kinds = set()
    for b in range(16):
        for kind, (fi, fl) in enumerate([(imgs[b], lbls[b])] + [
                (imgs[b].flip(ax), lbls[b].flip(ax)) for ax in range(3)]):
            if torch.equal(out_i[b], fi):
                assert torch.equal(out_l[b], fl)
                kinds.add(kind)
                break
        else:
            raise AssertionError(f"sample {b} is neither flipped nor kept")
    assert len(kinds) >= 3  # both outcomes, more than one axis


def test_shift_and_noise_clip_and_determinism():
    imgs, lbls = _batch(4, b=8)
    cfg = _cfg(intensity_shift=True, gaussian_noise=True)
    cfg.intensity_shift["prob"] = 1.0
    cfg.gaussian_noise["prob"] = 0.0
    fn = TA.make_augment_fn(cfg, SHAPE)
    out_i, out_l = fn(torch.Generator().manual_seed(5), imgs, lbls)
    assert torch.equal(out_l, lbls)
    shift = (out_i - imgs)[..., 0]
    inner = (imgs[..., 0] > 0.2) & (imgs[..., 0] < 0.8)
    for b in range(8):  # one constant shift per sample, exact where unclipped
        s = shift[b][inner[b]]
        assert s.abs().max() <= 0.1 + 1e-6 and torch.allclose(s, s[0].expand_as(s), atol=1e-6)
    assert out_i.min() >= 0.0 and out_i.max() <= 1.0
    again, _ = fn(torch.Generator().manual_seed(5), imgs, lbls)
    assert torch.equal(out_i, again)


def test_full_augmentation_keeps_shapes_and_ranges():
    imgs, lbls = _batch(5)
    fn = TA.make_augment_fn(_cfg(**{k: True for k in AUG_KEYS}), SHAPE, separable=True)
    out_i, out_l = fn(torch.Generator().manual_seed(2), imgs, lbls)
    assert out_i.shape == imgs.shape and out_l.shape == lbls.shape
    assert torch.isfinite(out_i).all() and out_i.min() >= 0.0 and out_i.max() <= 1.0
    assert set(torch.unique(out_l).tolist()) <= {0.0, 1.0}
