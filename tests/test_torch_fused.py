"""PyTorch port: the fused per-volume pipeline (raw volume -> body-masked
probability map), held against the JAX package's ``FusedVolumePipeline`` on
the CPU with the same bridged weights of a narrow U-Net, float32, TF32 off."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.ops.fused import FusedVolumePipeline as JaxPipeline
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.ops import body_mask, fused, intensity, sliding_window
from light_unet_tpu_torch.ops.sparse_fetch import SparsePack
from light_unet_tpu_torch.tools.weights import from_jax_params
from tests.synthetic import make_phantom
from tests.torch_parity import random_params

SHAPE = (24, 24, 30)
CFG = {
    "data": {"patch_size": [16, 16, 16], "body_mask": {"closing_voxels": 2}},
    "model": {"encoder_channels": [4, 8, 16, 32]},
    "tpu": {"z_bucket": 16, "sparse_fetch": False},
}
PATCH_BATCH = 8
# port vs JAX, per (transfer, fetch): f32 sums in another order (1e-5); a
# uint16 upload moves the input by up to (hi - lo) / 65535 / 2, which the
# network maps to <= 1e-3 (tests/unit/test_fused.py:103); a uint16 fetch
# adds one level at most
BARS = {("float32", "float32"): 1e-5, ("float32", "uint16"): 1e-5 + 1.0 / 65535,
        ("uint16", "float32"): 1e-3, ("uint16", "uint16"): 1e-3}


def _config(cls, **tpu):
    cfg = cls.from_dict(CFG)
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


@pytest.fixture(scope="module")
def nets():
    """(JAX apply_fn, params, port model) with the same seeded weights."""
    mc = JaxConfig.from_dict(CFG).model
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    params = random_params(jmodel, (1, 16, 16, 16, 1), seed=4, train=False)
    model = build_model(Config.from_dict(CFG).model, torch.float32, inference=True).eval()
    model.load_state_dict(from_jax_params(params), strict=True)
    return (lambda p, x: jmodel.apply(p, x, train=False)), params, model


@pytest.fixture(scope="module")
def volume():
    img, _ = make_phantom(np.random.default_rng(8), shape=SHAPE, n_lesions=2)
    return img


@pytest.fixture(scope="module")
def jax_maps(nets, volume):
    """JAX maps per (transfer, fetch), computed once per module."""
    apply_fn, params, _ = nets
    out = {}
    for transfer, fetch in list(BARS) + [("bfloat16", "float32")]:
        pipe = JaxPipeline(apply_fn, _config(JaxConfig), patch_batch=PATCH_BATCH,
                           transfer_dtype=transfer, fetch_dtype=fetch)
        out[transfer, fetch] = pipe(params, volume)
    return out


def _port(model, **kw):
    return fused.FusedVolumePipeline(model, _config(Config, **kw.pop("tpu", {})),
                                     patch_batch=PATCH_BATCH, device="cpu", **kw)


@pytest.mark.parametrize("transfer,fetch", list(BARS), ids=[f"{t}-{f}" for t, f in BARS])
def test_fused_pipeline_matches_jax(nets, volume, jax_maps, transfer, fetch):
    got = _port(nets[2], transfer_dtype=transfer, fetch_dtype=fetch)(volume)
    want = jax_maps[transfer, fetch]
    assert got.shape == SHAPE and got.dtype == np.float32
    assert np.abs(got - want).max() <= BARS[transfer, fetch]
    np.testing.assert_array_equal(got == 0, want == 0)  # the same voxels masked away
    assert 0 < (got == 0).mean() < 1


@pytest.mark.parametrize("transfer,fetch,bar", [("uint16", "float32", 1e-3),
                                                ("float32", "uint16", 1.01 / (2 * 65535)),
                                                ("uint16", "uint16", 1e-3)], ids=str)
def test_quantized_transfers_match_f32(nets, volume, transfer, fetch, bar):
    """The bars of tests/unit/test_fused.py:82-114, inside the port."""
    ref = _port(nets[2], transfer_dtype="float32", fetch_dtype="float32")(volume)
    got = _port(nets[2], transfer_dtype=transfer, fetch_dtype=fetch)(volume)
    assert np.abs(got - ref).max() <= bar


def test_bf16_upload(nets, volume, jax_maps):
    got = _port(nets[2], transfer_dtype="bfloat16", fetch_dtype="float32")(volume)
    assert got.dtype == np.float32
    assert np.abs(got - jax_maps["bfloat16", "float32"]).max() <= 2e-2
    assert np.abs(got - jax_maps["float32", "float32"]).max() <= 2e-2


@pytest.mark.parametrize("fetch", ["float32", "uint16"])
def test_sparse_fetch_equals_dense(nets, volume, fetch):
    sparse = _port(nets[2], transfer_dtype="uint16", fetch_dtype=fetch,
                   tpu={"sparse_fetch": True})
    dispatched = sparse.dispatch(volume)
    assert isinstance(dispatched[0], SparsePack)  # no host prefetch on the CPU
    dense = _port(nets[2], transfer_dtype="uint16", fetch_dtype=fetch)(volume)
    np.testing.assert_array_equal(sparse.fetch(dispatched), dense)


def test_matches_the_stage_chain(nets, volume):
    """The one program equals normalize -> sliding window -> body mask run apart."""
    model = nets[2]
    cfg = _config(Config)
    got = _port(model, transfer_dtype="float32", fetch_dtype="float32")(volume)
    norm, _ = intensity.clip_and_normalize(volume, z_bucket=16, device="cpu")
    mask, _ = body_mask.generate_body_mask(norm, cfg.data.body_mask, z_bucket=16, device="cpu")
    sw = sliding_window.SlidingWindowInferencer(model, (16, 16, 16), patch_batch=PATCH_BATCH,
                                                z_bucket=16, device="cpu")
    want = sw.fetch(sw.dispatch(sw.prepare(norm))) * mask
    assert np.abs(got - want).max() <= 1e-6


def test_async_dispatch_and_mask_off(nets, volume):
    pipe = _port(nets[2])
    assert pipe.transfer_dtype == "uint16"  # the config default
    first, second = pipe.dispatch(volume), pipe.dispatch(pipe.prepare(volume[::-1].copy()))
    r1, r2 = pipe.fetch(first), pipe.fetch(second)
    assert r1.shape == r2.shape == SHAPE and not np.array_equal(r1, r2)
    cfg = _config(Config)
    cfg.data.body_mask.apply_to_inference = False
    unmasked = fused.FusedVolumePipeline(nets[2], cfg, patch_batch=PATCH_BATCH, device="cpu")
    assert (unmasked(volume) > 0).all()


def test_normalize_volume_dequantizes_into_the_clip_range():
    """uint16 levels map to lo + level * (hi - lo) / 65535 in float32, then
    clip and rescale; the bucket padding is zero."""
    levels = np.array([[[0, 1, 32768, 65535]]], np.uint16)
    vol = torch.from_numpy(levels.view(np.int16))
    lo, hi = 0.25, 7.5
    norm, valid = fused.normalize_volume(vol, (1, 1, 3), lo, hi, range_min=0.0, range_max=1.0,
                                         dequant=True)
    deq = levels.astype(np.float32) * ((np.float32(hi) - np.float32(lo)) / np.float32(65535.0))
    deq = deq + np.float32(lo)
    want = (deq - np.float32(lo)) * (np.float32(1.0) / (np.float32(hi) - np.float32(lo)))
    want[..., 3] = 0.0
    np.testing.assert_array_equal(norm.numpy(), want)
    np.testing.assert_array_equal(valid.numpy(), [[[1, 1, 1, 0]]])
