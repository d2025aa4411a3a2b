"""PyTorch port: sliding-window pieces, the core, and block-sparse fetch,
held against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import ModelConfig
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.ops import sliding_window as jsw
from light_unet_tpu.ops import sparse_fetch as jsf
from light_unet_tpu.ops.gaussian import gaussian_importance_map as jax_gaussian
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.ops import sliding_window as sw
from light_unet_tpu_torch.ops import sparse_fetch as sf
from light_unet_tpu_torch.ops.gaussian import gaussian_importance_map
from light_unet_tpu_torch.tools.weights import from_jax_params
from tests.torch_parity import jit_apply, random_params

PATCH = (16, 16, 16)


@pytest.mark.parametrize("shape", [(24, 24, 40), (16, 16, 16), (10, 30, 20), (48, 33, 100)])
@pytest.mark.parametrize("overlap", [0.5, 0.25])
def test_positions_and_bucketed_shape(shape, overlap):
    np.testing.assert_array_equal(
        sw.compute_positions(shape, PATCH, overlap), jsw.compute_positions(shape, PATCH, overlap))
    assert sw.bucketed_shape(shape, PATCH, 16) == jsw.bucketed_shape(shape, PATCH, 16)


def test_choose_chunks_and_gaussian():
    for n in list(range(1, 70)) + [275, 300, 384, 385]:
        for pb in (8, 32, 96, 192):
            assert sw.choose_chunks(n, pb) == jsw.choose_chunks(n, pb), (n, pb)
            assert sw.choose_chunk(n, pb) == jsw.choose_chunk(n, pb)
    assert sw.choose_chunks(275, 192) == (192, 128, 320)  # the serving volume's tail chunk
    np.testing.assert_array_equal(gaussian_importance_map(PATCH), jax_gaussian(PATCH))


def test_quantize_and_post_mask(rng):
    vol = (rng.random((20, 24, 30)) * 5 - 1).astype(np.float32)
    pshape = (20, 24, 32)
    region = tuple(slice(0, s) for s in vol.shape)
    a, b = np.zeros(pshape, np.uint16), np.zeros(pshape, np.uint16)
    assert sw.quantize_u16(vol, a, region) == jsw.quantize_u16(vol, b, region)
    np.testing.assert_array_equal(a, b)
    deq = sw._dequant_volume(torch.from_numpy(a.view(np.int16)), vol.shape, vol.min(), vol.max())
    jdeq = jsw._dequant_volume(jnp.asarray(b), jnp.asarray(vol.shape, jnp.int32),
                               jnp.float32(vol.min()), jnp.float32(vol.max()))
    np.testing.assert_allclose(deq.numpy(), np.asarray(jdeq), rtol=0, atol=1e-6)

    out = rng.random(pshape).astype(np.float32)
    mask = (rng.random(pshape) > 0.4).astype(np.uint8)
    packed = np.packbits(mask, axis=2, bitorder="little")
    got = sw._apply_post_mask(torch.from_numpy(out), torch.from_numpy(packed), True)
    want = jsw._apply_post_mask(jnp.asarray(out), jnp.asarray(packed), True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sw._apply_post_mask(torch.from_numpy(out), torch.from_numpy(mask), False).numpy(),
        out * mask)
    q = sw.quantize_out(torch.from_numpy(out * 1.2 - 0.1))
    jq = jsw._finalize_output(jnp.asarray(out * 1.2 - 0.1), True, 0, 8)
    np.testing.assert_array_equal(sf.to_numpy(q), np.asarray(jq))


def test_sliding_window_core_matches_jax(rng):
    """The core (gather -> chunked forward with a tail chunk -> ordered
    scatter-add -> divide) with the same bridged 16^3 model, f32."""
    mc = ModelConfig()
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    params = random_params(jmodel, (1, *PATCH, 1), seed=11, train=False)
    model = build_model(mc, torch.float32, inference=True).eval()
    model.load_state_dict(from_jax_params(params), strict=True)

    vol = rng.random((24, 24, 40)).astype(np.float32)
    positions = jsw.compute_positions(vol.shape, PATCH, 0.5)
    n = positions.shape[0]
    chunk, tail, n_pad = jsw.choose_chunks(n, 12)
    assert (n, chunk, tail) == (16, 12, 8)  # one full chunk and a tail chunk
    pos = np.zeros((n_pad, 3), np.int32)
    pos[:n] = positions
    mask = np.zeros((n_pad,), np.float32)
    mask[:n] = 1.0
    pvol = np.zeros(jsw.bucketed_shape(vol.shape, PATCH, 16), np.float32)
    pvol[:24, :24, :40] = vol
    imp = gaussian_importance_map(PATCH)
    fwd = jit_apply(jmodel)
    want = np.asarray(jsw.sliding_window_core(
        params, jnp.asarray(pvol), jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(imp),
        fwd, PATCH, chunk, tail_chunk=tail))
    with torch.no_grad():
        got = sw.sliding_window_core(torch.from_numpy(pvol), torch.from_numpy(pos),
                                     torch.from_numpy(mask), torch.from_numpy(imp), model, PATCH,
                                     chunk, tail).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5


@pytest.mark.parametrize("dtype", [np.float32, np.uint16])
@pytest.mark.parametrize("shape", [(24, 24, 40), (17, 9, 30)])
def test_pack_blocks_bit_identical(rng, shape, dtype):
    vol = (rng.random(shape) * 60000).astype(dtype)
    vol[vol < 0.7 * vol.max()] = 0
    vol[:, :, : shape[2] // 2] = 0  # some empty tiles
    cap = sf.block_cap(shape, 8, 1.0)
    assert cap == jsf.block_cap(shape, 8, 1.0)
    t = torch.from_numpy(vol.view(np.int16) if dtype == np.uint16 else vol)
    count, idx, tiles = sf.pack_blocks(t, 8, cap)
    jcount, jidx, jtiles = jsf.pack_blocks(jnp.asarray(vol), 8, cap)
    assert int(count) == int(jcount)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(sf.to_numpy(tiles), np.asarray(jtiles))
    pack = sf.SparsePack(t, count, idx, tiles, cap=cap, block=8)
    np.testing.assert_array_equal(sf.fetch_maybe_sparse(pack), vol)


def test_sparse_fetch_overflow_falls_back_dense(rng):
    vol = rng.random((24, 24, 40)).astype(np.float32)  # every tile occupied
    cap = 64
    count, idx, tiles = sf.pack_blocks(torch.from_numpy(vol), 8, cap)
    jcount, _, _ = jsf.pack_blocks(jnp.asarray(vol), 8, cap)
    assert int(count) == int(jcount) == 45 and sf.slice_bucket(45, cap) == 64
    count, idx, tiles = sf.pack_blocks(torch.from_numpy(vol), 8, 32)
    assert int(count) > 32
    pack = sf.SparsePack(torch.from_numpy(vol), count, idx, tiles, cap=32, block=8)
    np.testing.assert_array_equal(sf.fetch_maybe_sparse(pack), vol)
    for n in (1, 64, 65, 100, 500, 4000):
        assert sf.slice_bucket(n, 10**6) == jsf.slice_bucket(n, 10**6)


def test_multi_device_raises():
    """One process: a ``mesh_shape`` of two devices raises JAX's ``ValueError``
    (``parallel/mesh.py``); ``spatial_shard`` alone builds a one-device engine."""
    from light_unet_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from light_unet_tpu_torch.config import TpuConfig
    from light_unet_tpu_torch.parallel.mesh import mesh_from_config

    with pytest.raises(ValueError) as want:
        jax_create_mesh(devices=jax.devices()[:1], mesh_shape=[2])
    with pytest.raises(ValueError) as got:
        mesh_from_config(TpuConfig(mesh_shape=[2]), device="cpu")
    assert str(got.value) == str(want.value) == "mesh_shape [2] needs 2 devices, have 1"
    engine = sw.SlidingWindowInferencer(lambda x: x, PATCH, spatial_shard=True, device="cpu")
    assert engine.mesh is None and not engine.spatial_shard


@pytest.mark.parametrize("transfer", ["float32", "uint16"])
def test_spatial_shard_on_one_device_is_a_no_op(rng, transfer):
    """``spatial_shard`` without a mesh of several devices serves the same map
    as without it, and JAX's map with the same flag (JAX treats it as a
    no-op on one device, ``light_unet_tpu/ops/sliding_window.py:508``)."""
    mc = ModelConfig()
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    params = random_params(jmodel, (1, *PATCH, 1), seed=12, train=False)
    model = build_model(mc, torch.float32, inference=True).eval()
    model.load_state_dict(from_jax_params(params), strict=True)
    vol = rng.random((20, 24, 40)).astype(np.float32)
    body = (rng.random(vol.shape) > 0.3).astype(np.float32)
    maps = []
    for shard in (False, True):
        engine = sw.SlidingWindowInferencer(model, PATCH, patch_batch=8, z_bucket=16,
                                            transfer_dtype=transfer, spatial_shard=shard,
                                            device="cpu")
        maps.append(engine.fetch(engine.dispatch(engine.prepare(vol, body))))
    np.testing.assert_array_equal(maps[0], maps[1])
    jengine = jsw.SlidingWindowInferencer(jit_apply(jmodel), PATCH, patch_batch=8, z_bucket=16,
                                          transfer_dtype=transfer, spatial_shard=True)
    assert jengine.mesh is None and not jengine.spatial_shard
    want = jengine(params, vol, post_mask=body)
    assert np.abs(maps[1] - want).max() <= 1e-5
