"""PyTorch port, the per-volume units that a card runs as one CUDA graph
each (the sliding window, its patch- and slab-sharded forms, the fused
program, the preprocess pass, the candidate table, the validation sweep),
on the CPU:

* the window with device positions equals the host-position loop it
  replaced (a copy of which is kept here) bit for bit, in every flag
  combination its key covers, and the JAX package's ``_sliding_window_jit``
  within 1e-5 in float32;
* the sized compactions that replaced ``torch.nonzero`` (the sparse pack,
  the candidate table) equal the JAX package's sized ``jnp.nonzero``,
  overflow included;
* no unit makes a host sync (``HostSyncRecorder``).  The CCL is the one
  boundary: on the CPU its plain version loops until nothing changes
  (``torch.equal``), while the card's kernel reads nothing on the host.  So
  each recorded run replays the CCL labels that an unrecorded run of the
  same unit computed just before;
* each unit's key names the JAX program's static arguments.

Graphed against eager is held on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 13): the CPU has no graphs."""

import ast
import functools
import inspect
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

import light_unet_tpu.ops.components as jcomponents
import light_unet_tpu.ops.fused as jfused
import light_unet_tpu.ops.sliding_window as jsw
import light_unet_tpu.ops.val_metrics as jval
from light_unet_tpu.config import ModelConfig
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.ops import sparse_fetch as jsf
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core import inferencer as inferencer_mod
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.ops import ccl, ccl_kernel, components, fused, val_metrics
from light_unet_tpu_torch.ops import sliding_window as sw
from light_unet_tpu_torch.ops import sparse_fetch as sf
from light_unet_tpu_torch.tools.weights import from_jax_params
from light_unet_tpu_torch.utils import graphs
from tests.synthetic import make_phantom
from tests.test_torch_graphs import HostSyncRecorder
from tests.torch_parity import jit_apply, random_params

PATCH = (16, 16, 16)


def port_net(x):
    """A cheap network: a fixed pointwise map of the patch ([n, p, p, p, 1])."""
    return torch.sigmoid(x * 3.0 - 1.0)


def jax_net(params, x):
    return jax.nn.sigmoid(x * 3.0 - 1.0)


# ------------------------------------------------- the loop that was replaced


def old_parts(volume, positions, n_real, imp_map, apply_fn, patch_size, chunk, tail_chunk):
    """The window before device positions: origins read on the host, one
    ``+=`` of a slice a real window."""
    n = positions.shape[0]
    pd, ph, pw = patch_size
    dev = volume.device
    pos = torch.as_tensor(positions, dtype=torch.int64, device=dev)
    ar = [torch.arange(s, device=dev) for s in patch_size]
    patches = volume[
        (pos[:, 0, None] + ar[0])[:, :, None, None],
        (pos[:, 1, None] + ar[1])[:, None, :, None],
        (pos[:, 2, None] + ar[2])[:, None, None, :],
    ]
    n_main = n - tail_chunk
    starts = [(i, chunk) for i in range(0, n_main, chunk)]
    if tail_chunk:
        starts.append((n_main, tail_chunk))
    preds = torch.empty(patches.shape, dtype=torch.float32, device=dev)
    for i, size in starts:
        preds[i:i + size] = apply_fn(patches[i:i + size][..., None])[..., 0].float()
    weighted = preds * imp_map[None]
    prob = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    count = torch.zeros(volume.shape, dtype=torch.float32, device=dev)
    for i, (z, y, x) in enumerate(positions[:n_real].tolist()):
        prob[z:z + pd, y:y + ph, x:x + pw] += weighted[i]
        count[z:z + pd, y:y + ph, x:x + pw] += imp_map
    return prob, count


def old_window(volume, shape, vlo, vhi, positions, n_real, imp_map, apply_fn, chunk, tail,
               post_mask, mask_packed, dequant, quantize, cap):
    if dequant:
        lo, hi = np.float32(vlo), np.float32(vhi)
        v = sw._u16_to_f32(volume) * ((hi - lo) / np.float32(65535.0)) + lo
        axes = [torch.arange(s) < int(t) for s, t in zip(volume.shape, shape)]
        volume = v * (axes[0][:, None, None] & axes[1][None, :, None]
                      & axes[2][None, None, :]).float()
    prob, count = old_parts(volume, positions, n_real, imp_map, apply_fn, PATCH, chunk, tail)
    out = torch.where(count > 0, prob / torch.where(count > 0, count, 1.0), prob)
    if post_mask is not None:
        out = sw._apply_post_mask(out, post_mask, mask_packed)
    if quantize:
        out = sw.quantize_out(out)
    if not cap:
        return (out,)
    nd, nh, nw = sf.block_grid(out.shape, 8)
    pad = (0, nw * 8 - out.shape[2], 0, nh * 8 - out.shape[1], 0, nd * 8 - out.shape[0])
    v = torch.nn.functional.pad(out, pad)
    tiles = v.reshape(nd, 8, nh, 8, nw, 8).permute(0, 2, 4, 1, 3, 5).reshape(nd * nh * nw, 512)
    occupied = (tiles != 0).any(dim=1)
    idx = torch.full((cap,), nd * nh * nw, dtype=torch.int64)
    found = torch.nonzero(occupied).flatten()[:cap]
    idx[: found.numel()] = found
    tiles_all = torch.cat([tiles, tiles.new_zeros((1, 512))])
    return out, occupied.sum(dtype=torch.int32), idx.to(torch.int32), tiles_all[idx]


# ------------------------------------------------------------- the window

# (volume shape, z_bucket): byte-aligned padded z (the mask bit-packed), or not
VOLUMES = {"packed": ((24, 24, 40), 16), "unpacked": ((24, 20, 37), 1)}


def _case(which, seed=3):
    shape, z_bucket = VOLUMES[which]
    rng = np.random.default_rng(seed)
    vol = (rng.random(shape) * 4 - 0.5).astype(np.float32)
    body = (rng.random(shape) > 0.3).astype(np.float32)
    return vol, body, z_bucket


def _engine(apply_fn, z_bucket, patch_batch, dequant, quantize, sparse, **kw):
    return sw.SlidingWindowInferencer(
        apply_fn, PATCH, patch_batch=patch_batch, z_bucket=z_bucket,
        transfer_dtype="uint16" if dequant else "float32",
        fetch_dtype="uint16" if quantize else "float32", sparse_fetch=sparse,
        sparse_fetch_frac=0.5, device="cpu", **kw)


def _old_from_prep(engine, prep, apply_fn):
    chunk, tail = prep["chunks"]
    vlo, vhi = prep["vrange"].tolist()
    n_real = int(prep["weights"].sum())
    return old_window(prep["volume"], prep["shape"], vlo, vhi, prep["positions"].numpy(), n_real,
                      engine.imp_map, apply_fn, chunk, tail, prep["post_mask"],
                      prep["mask_packed"], engine.quantize_in, engine.quantize_out,
                      engine.sparse_cap(prep["volume"].shape))


def _equal(a: tuple, b: tuple) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("patch_batch", [8, 12], ids=["no_tail", "tail"])
@pytest.mark.parametrize("mask", [None, "packed", "unpacked"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32_out", "u16_out"])
@pytest.mark.parametrize("dequant", [False, True], ids=["f32_in", "u16_in"])
def test_window_equals_the_host_position_loop(dequant, quantize, sparse, mask, patch_batch):
    """Every static flag of ``_sliding_window_jit`` (dequant, quantize_out,
    sparse_cap, use_post_mask, mask_packed; chunk with and without a tail)."""
    vol, body, z_bucket = _case(mask or "packed")
    engine = _engine(port_net, z_bucket, patch_batch, dequant, quantize, sparse)
    prep = engine.prepare(vol, body if mask else None)
    assert prep["mask_packed"] == (mask == "packed")
    assert (prep["chunks"][1] > 0) == (patch_batch == 12)
    _, fn, inputs = engine.unit(prep)
    with torch.no_grad():
        got = fn(*inputs)
        want = _old_from_prep(engine, prep, port_net)
    assert _equal(got, want)


def test_window_equals_the_loop_with_a_model():
    """The same with a narrow U-Net (float32), through ``dispatch``."""
    model = build_model(Config.from_dict({"model": {"encoder_channels": [4, 8, 16, 32]}}).model,
                        torch.float32, inference=True).eval()
    vol, body, z_bucket = _case("packed", seed=9)
    engine = _engine(model, z_bucket, 12, True, False, False)
    prep = engine.prepare(vol, body)
    with torch.no_grad():
        got = sw.on_device(engine.dispatch(prep)[0])
        want = _old_from_prep(engine, prep, model)
    assert torch.equal(got, want[0])


@pytest.mark.parametrize("mask", [None, "packed"])
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("quantize", [False, True], ids=["f32_out", "u16_out"])
@pytest.mark.parametrize("dequant", [False, True], ids=["f32_in", "u16_in"])
def test_window_matches_jax(dequant, quantize, sparse, mask):
    """The unit against ``_sliding_window_jit`` on the same uploads: float32
    maps within 1e-5, uint16 levels within one, packs equal."""
    vol, body, z_bucket = _case("packed")
    engine = _engine(port_net, z_bucket, 12, dequant, quantize, sparse)
    prep = engine.prepare(vol, body if mask else None)
    _, fn, inputs = engine.unit(prep)
    with torch.no_grad():
        got = fn(*inputs)
    chunk, tail = prep["chunks"]
    cap = engine.sparse_cap(prep["volume"].shape)
    volume = prep["volume"].numpy()
    pm = prep["post_mask"].numpy() if mask else np.zeros((1, 1, 1), np.uint8)
    vlo, vhi = prep["vrange"].tolist()
    want = jsw._sliding_window_jit(
        None, jnp.asarray(volume.view(np.uint16) if dequant else volume),
        jnp.asarray(prep["dims"].numpy()), jnp.float32(vlo), jnp.float32(vhi),
        jnp.asarray(prep["positions"].numpy().astype(np.int32)),
        jnp.asarray(prep["weights"].numpy()), jnp.asarray(engine.imp_map.numpy()), jnp.asarray(pm),
        apply_fn=jax_net, patch_size=PATCH, chunk=chunk, tail_chunk=tail,
        use_post_mask=bool(mask), dequant=dequant, quantize_out=quantize, sparse_cap=cap,
        sparse_block=8, mask_packed=prep["mask_packed"])
    want = want if cap else (want,)
    out, jout = sf.to_numpy(got[0]), np.asarray(want[0])
    if quantize:
        assert np.abs(out.astype(np.int64) - jout.astype(np.int64)).max() <= 1
    else:
        assert np.abs(out - jout).max() <= 1e-5
    if cap:
        assert int(got[1]) == int(want[1])
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_window_matches_jax_with_a_model():
    """A narrow U-Net with bridged weights, float32 at ``highest``, through
    ``sliding_window_inference_3d`` (the one-shot wrapper) on both sides."""
    mc = ModelConfig()
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    params = random_params(jmodel, (1, *PATCH, 1), seed=21, train=False)
    model = build_model(mc, torch.float32, inference=True).eval()
    model.load_state_dict(from_jax_params(params), strict=True)
    vol = np.random.default_rng(4).random((24, 24, 40)).astype(np.float32)
    with torch.no_grad():
        got = sw.sliding_window_inference_3d(vol, model, PATCH, patch_batch=12, z_bucket=16,
                                             device="cpu")
    want = jsw.sliding_window_inference_3d(vol, jit_apply(jmodel), params, PATCH,
                                           patch_batch=12, z_bucket=16)
    assert got.shape == vol.shape and np.abs(got - np.asarray(want)).max() <= 1e-5


def test_uniform_weights_match_jax():
    vol = np.random.default_rng(6).random((20, 24, 30)).astype(np.float32)
    got = sw.sliding_window_inference_3d(vol, port_net, PATCH, use_gaussian=False, patch_batch=8,
                                         z_bucket=16, device="cpu")
    want = jsw.sliding_window_inference_3d(vol, jax_net, None, PATCH, use_gaussian=False,
                                           patch_batch=8, z_bucket=16)
    assert np.abs(got - np.asarray(want)).max() <= 1e-5


# ------------------------------------------------- sized compactions


@pytest.mark.parametrize("cap", [64, 16, 1])
def test_pack_blocks_overflow_matches_jax(cap):
    """``count > cap``: the first ``cap`` occupied tiles in flat order, as the
    JAX package's sized nonzero gives them."""
    vol = np.random.default_rng(7).random((24, 24, 40)).astype(np.float32)
    vol[:, :, :12] = 0
    count, idx, tiles = sf.pack_blocks(torch.from_numpy(vol), 8, cap)
    jcount, jidx, jtiles = jsf.pack_blocks(jnp.asarray(vol), 8, cap)
    assert int(count) == int(jcount) == 36 and (int(count) > cap) == (cap < 36)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(tiles.numpy(), np.asarray(jtiles))


@pytest.mark.parametrize("n_flags", [0, 5, 300])
def test_sized_nonzero_is_jax_nonzero(n_flags):
    rng = np.random.default_rng(n_flags)
    flags = np.zeros(400, bool)
    flags[rng.choice(400, n_flags, replace=False)] = True
    got = sf.sized_nonzero(torch.from_numpy(flags), 64).numpy()
    want = np.asarray(jnp.nonzero(jnp.asarray(flags), size=64, fill_value=400)[0])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_spots", [30, 64, 65, 150])
def test_component_table_matches_jax_past_the_cap(n_spots):
    """More components than ``max_components``: the first 64 seeds' rows
    and the exact count equal the JAX package's table bit for bit."""
    rng = np.random.default_rng(n_spots)
    prob = np.zeros((30, 33, 36), np.float32)
    cells = rng.choice(10 * 11 * 12, n_spots, replace=False)
    for c in cells:  # isolated spots of 1 or 2 voxels on a grid of stride 3
        z, y, x = np.unravel_index(c, (10, 11, 12))
        prob[3 * z, 3 * y, 3 * x: 3 * x + 1 + (c % 2)] = 0.4 + 0.5 * rng.random()
    table, n = components.component_table_device(torch.from_numpy(prob), 0.3)
    jtable, jn = jcomponents.component_table_device(jnp.asarray(prob), jnp.float32(0.3))
    assert int(n) == int(jn) == n_spots
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))


def test_center_of_mass_matches_jax_and_scipy():
    mask = (np.random.default_rng(8).random((20, 22, 18)) > 0.85).astype(np.int32)
    labeled, n = ndimage.label(mask)
    got = components.center_of_mass_device(torch.from_numpy(mask), torch.from_numpy(labeled), n)
    want = jcomponents.center_of_mass_device(jnp.asarray(mask), jnp.asarray(labeled), n)
    assert got.shape == (n, 3) and np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
    scipy = np.array(ndimage.center_of_mass(mask.astype(np.float32), labeled,
                                            index=np.arange(1, n + 1)))
    np.testing.assert_allclose(got.numpy(), scipy, atol=1e-4)


def test_ops_reexports_match_jax():
    import light_unet_tpu.ops as jops
    import light_unet_tpu_torch.ops as ops

    public = {k for k in vars(jops) if not k.startswith("_") and callable(getattr(jops, k))}
    assert public <= set(vars(ops))


# ------------------------------------------------- no host sync in a unit


def recorded(monkeypatch, run):
    """``run()`` once to take its CCL labels, then again under the recorder
    with those labels replayed in order; returns (found, output)."""
    labels = []
    real = ccl_kernel.connected_labels
    monkeypatch.setattr(ccl, "connected_labels", lambda m: labels.append(real(m)) or labels[-1])
    with torch.no_grad():
        want = run()
    replay = iter(labels)
    monkeypatch.setattr(ccl, "connected_labels", lambda m: next(replay))
    with torch.no_grad(), HostSyncRecorder() as rec:
        got = run()
    assert next(replay, None) is None
    assert _equal(got, want)
    return rec.found, got


def test_window_units_make_no_host_sync(monkeypatch):
    vol, body, z_bucket = _case("packed")
    engine = _engine(port_net, z_bucket, 12, True, True, True)
    _, fn, inputs = engine.unit(engine.prepare(vol, body))
    found, out = recorded(monkeypatch, lambda: fn(*inputs))
    assert found == [] and len(out) == 4


def _fused_cfg(**tpu):
    return Config.from_dict({
        "data": {"patch_size": list(PATCH), "body_mask": {"closing_voxels": 2}},
        "tpu": {"z_bucket": 16, "transfer_dtype": "uint16", "fetch_dtype": "uint16",
                "sparse_fetch": True, **tpu}})


def test_fused_unit_makes_no_host_sync(monkeypatch):
    img, _ = make_phantom(np.random.default_rng(8), shape=(24, 24, 30), n_lesions=2)
    pipe = fused.FusedVolumePipeline(port_net, _fused_cfg(), patch_batch=12, device="cpu")
    _, fn, inputs = pipe.unit(pipe.prepare(img))
    found, out = recorded(monkeypatch, lambda: fn(*inputs))
    assert found == [] and len(out) == 4


def test_preprocess_unit_makes_no_host_sync(monkeypatch):
    img, _ = make_phantom(np.random.default_rng(9), shape=(24, 24, 30), n_lesions=2)
    cfg = _fused_cfg()
    prep = fused.prepare_preprocess(img, cfg.data.intensity, 16, "cpu")
    found, (norm, mask, counts) = recorded(
        monkeypatch, lambda: fused.dispatch_preprocess(prep, cfg.data.intensity, cfg.data.body_mask))
    assert found == [] and counts.shape == (4,) and mask.shape == norm.shape == (24, 24, 32)


def test_table_and_sweep_units_make_no_host_sync(monkeypatch):
    prob = np.zeros((20, 22, 24), np.float32)
    prob[2:6, 3:7, 4:9] = 0.8
    prob[12:14, 10:15, 16:20] = 0.45
    levels = torch.from_numpy(np.round(prob * 65535).astype(np.uint16).view(np.int16))
    thr = torch.full((), 0.3)
    found, (table, n) = recorded(
        monkeypatch, lambda: inferencer_mod.table_unit(levels, thr, max_components=64))
    assert found == [] and int(n) == 2
    vs = val_metrics.DeviceValidationSweep([0.3, 0.5, 0.7], device="cpu")
    gt = torch.from_numpy((prob > 0.5).astype(np.uint8))
    found, (tables, inters, counts) = recorded(monkeypatch, lambda: vs.tables(levels, gt))
    assert found == [] and counts.tolist() == [2, 1, 1]


# ------------------------------------------------- keys


def jax_static_argnames() -> dict:
    """Each JAX program's static argument names, read from the sources:
    ``@partial(jax.jit, static_argnames=...)`` on a function, or
    ``jax.jit(fn, static_argnames=...)`` of a nested one."""
    out = {}
    for mod in (jsw, jfused, jcomponents, jval):
        for node in ast.walk(ast.parse(inspect.getsource(mod))):
            if isinstance(node, ast.FunctionDef):
                for dec in node.decorator_list:
                    for kw in getattr(dec, "keywords", []):
                        if kw.arg == "static_argnames":
                            out[node.name] = set(ast.literal_eval(kw.value))
            elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Name):
                for kw in node.keywords:
                    if kw.arg == "static_argnames":
                        out[node.args[0].id] = set(ast.literal_eval(kw.value))
    return out


def key_names(key: tuple) -> set:
    """The static argument names of a ``graphs.unit_key`` (with or without
    the input signature that ``run_unit`` appends)."""
    return {item[0] for item in key[4:] if isinstance(item[0], str)}


def _keys_of(monkeypatch, run) -> list:
    keys = []
    for mod in (sw, fused, inferencer_mod, val_metrics):
        real = mod.run_unit
        monkeypatch.setattr(mod, "run_unit", lambda runner, key, fn, *a, real=real: keys.append(
            key + (tuple((tuple(x.shape), x.dtype) for x in a),)) or real(runner, key, fn, *a))
    with torch.no_grad():
        run()
    return keys


def test_units_map_to_the_jax_programs(monkeypatch):
    """The static names of each unit's key are the JAX program's static
    arguments, less ``apply_fn`` and ``patch_size`` (one network and patch a
    runner: the key holds the network's dtype and identity)."""
    jax_names = jax_static_argnames()
    engine_level = {"apply_fn", "patch_size"}
    vol, body, z_bucket = _case("packed")
    engine = _engine(port_net, z_bucket, 12, True, True, True)
    [key] = _keys_of(monkeypatch, lambda: engine.dispatch(engine.prepare(vol, body)))
    assert key[0] == "window"
    assert key_names(key) == jax_names["_sliding_window_jit"] - engine_level

    img, _ = make_phantom(np.random.default_rng(8), shape=(24, 24, 30), n_lesions=2)
    pipe = fused.FusedVolumePipeline(port_net, _fused_cfg(), patch_batch=12, device="cpu")
    [key] = _keys_of(monkeypatch, lambda: pipe.dispatch(img))
    assert key_names(key) == jax_names["_preprocess_and_infer_jit"] - engine_level
    cfg = _fused_cfg()
    [key] = _keys_of(monkeypatch, lambda: fused.normalize_and_body_mask(
        img, cfg.data.intensity, cfg.data.body_mask, 16, "cpu"))
    assert key_names(key) == jax_names["_normalize_and_body_mask_jit"]

    prob = torch.zeros((8, 9, 10))
    [key] = _keys_of(monkeypatch, lambda: inferencer_mod.run_unit(
        None, graphs.unit_key("table", max_components=64),
        functools.partial(inferencer_mod.table_unit, max_components=64), prob, torch.full((), .5)))
    assert key_names(key) == jax_names["component_table_device"]
    vs = val_metrics.DeviceValidationSweep([0.5], device="cpu")
    [key] = _keys_of(monkeypatch, lambda: vs.tables(prob, torch.zeros((8, 9, 10), dtype=torch.uint8)))
    assert key_names(key) == jax_names["sweep_tables_device"]

    # the sharded units (a mesh of two, not run: its key and function only)
    mesh = types.SimpleNamespace(size=2, rank=0, backend="gloo", is_root=True)
    for spatial, program in ((False, "_sharded"), (True, "_slab")):
        eng = _engine(port_net, z_bucket, 12, True, True, not spatial, mesh=mesh,
                      spatial_shard=spatial)
        key, _, _ = eng.unit(eng.prepare(vol, body))
        assert key[0] == ("slab" if spatial else "sharded")
        assert key_names(key) == jax_names[program]


def test_keys_differ_by_shape_and_agree_within_a_bucket(monkeypatch):
    """Two volumes of one bucket share a key (positions, extents and ranges
    are inputs); another bucket or chunk schedule does not."""
    engine = _engine(port_net, 16, 12, True, True, True)
    rng = np.random.default_rng(0)
    keys = _keys_of(monkeypatch, lambda: [
        engine.dispatch(engine.prepare(rng.random(s).astype(np.float32)))
        for s in ((24, 24, 40), (24, 24, 35), (24, 24, 50), (24, 30, 40))])
    assert keys[0] == keys[1] and len(set(keys)) == 3


def test_cpu_has_no_graphs():
    """On the CPU every unit runs eagerly whatever ``graphs`` says."""
    for flag in (True, False):
        assert _engine(port_net, 16, 12, False, False, False, graphs=flag).graphs is None
        assert fused.FusedVolumePipeline(port_net, _fused_cfg(), graphs=flag,
                                         device="cpu").graphs is None
        assert val_metrics.DeviceValidationSweep([0.5], graphs=flag, device="cpu").graphs is None


def test_every_flag_combination_is_its_own_key(monkeypatch):
    vol, body, z_bucket = _case("packed")
    keys = set()
    for dequant, quantize, sparse in itertools.product((False, True), repeat=3):
        engine = _engine(port_net, z_bucket, 12, dequant, quantize, sparse)
        keys.add(engine.unit(engine.prepare(vol, body))[0][4:])
    assert len(keys) == 8
