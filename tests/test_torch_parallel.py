"""PyTorch port, multi-GPU pieces on 2 and 4 gloo ranks on the CPU, held
against the JAX package's sharded functions on as many of the 8 virtual
CPU devices (``tests/conftest.py``): the process-group entry, the mesh
rules, ``ppermute`` with its wrap-around pairs, the patch- and slab-sharded
sliding windows (float32, <= 1e-5 abs; the mask's zeros exact), the
case-sharded gather (bit for bit) and a data-parallel gradient and guarded
AdamW step (``tests/unit/test_parallel.py:52-99``'s setup).

Each world size is one spawn of N ranks (``tests/torch_parallel_ranks.py``);
the tests read what the ranks saved."""

import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from light_unet_tpu.config import TpuConfig as JaxTpuConfig
from light_unet_tpu.core.trainer import _guarded_apply
from light_unet_tpu.datasets import device_corpus as jdc
from light_unet_tpu.models.losses import focal_tversky_loss
from light_unet_tpu.models.unet3d import Lightweight3DUNet as JaxUNet
from light_unet_tpu.ops import sliding_window as jsw
from light_unet_tpu.ops.gaussian import gaussian_importance_map
from light_unet_tpu.parallel import mesh as jmesh
from light_unet_tpu_torch.config import TpuConfig
from light_unet_tpu_torch.models.unet3d import Lightweight3DUNet
from light_unet_tpu_torch.ops import sliding_window as sw
from light_unet_tpu_torch.parallel import distributed
from light_unet_tpu_torch.parallel import mesh as tmesh
from light_unet_tpu_torch.parallel.collectives import psum_scatter
from light_unet_tpu_torch.tools.weights import from_jax_params
from tests import torch_parallel_ranks as ranks
from tests.torch_parity import one_torch_thread, random_params  # noqa: F401 (fixture)

PATCH = ranks.PATCH
VOL = (20, 24, 50)  # z buckets to 64: slabs of 32 (2 ranks) and 16 (4 ranks)
N_CASES = 5


def _flat(state: dict) -> np.ndarray:
    """A flax tree as the port model's parameters, flattened in their order."""
    model = Lightweight3DUNet(encoder_channels=ranks.ENC, dropout_p=0.0)
    model.load_state_dict(from_jax_params(state), strict=True)
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def _dp_batch() -> dict:
    """The data-parallel step's global batch of 8 (``test_parallel.py``'s shapes)."""
    rng = np.random.default_rng(11)
    return {"dp_x": rng.random((8, 8, 8, 8, 1)).astype(np.float32),
            "dp_y": (rng.random((8, 8, 8, 8, 1)) > 0.8).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_side():
    model = JaxUNet(encoder_channels=ranks.ENC, dropout_p=0.0)
    return {
        "model": model,
        "window": random_params(model, (1, *PATCH, 1), seed=3),
        "dp": random_params(model, (1, 8, 8, 8, 1), seed=4),
        "fwd": jax.jit(lambda p, x: model.apply(p, x)),
    }


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def world(request, tmp_path_factory, jax_side):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"parallel{n}")
    rng = np.random.default_rng(7)
    vol = rng.random(VOL, dtype=np.float32)
    body = (rng.random(VOL) > 0.3).astype(np.float32)
    pvol = np.zeros(jsw.bucketed_shape(VOL, PATCH, 16), np.float32)
    pvol[: VOL[0], : VOL[1], : VOL[2]] = vol
    positions = jsw.compute_positions(VOL, PATCH, 0.5)
    n_real = positions.shape[0]
    chunk, tail, per_pad = jsw.choose_chunks(-(-n_real // n), 8)
    pos = np.zeros((per_pad * n, 3), np.int32)
    pos[:n_real] = positions
    mask = np.zeros((per_pad * n,), np.float32)
    mask[:n_real] = 1.0
    rows = -(-N_CASES // n) * n  # padded to a multiple of the ranks
    corpus_img = np.zeros((rows, 24, 24, 24), np.uint16)
    corpus_lbl = np.zeros((rows, 24, 24, 24), np.uint8)
    corpus_img[:N_CASES] = (rng.random((N_CASES, 24, 24, 24)) * 65535).astype(np.uint16)
    corpus_lbl[:N_CASES] = rng.random((N_CASES, 24, 24, 24)) > 0.8
    corners = np.stack([rng.integers(0, N_CASES, 8)] + [rng.integers(0, 9, 8) for _ in range(3)],
                       axis=1).astype(np.int32)
    inputs = dict(
        vol=vol, body=body, pvol=pvol, pos=pos, mask=mask, n_real=n_real, chunk=chunk, tail=tail,
        imp=gaussian_importance_map(PATCH), corpus_img=corpus_img, corpus_lbl=corpus_lbl,
        corners=corners, **_dp_batch())
    np.savez(tmp / "inputs.npz", **inputs)
    torch.save(from_jax_params(jax_side["window"]), tmp / "window_model.pt")
    torch.save(from_jax_params(jax_side["dp"]), tmp / "dp_model.pt")
    return {"n": n, "inputs": inputs, "ranks": ranks.spawn("parallel", n, tmp),
            "mesh": jmesh.create_mesh(devices=jax.devices()[:n])}


def test_process_group_entry_and_ppermute(world):
    """``maybe_distributed_init`` from the four ``tpu:`` fields (a ``file://``
    coordinator), idempotent; ``ppermute`` with the wrap-around pairs of the
    slab halo (rank i sends to i - 1 mod n)."""
    n = world["n"]
    for r, got in enumerate(world["ranks"]):
        assert got["init"].tolist() == [True, True, True]
        assert got["world"].tolist() == [n, r] and str(got["backend"]) == "gloo"
        np.testing.assert_array_equal(got["ppermute"], np.full(3, (r + 1) % n, np.float32))


def test_patch_sharded_core_matches_jax(world, jax_side):
    inp, mesh = world["inputs"], world["mesh"]
    core = jax.jit(partial(jsw.sliding_window_core_sharded, apply_fn=jax_side["fwd"],
                           patch_size=PATCH, chunk=int(inp["chunk"]), mesh=mesh,
                           data_axis="data", tail_chunk=int(inp["tail"])))
    want = np.asarray(core(jax_side["window"], jnp.asarray(inp["pvol"]), jnp.asarray(inp["pos"]),
                           jnp.asarray(inp["mask"]), jnp.asarray(inp["imp"])))
    for got in world["ranks"]:  # psum: every rank holds the whole map
        assert np.abs(got["core"] - want).max() <= 1e-5


@pytest.mark.parametrize("transfer", ["float32", "uint16"])
def test_slab_sharded_window_matches_jax(world, jax_side, transfer):
    """Slab mode end to end (prepare, halo exchange, spill, gather to rank
    0): the map within 1e-5 of JAX's, exactly 0 outside the mask; the other
    ranks get no map; the patch-sharded engine gives the same map."""
    inp, n = world["inputs"], world["n"]
    engine = jsw.SlidingWindowInferencer(
        jax_side["fwd"], PATCH, patch_batch=8, z_bucket=16, mesh=world["mesh"],
        transfer_dtype=transfer, fetch_dtype="float32", spatial_shard=True)
    want = engine(jax_side["window"], inp["vol"], post_mask=inp["body"])
    key = "slab_f32" if transfer == "float32" else "slab_u16"
    root = world["ranks"][0]
    assert int(root[f"{key}_slab"]) == 64 // n and root[key].shape == VOL
    assert np.abs(root[key] - want).max() <= 1e-5
    assert (root[key][inp["body"] == 0] == 0).all() and (want[inp["body"] == 0] == 0).all()
    assert all(key not in got for got in world["ranks"][1:])
    assert np.abs(root["patch_f32"] - root["slab_f32"]).max() <= 1e-5
    # a slab narrower than a patch warns and takes the patch-sharded path
    assert n == 2 or (bool(root["thin_warned"]) and int(root["thin_slab"]) == 0)


def test_gather_patches_sharded_bit_identical(world):
    inp, mesh = world["inputs"], world["mesh"]
    place = NamedSharding(mesh, P("data"))
    gather = jax.jit(partial(jdc.gather_patches_sharded, mesh=mesh), static_argnums=(3,))
    gi, gl = gather(jax.device_put(inp["corpus_img"], place),
                    jax.device_put(inp["corpus_lbl"], place),
                    jax.device_put(inp["corners"], NamedSharding(mesh, P())), PATCH)
    got_img = np.concatenate([r["gather_img"] for r in world["ranks"]])
    got_lbl = np.concatenate([r["gather_lbl"] for r in world["ranks"]])
    np.testing.assert_array_equal(got_img, np.asarray(gi))
    np.testing.assert_array_equal(got_lbl, np.asarray(gl))
    assert all(bool(r["gather_equal"]) for r in world["ranks"])  # == the replicated gather
    assert world["ranks"][0]["gather_img"].shape[0] == 8 // world["n"]


@pytest.fixture(scope="module")
def jax_dp_step(jax_side):
    """JAX's loss, gradient and guarded AdamW step on the whole batch 8 of
    the ranks' inputs (``tests/unit/test_parallel.py`` holds the sharded
    gradient equal to this one), compiled once for both world sizes."""
    x, y = _dp_batch().values()
    model = jax_side["model"]
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=1e-3, weight_decay=1e-5)

    @jax.jit
    def step(params, x, y):
        loss, grads = jax.value_and_grad(lambda p: focal_tversky_loss(model.apply(p, x), y))(params)
        new, _, ok = _guarded_apply(tx, params, tx.init(params), grads, loss)
        return loss, grads, new, ok

    loss, grads, new, ok = jax.device_get(step(jax_side["dp"], x, y))
    return {"x": x, "loss": float(loss), "grads": _flat(grads), "params": _flat(new), "ok": float(ok)}


def test_data_parallel_grad_and_guarded_step_match_jax(world, jax_dp_step):
    """A global focal Tversky loss over the ranks' rows: the summed gradients
    within 1e-5 of JAX's, the guarded AdamW step as optax's, and the
    parameters bit-identical across ranks."""
    want = jax_dp_step
    np.testing.assert_array_equal(world["inputs"]["dp_x"], want["x"])
    for got in world["ranks"]:
        assert abs(float(got["dp_loss"]) - want["loss"]) <= 1e-6
        assert np.abs(got["dp_grads"] - want["grads"]).max() <= 1e-5
        assert float(got["dp_ok"]) == want["ok"] == 1.0
        # Adam's first step is lr * g / (|g| + eps): stable wherever |g| >> eps
        big = np.abs(want["grads"]) > 1e-6
        assert np.abs(got["dp_params"] - want["params"])[big].max() <= 1e-6
        assert np.abs(got["dp_params"] - want["params"]).max() <= 2e-3 + 1e-6
        np.testing.assert_array_equal(got["dp_params"], world["ranks"][0]["dp_params"])


def test_mesh_rules_on_ranks(world):
    """``batch_per_device`` keeps every rank (global batch 2 x n); a
    ``mesh_shape`` larger than the world raises JAX's ``ValueError``; a batch
    the world does not divide warns and parks the ranks left out, which
    leave cleanly once the others finish."""
    n = world["n"]
    small = 1 if n == 2 else 2  # batch 3 on 2 ranks, batch 2 on 4
    for r, got in enumerate(world["ranks"]):
        assert got["bpd"].tolist() == [n, 2 * n]
        assert str(got["too_big"]) == f"mesh_shape [{n + 1}] needs {n + 1} devices, have {n}"
        if r < small:
            assert bool(got["small_warned"]) and int(got["small_size"]) == small
            assert "parked" not in got
            if small > 1:
                np.testing.assert_array_equal(got["small_psum"], [small, small])
        else:
            assert bool(got["parked"]) and "small_size" not in got


def test_a_batch_the_mesh_does_not_divide_raises_as_in_jax():
    """JAX refuses to place a batch of 4 on a 3-device data mesh; the
    port's shard of it and ``psum_scatter`` of 4 rows over 3 ranks raise
    ``ValueError`` too, where a floor division would drop a row."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = jmesh.create_mesh(mesh_shape=[3])
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((4, 2), np.float32), NamedSharding(jm, P("data")))
    tm = tmesh.Mesh((0, 1, 2), 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="a global batch of 4 does not split over the 3 ranks"):
        tmesh.shard_batch(np.zeros((4, 2)), tm)
    with pytest.raises(ValueError, match="4 rows do not split over 3 ranks"):
        psum_scatter(torch.zeros(4, 2), tm)
    assert tmesh.shard_batch(np.arange(6), tm).tolist() == [2, 3]
    assert tmesh.shard_chain(np.zeros((2, 6, 4)), tm).shape == (2, 2, 4)


def test_partition_positions_slab_matches_jax():
    for shape, n_dev, pb in [((20, 24, 50), 2, 8), ((20, 24, 50), 4, 8), ((48, 40, 130), 3, 32),
                             ((16, 16, 200), 4, 192)]:
        pos = jsw.compute_positions(shape, PATCH, 0.5)
        slab = jsw._round_up(jsw.bucketed_shape(shape, PATCH, 16)[2], n_dev) // n_dev
        got = sw.partition_positions_slab(pos, n_dev, slab, pb)
        want = jsw.partition_positions_slab(pos, n_dev, slab, pb)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_mesh_rules_match_jax():
    """The rank count ``mesh_from_config`` keeps (and its warning) for every
    batch size on 8 ranks, ``effective_batch_size``, and ``create_mesh``'s
    error and subset warning, against JAX on its 8 virtual devices."""
    for bpd in (False, True):
        for batch in range(1, 17):
            jcfg, tcfg = JaxTpuConfig(batch_per_device=bpd), TpuConfig(batch_per_device=bpd)
            with warnings.catch_warnings(record=True) as jw:
                warnings.simplefilter("always")
                jm = jmesh.mesh_from_config(jcfg, batch_size=batch)
            with warnings.catch_warnings(record=True) as tw:
                warnings.simplefilter("always")
                n = tmesh.planned_size(tcfg, 8, batch)
            assert n == (1 if jm is None else int(np.prod(jm.devices.shape))), (bpd, batch)
            assert [str(w.message) for w in tw] == [str(w.message) for w in jw], (bpd, batch)
            tm = None if n == 1 else tmesh.Mesh(tuple(range(n)), 0, torch.device("cpu"))
            assert tmesh.effective_batch_size(tcfg, batch, tm) == jmesh.effective_batch_size(
                jcfg, batch, jm)
    with pytest.raises(ValueError) as jerr:
        jmesh.create_mesh(mesh_shape=[9])
    with pytest.raises(ValueError) as terr:
        tmesh.create_mesh(ranks=range(8), mesh_shape=[9], device="cpu")
    assert str(terr.value) == str(jerr.value)
    with pytest.warns(UserWarning, match=r"uses only 2 of 8 available devices \(6 idle\)"):
        assert tmesh.create_mesh(ranks=range(8), mesh_shape=[2], device="cpu").size == 2
    # one process: mesh_shape [2] raises as JAX does with one device
    with pytest.raises(ValueError, match=r"mesh_shape \[2\] needs 2 devices, have 1"):
        tmesh.mesh_from_config(TpuConfig(mesh_shape=[2]), device="cpu")
    assert tmesh.mesh_from_config(TpuConfig(), batch_size=2, device="cpu") is None


def test_init_args_from_config_and_torchrun_env():
    cfg = TpuConfig(distributed=True, coordinator_address="10.0.0.1:1234", num_processes=4,
                    process_id=2)
    assert distributed.init_args(cfg, env={}) == ("tcp://10.0.0.1:1234", 4, 2)
    assert distributed.init_args(TpuConfig(distributed=True, coordinator_address="file:///x/y",
                                           num_processes=2, process_id=0), env={})[0] == "file:///x/y"
    env = {"MASTER_ADDR": "host", "MASTER_PORT": "29500", "WORLD_SIZE": "8", "RANK": "5",
           "LOCAL_RANK": "1"}
    assert distributed.init_args(TpuConfig(distributed=True), env=env) == ("tcp://host:29500", 8, 5)
    assert distributed.local_rank(5, env=env) == 1
    with pytest.raises(ValueError, match="coordinator_address"):
        distributed.init_args(TpuConfig(distributed=True), env={})
    with pytest.raises(ValueError, match="num_processes"):
        distributed.init_args(TpuConfig(distributed=True, coordinator_address="h:1"), env={})
    assert not distributed.wants_distributed(TpuConfig())
    assert distributed.wants_distributed(TpuConfig(num_processes=2))
    assert distributed.maybe_distributed_init(TpuConfig(), "cpu") is False
    assert not distributed.is_distributed_initialized()
