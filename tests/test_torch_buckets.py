"""PyTorch port: a cohort of several z extents, one compile bucket each.

Three volumes of z 20, 36 and 50 with ``tpu.z_bucket`` 16 pad to z 32, 48
and 64, so every per-volume unit sees three keys.  The port's
``Inferencer``, ``FusedVolumePipeline`` and ``DeviceValidationSweep``
(eager, on the CPU) are held against the JAX package on the same inputs
with the same weights in float32: maps within 1e-4; bboxes, sweep tables
and counts equal; the padded shapes the port's units see equal to the JAX
package's ``bucketed_shape``; and serving the cohort in another order gives
the same maps, tables and boxes."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.core.checkpoint import save_checkpoint
from light_unet_tpu.core.inferencer import Inferencer as JaxInferencer
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.ops.fused import FusedVolumePipeline as JaxPipeline
from light_unet_tpu.ops.sliding_window import bucketed_shape as jax_bucketed_shape
from light_unet_tpu.ops.val_metrics import DeviceValidationSweep as JaxSweep
from light_unet_tpu.utils import nifti
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core import inferencer as inferencer_mod
from light_unet_tpu_torch.core.inferencer import Inferencer
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.ops import fused, sliding_window
from light_unet_tpu_torch.ops.intensity import pad_volume
from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
from light_unet_tpu_torch.pipeline.evaluate import _device_case_results, evaluate_case
from light_unet_tpu_torch.tools.weights import from_jax_params
from tests.synthetic import make_phantom, write_split_files
from tests.torch_parity import one_torch_thread, random_params  # noqa: F401 (fixture)

CASES = ["0001", "0002", "0003"]
SHAPES = [(24, 24, 20), (24, 24, 36), (24, 24, 50)]
Z_BUCKET = 16
PADDED = {(24, 24, 32), (24, 24, 48), (24, 24, 64)}
THRESHOLD = 0.3
THRESHOLDS = [0.1, 0.2, 0.3, 0.4, 0.5]
SPACING = (4.0, 4.0, 4.0)
CFG = {
    "data": {"patch_size": [16, 16, 16], "body_mask": {"closing_voxels": 2}},
    "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
    "tpu": {"compute_dtype": "float32", "z_bucket": Z_BUCKET, "patch_batch": 8,
            "mesh_shape": [1], "sparse_fetch": False},
}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Raw and processed volumes of three buckets, their labels and body
    masks, a split file and a checkpoint of seeded weights written by the
    JAX package."""
    tmp = tmp_path_factory.mktemp("buckets")
    rng = np.random.default_rng(11)
    data = tmp / "processed"
    for sub in ("images", "body_masks", "labels"):
        (data / sub).mkdir(parents=True)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    raws, labels = {}, {}
    for cid, shape in zip(CASES, SHAPES):
        img, label = make_phantom(rng, shape=shape, n_lesions=2)
        raws[cid], labels[cid] = img, label
        norm = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(norm, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image((norm > 0.1).astype(np.uint8), aff),
                   data / f"body_masks/{cid}.nii.gz")
        nifti.save(nifti.Nifti1Image(label.astype(np.uint8), aff), data / f"labels/{cid}.nii.gz")
    write_split_files(tmp / "splits", CASES, CASES)
    mc = JaxConfig.from_dict(CFG).model
    jmodel = jax_build_model(mc, jnp.float32, inference=True, precision="highest")
    params = random_params(jmodel, (1, 16, 16, 16, 1), seed=7, train=False)
    params["params"]["out_conv"]["bias"][:] = 1.0  # probabilities around the threshold
    ckpt = tmp / "best_model.pth"
    save_checkpoint(ckpt, {"params": params}, {"best_epoch": 1})
    model = build_model(Config.from_dict(CFG).model, torch.float32, inference=True).eval()
    model.load_state_dict(from_jax_params(params), strict=True)
    apply_fn = lambda p, x: jmodel.apply(p, x, train=False)  # noqa: E731
    return dict(tmp=tmp, data=data, ckpt=ckpt, raws=raws, labels=labels, params=params,
                jax_apply=apply_fn, model=model)


def _recording(monkeypatch, module):
    """Record (key, padded input shape) of every unit ``module`` runs."""
    seen = []
    real = module.run_unit

    def run_unit(runner, key, fn, *inputs):
        seen.append((key, tuple(inputs[0].shape)))
        return real(runner, key, fn, *inputs)

    monkeypatch.setattr(module, "run_unit", run_unit)
    return seen


def _serve(inf_cls, cohort, name, order=CASES, **kw):
    """Serve ``order`` with a new inferencer: ({case: map}, {case: bbox JSON})."""
    out = cohort["tmp"] / name
    split = cohort["tmp"] / f"{name}_list.txt"
    split.write_text("\n".join(order) + "\n")
    inf = inf_cls(CFG, cohort["ckpt"], workdir=str(out), **kw)
    result = inf.infer_split(split, cohort["data"])
    assert result["successful"] == len(order) and not result["failed"]
    maps = {c: nifti.load(out / f"inference/prob_maps/{c}_prob.nii.gz").get_fdata(np.float32)
            for c in order}
    boxes = {c: json.loads((out / f"inference/bboxes/{c}_bboxes.json").read_text())
             for c in order}
    return maps, boxes


@pytest.fixture(scope="module")
def jax_served(cohort):
    # the template comes from seeded numpy shapes, not flax's eager init
    # (~20 s on this CPU); the checkpoint's weights replace it
    from light_unet_tpu.core import inferencer as jax_inferencer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_inferencer, "init_params",
                   lambda model, rng, patch: random_params(model, (1, *patch, 1), 0, train=False))
        return _serve(JaxInferencer, cohort, "jax")


def test_inferencer_buckets_match_jax(cohort, jax_served, monkeypatch):
    window_units = _recording(monkeypatch, sliding_window)
    tables = []
    real = inferencer_mod.run_unit
    monkeypatch.setattr(inferencer_mod, "run_unit",
                        lambda *a: tables.append(real(*a)) or tables[-1])
    maps, boxes = _serve(Inferencer, cohort, "port", device="cpu")
    want_maps, want_boxes = jax_served
    n_boxes = 0
    for cid, shape in zip(CASES, SHAPES):
        assert maps[cid].shape == shape
        assert np.abs(maps[cid] - want_maps[cid]).max() <= 1e-4
        # every voxel on the same side of the threshold in both: the boxes are comparable
        np.testing.assert_array_equal(maps[cid] >= THRESHOLD, want_maps[cid] >= THRESHOLD)
        assert boxes[cid] == want_boxes[cid]
        n_boxes += boxes[cid]["num_candidates"]
    assert n_boxes > 0
    # one window unit and one candidate table per case, each at its bucket
    want = {jax_bucketed_shape(s, (16, 16, 16), Z_BUCKET) for s in SHAPES}
    assert want == PADDED
    assert {shape for _, shape in window_units} == want
    assert len({(key, shape) for key, shape in window_units}) == len(CASES)
    assert {tuple(t[0].shape) for t in tables} == {(65,) + tables[0][0].shape[1:]}


def test_serving_order_leaves_every_result_unchanged(cohort, monkeypatch):
    runs = []
    for order in (CASES, CASES[::-1], [CASES[1], CASES[2], CASES[0]]):
        tables = {}
        real = inferencer_mod.run_unit
        pending = list(order)

        def record(*a):
            out = real(*a)
            tables[pending.pop(0)] = [t.clone() for t in out]
            return out

        monkeypatch.setattr(inferencer_mod, "run_unit", record)
        runs.append(_serve(Inferencer, cohort, f"order_{len(runs)}", order, device="cpu")
                    + (tables,))
        monkeypatch.setattr(inferencer_mod, "run_unit", real)
    (maps0, boxes0, tables0), later = runs[0], runs[1:]
    for maps, boxes, tables in later:
        for cid in CASES:
            np.testing.assert_array_equal(maps[cid], maps0[cid])
            assert boxes[cid] == boxes0[cid]
            assert all(torch.equal(a, b) for a, b in zip(tables[cid], tables0[cid]))


def test_fused_pipeline_buckets_match_jax(cohort, monkeypatch):
    units = _recording(monkeypatch, fused)
    cfg = Config.from_dict(CFG)
    cfg.tpu.transfer_dtype = cfg.tpu.fetch_dtype = "float32"
    jcfg = JaxConfig.from_dict(CFG)
    port = fused.FusedVolumePipeline(cohort["model"], cfg, patch_batch=8, device="cpu")
    jax_pipe = JaxPipeline(cohort["jax_apply"], jcfg, patch_batch=8, transfer_dtype="float32",
                           fetch_dtype="float32")
    maps = {}
    for cid in CASES[::-1] + CASES:  # every bucket twice, in two orders
        got = port(cohort["raws"][cid])
        if cid in maps:
            np.testing.assert_array_equal(got, maps[cid])
            continue
        maps[cid] = got
        want = jax_pipe(cohort["params"], cohort["raws"][cid])
        assert got.shape == want.shape == cohort["raws"][cid].shape
        assert np.abs(got - np.asarray(want)).max() <= 1e-4
    assert {shape for _, shape in units} == PADDED
    assert len({u for u in units}) == len(CASES)


def test_sweep_buckets_match_jax_and_the_host_path(cohort, jax_served, monkeypatch):
    """The validation sweep of each bucket's served map (padded to the
    bucket, as ``run_evaluate`` pads it): tables and counts equal to JAX's
    sweep, counts equal to the exact host path."""
    from light_unet_tpu_torch.ops import val_metrics

    units = _recording(monkeypatch, val_metrics)
    maps, _ = jax_served
    ours, theirs = DeviceValidationSweep(THRESHOLDS, device="cpu"), JaxSweep(THRESHOLDS)
    for cid in CASES:
        label = cohort["labels"][cid]
        padded = pad_volume(maps[cid], Z_BUCKET)
        assert ours.add_case(cid, label) and theirs.add_case(cid, label)
        got = ours.case_metrics(cid, torch.from_numpy(np.ascontiguousarray(padded)), SPACING)
        want = theirs.case_metrics(cid, jnp.asarray(padded), SPACING)
        assert got is not None and got == want
        dev = _device_case_results(maps[cid], label, THRESHOLDS, SPACING,
                                   DeviceValidationSweep(THRESHOLDS, device="cpu"), Z_BUCKET)
        host = evaluate_case(cid, cohort["tmp"] / "jax/inference/prob_maps", cohort["data"],
                             THRESHOLDS, spacing=SPACING, use_device=False)
        for t in THRESHOLDS:
            assert {k: dev[t][k] for k in ("tp", "fp", "fn")} == \
                {k: host[t][k] for k in ("tp", "fp", "fn")}
            assert abs(dev[t]["dsc"] - host[t]["dsc"]) <= 1e-9
    assert {shape for _, shape in units} == PADDED
