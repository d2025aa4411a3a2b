"""PyTorch port: intensity, morphology, largest component, body mask, the
split and preprocess stages and their CLI, held against the JAX package on
the CPU.  Masks, voxel counts and bboxes bit-identical; normalized volumes
within 1e-6 abs; split lists and metadata equal field by field apart from
timestamps."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.ops import body_mask as jbm
from light_unet_tpu.ops import ccl as jccl
from light_unet_tpu.ops import fused as jfused
from light_unet_tpu.ops import intensity as jint
from light_unet_tpu.ops import morphology as jmorph
from light_unet_tpu.pipeline.preprocess import run_preprocess as jax_run_preprocess
from light_unet_tpu.pipeline.split import split_dataset as jax_split_dataset
from light_unet_tpu.utils import nifti
from light_unet_tpu_torch import cli
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.ops import body_mask as bm
from light_unet_tpu_torch.ops import ccl
from light_unet_tpu_torch.ops import fused
from light_unet_tpu_torch.ops import intensity
from light_unet_tpu_torch.ops import morphology as morph
from light_unet_tpu_torch.pipeline.preprocess import run_preprocess
from light_unet_tpu_torch.pipeline.split import split_dataset
from tests.synthetic import build_raw_dataset, make_phantom

SHAPE = (24, 24, 30)
REPO_CONFIG = str(Path(__file__).resolve().parent.parent / "configs/unet_fl70.yaml")


@pytest.fixture
def phantom(rng):
    img, _ = make_phantom(rng, shape=SHAPE, n_lesions=2)
    return img


def _configs(closing=5):
    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.data.body_mask.closing_voxels = closing
    return jcfg, cfg


@pytest.mark.parametrize("z_bucket", [1, 16])
def test_clip_and_normalize_matches_jax(phantom, z_bucket):
    got, meta = intensity.clip_and_normalize(phantom, 0.5, 99.5, (0.0, 1.0), z_bucket=z_bucket,
                                             device="cpu")
    want, jmeta = jint.clip_and_normalize(phantom, 0.5, 99.5, (0.0, 1.0), z_bucket=z_bucket)
    assert got.shape == SHAPE and got.dtype == np.float32
    assert np.abs(got - np.asarray(want)).max() <= 1e-6
    assert meta == jmeta  # clip values equal, the schema field for field


def test_clip_normalize_flat_volume_and_range():
    """hi <= lo gives range_min everywhere; a target range other than [0, 1]."""
    vol = np.full((6, 7, 8), 3.0, np.float32)
    valid = np.ones_like(vol)
    valid[..., 6:] = 0
    for lo, hi, rng in [(3.0, 3.0, (0.2, 1.0)), (1.0, 5.0, (-1.0, 2.0))]:
        got = intensity.clip_normalize_device(torch.from_numpy(vol), torch.from_numpy(valid), lo, hi,
                                              range_min=rng[0], range_max=rng[1])
        want = jint.clip_normalize_device(jnp.asarray(vol), jnp.asarray(valid), jnp.float32(lo),
                                          jnp.float32(hi), range_min=rng[0], range_max=rng[1])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("q", [0.5, 50.0, 99.5])
def test_masked_percentile_matches_jax(rng, q):
    flat = np.full(100, np.inf, np.float32)
    flat[:77] = rng.random(77).astype(np.float32)
    got = intensity.masked_percentile(torch.from_numpy(flat), 77, q)
    want = jint.masked_percentile(jnp.asarray(flat), jnp.int32(77), q)
    assert float(got) == float(want)
    assert float(got) == pytest.approx(np.percentile(flat[:77], q), abs=1e-6)


def _random_mask(rng, shape=(12, 14, 16), density=0.3):
    return (rng.random(shape) < density).astype(np.float32)


def _valid(shape, true_z):
    v = np.zeros(shape, np.float32)
    v[..., :true_z] = 1.0
    return v


@pytest.mark.parametrize("with_valid", [False, True])
@pytest.mark.parametrize("op", ["dilation", "closing"])
@pytest.mark.parametrize("k", [1, 3])
def test_dilation_and_closing_match_jax(rng, op, with_valid, k):
    x = _random_mask(rng, density=0.15)
    valid = _valid(x.shape, 11) if with_valid else None
    if valid is not None:
        x *= valid
    tv = torch.from_numpy(valid) if with_valid else None
    jv = jnp.asarray(valid) if with_valid else None
    if op == "dilation":
        got = morph.binary_dilation(torch.from_numpy(x), k, tv)
        want = jmorph.binary_dilation(jnp.asarray(x), k, jv)
    else:
        got = morph.binary_closing(torch.from_numpy(x), k, tv)
        want = jmorph.binary_closing(jnp.asarray(x), k, jv)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_erosion_matches_jax(rng, k):
    x = _random_mask(rng, density=0.8)
    x[2:10, 3:12, 2:14] = 1.0  # a solid block that survives a few erosions
    got = morph.binary_erosion(torch.from_numpy(x), k)
    want = jmorph.binary_erosion(jnp.asarray(x), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < x.sum()


@pytest.mark.parametrize("axis", [0, 1, 2])
@pytest.mark.parametrize("delta", [1, -1, 2])
def test_neighbor_matches_jax(rng, axis, delta):
    x = rng.random((5, 6, 7)).astype(np.float32)
    got = morph._neighbor(torch.from_numpy(x), axis, delta, 0.5)
    want = jmorph._neighbor(jnp.asarray(x), axis, delta, 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("density", [0.2, 0.35, 0.6])
def test_keep_largest_component_matches_jax(rng, density):
    mask = _random_mask(rng, density=density)
    got = ccl.keep_largest_component(torch.from_numpy(mask))
    want = np.asarray(jccl.keep_largest_component(jnp.asarray(mask)))
    assert got.dtype == torch.float32 and got.sum() > 0
    np.testing.assert_array_equal(got.numpy(), want)


def test_keep_largest_component_tie_takes_the_smaller_label():
    """Two 2x2x2 cubes: the one whose max flat index + 1 (its label) is
    smaller wins, in both packages."""
    mask = np.zeros((8, 8, 8), np.float32)
    mask[5:7, 5:7, 5:7] = 1.0  # larger flat indices
    mask[1:3, 1:3, 1:3] = 1.0
    got = ccl.keep_largest_component(torch.from_numpy(mask)).numpy()
    want = np.asarray(jccl.keep_largest_component(jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    expected = np.zeros_like(mask)
    expected[1:3, 1:3, 1:3] = 1.0
    np.testing.assert_array_equal(got, expected)


def test_keep_largest_component_empty_mask():
    mask = np.zeros((6, 5, 4), np.float32)
    got = ccl.keep_largest_component(torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jccl.keep_largest_component(jnp.asarray(mask))))
    assert float(got.abs().sum()) == 0.0


@pytest.mark.parametrize("backend,jax_backend", [("host", "host"), ("device", "jax")])
def test_label_components_matches_jax(rng, backend, jax_backend):
    mask = _random_mask(rng, density=0.3)
    labels, n = ccl.label_components(mask, backend=backend, device="cpu")
    jlabels, jn = jccl.label_components(mask, backend=jax_backend)
    assert n == jn > 3 and labels.dtype == np.int32
    np.testing.assert_array_equal(labels, jlabels)
    with pytest.raises(ValueError, match="backend"):
        ccl.label_components(mask, backend="jax", device="cpu")


@pytest.mark.parametrize("closing", [2, 5])
@pytest.mark.parametrize("z_bucket", [1, 16])
def test_generate_body_mask_matches_jax(phantom, z_bucket, closing):
    jcfg, cfg = _configs(closing)
    norm, _ = jint.clip_and_normalize(phantom, 0.5, 99.5, (0.0, 1.0), z_bucket=z_bucket)
    norm = np.array(norm)
    norm[6, 6, 6] = 0.5  # a speck apart from the body, cut by the largest component
    mask, meta = bm.generate_body_mask(norm, cfg.data.body_mask, z_bucket=z_bucket, device="cpu")
    jmask, jmeta = jbm.generate_body_mask(norm, jcfg.data.body_mask, z_bucket=z_bucket)
    assert mask.dtype == bool and mask.shape == SHAPE
    np.testing.assert_array_equal(mask, jmask)
    assert meta == jmeta  # the four counts, bbox and settings
    counts = meta["voxel_counts"]
    assert counts["after_largest_component"] < counts["after_closing"] < counts["final"]


def test_generate_body_mask_takes_a_dict_and_an_empty_volume():
    settings = {"threshold": 0.5, "closing_voxels": 1, "keep_largest_component": True,
                "dilate_voxels": 1}
    empty = np.zeros((6, 6, 6), np.float32)
    mask, meta = bm.generate_body_mask(empty, settings, device="cpu")
    jmask, jmeta = jbm.generate_body_mask(empty, settings)
    np.testing.assert_array_equal(mask, jmask)
    assert meta == jmeta and meta["bbox"] == {"min": [0, 0, 0], "max": [6, 6, 6]}


@pytest.mark.parametrize("z_bucket", [1, 16])
def test_normalize_and_body_mask_matches_jax(phantom, z_bucket):
    jcfg, cfg = _configs(2)
    got = fused.normalize_and_body_mask(phantom, cfg.data.intensity, cfg.data.body_mask,
                                        z_bucket=z_bucket, device="cpu")
    want = jfused.normalize_and_body_mask(phantom, jcfg.data.intensity, jcfg.data.body_mask,
                                          z_bucket=z_bucket)
    assert np.abs(got[0] - want[0]).max() <= 1e-6
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]
    # the same pass as the two stages apart
    norm, imeta = intensity.clip_and_normalize(phantom, z_bucket=z_bucket, device="cpu")
    mask, mmeta = bm.generate_body_mask(norm, cfg.data.body_mask, z_bucket=z_bucket, device="cpu")
    np.testing.assert_array_equal(got[0], norm)
    np.testing.assert_array_equal(got[1], mask)
    assert got[2] == imeta and got[3] == mmeta


def _read_tree(root):
    return {p.name: p.read_text() for p in sorted(root.glob("*_list.txt"))}


@pytest.mark.parametrize("with_data", [True, False])
def test_split_dataset_matches_jax(tmp_path, with_data):
    raw = tmp_path / "raw"
    if with_data:
        build_raw_dataset(raw, [f"{i:04d}" for i in range(1, 12)], shape=(8, 8, 8))
    results = {}
    for name, fn in (("port", split_dataset), ("jax", jax_split_dataset)):
        out = tmp_path / name / "splits"
        manifest = fn(raw, out, 0.6, 0.2, 0.2, seed=7)
        on_disk = json.loads((out.parent / "split_manifest.json").read_text())
        assert on_disk == manifest
        manifest.pop("split_date")
        results[name] = (manifest, _read_tree(out))
    assert results["port"] == results["jax"]
    assert results["port"][0]["total_cases"] == (11 if with_data else 123)
    with pytest.raises(ValueError, match="sum to 1.0"):
        split_dataset(raw, tmp_path / "bad", 0.5, 0.2, 0.2)


def _drop_timestamps(meta):
    """``meta`` without its timestamps and wall-clock seconds, at any depth."""
    if isinstance(meta, list):
        return [_drop_timestamps(m) for m in meta]
    if isinstance(meta, dict):
        return {k: _drop_timestamps(v) for k, v in meta.items()
                if k not in ("processing_timestamp", "timestamp", "seconds")}
    return meta


def _processed_equal(port_dir, jax_dir, cases):
    for cid in cases:
        got = nifti.load(port_dir / f"images/{cid}_0000.nii.gz")
        want = nifti.load(jax_dir / f"images/{cid}_0000.nii.gz")
        np.testing.assert_array_equal(got.affine, want.affine)
        assert np.abs(got.get_fdata(np.float32) - want.get_fdata(np.float32)).max() <= 1e-6
        for sub in (f"body_masks/{cid}.nii.gz", f"labels/{cid}.nii.gz"):
            assert (port_dir / sub).read_bytes() == (jax_dir / sub).read_bytes(), sub
        gm = json.loads((port_dir / f"metadata/{cid}.json").read_text())
        wm = json.loads((jax_dir / f"metadata/{cid}.json").read_text())
        assert _drop_timestamps(gm) == _drop_timestamps(wm)
        assert gm["body_mask"]["voxel_counts"]["final"] > 0
    gs = json.loads((port_dir / "preprocessing_summary.json").read_text())
    ws = json.loads((jax_dir / "preprocessing_summary.json").read_text())
    assert _drop_timestamps(gs) == _drop_timestamps(ws)


@pytest.mark.parametrize("body_mask", [True, False])
def test_run_preprocess_matches_jax(tmp_path, body_mask):
    cases = ["0001", "0002", "0003"]
    raw = tmp_path / "raw"
    build_raw_dataset(raw, cases, shape=SHAPE, seed=3)
    splits = tmp_path / "splits"
    splits.mkdir()
    (splits / "train_list.txt").write_text("0001\n0002\n")
    (splits / "val_list.txt").write_text("0003\n0009\n")  # 0009 is missing: fails alone
    jcfg, cfg = JaxConfig.load(REPO_CONFIG), Config.load(REPO_CONFIG)
    for c in (jcfg, cfg):
        c.tpu.z_bucket = 16
        c.data.body_mask.enabled = body_mask
    summaries = run_preprocess(cfg, raw, tmp_path / "port", splits, device="cpu")
    jsum = jax_run_preprocess(jcfg, raw, tmp_path / "jax", splits)
    assert _drop_timestamps(summaries) == _drop_timestamps(jsum)
    assert summaries["val"]["failed_cases"] == ["0009"]
    if body_mask:
        _processed_equal(tmp_path / "port", tmp_path / "jax", cases)
    else:
        assert not (tmp_path / "port/body_masks").exists() or not any(
            (tmp_path / "port/body_masks").iterdir())
        for cid in cases:
            got = nifti.load(tmp_path / f"port/images/{cid}_0000.nii.gz").get_fdata(np.float32)
            want = nifti.load(tmp_path / f"jax/images/{cid}_0000.nii.gz").get_fdata(np.float32)
            assert np.abs(got - want).max() <= 1e-6
    with pytest.raises(PermissionError, match="black box"):
        run_preprocess(cfg, raw, tmp_path / "port", splits, split="test", device="cpu")


def test_preprocess_dataset_runs_every_case_through_one_runner(tmp_path, monkeypatch):
    """``preprocess_dataset`` asks for one graph runner for its run and every
    case's pass goes through it, under one key for one bucketed shape (a
    stand-in runner here, which runs the unit eagerly: the CPU has no
    graphs); the processed tree equals a run without a runner."""
    from light_unet_tpu_torch.pipeline import preprocess as prep_mod

    raw = tmp_path / "raw"
    build_raw_dataset(raw, ["0001", "0002"], shape=SHAPE, seed=3)
    split = tmp_path / "val_list.txt"
    split.write_text("0001\n0002\n")
    cfg = Config.load(REPO_CONFIG)
    cfg.tpu.z_bucket = 16
    made, keys = [], []

    def runner_for(device, requested, what, **kwargs):
        made.append((device.type, requested, what))

        def runner(key, fn, *inputs):
            keys.append(key)
            return fn(*inputs)
        return runner

    monkeypatch.setattr(prep_mod, "runner_for", runner_for)
    prep_mod.preprocess_dataset(split, raw, tmp_path / "runner", cfg, device="cpu")
    monkeypatch.undo()
    prep_mod.preprocess_dataset(split, raw, tmp_path / "eager", cfg, device="cpu")
    assert made == [("cpu", True, "preprocess")]
    assert len(keys) == 2 and keys[0] == keys[1] and keys[0][0] == "preprocess"
    for sub in ("images/0001_0000.nii.gz", "images/0002_0000.nii.gz", "body_masks/0001.nii.gz",
                "body_masks/0002.nii.gz"):
        got = nifti.load(tmp_path / "runner" / sub).get_fdata(np.float32)
        want = nifti.load(tmp_path / "eager" / sub).get_fdata(np.float32)
        np.testing.assert_array_equal(got, want)


def test_cli_split_then_preprocess(tmp_path):
    """``--mode split`` then ``--mode preprocess --device cpu`` make the JAX
    CLI's artefact tree."""
    raw = tmp_path / "data/raw"
    cases = [f"{i:04d}" for i in range(1, 5)]
    build_raw_dataset(raw, cases, shape=(20, 20, 24), seed=1)
    common = ["--config", REPO_CONFIG, "--data_root", str(raw), "--splits_dir",
              str(tmp_path / "data/splits"), "--processed_dir", str(tmp_path / "data/processed"),
              "--workdir", str(tmp_path)]
    assert cli.run(["--mode", "split", "--train_ratio", "0.5", "--val_ratio", "0.5",
                    "--test_ratio", "0.0"] + common) == 0
    lists = {n: (tmp_path / f"data/splits/{n}_list.txt").read_text().split()
             for n in ("train", "val", "test")}
    assert sorted(lists["train"] + lists["val"]) == cases and lists["test"] == []
    assert json.loads((tmp_path / "data/split_manifest.json").read_text())["total_cases"] == 4
    assert cli.run(["--mode", "preprocess", "--device", "cpu"] + common) == 0
    processed = tmp_path / "data/processed"
    for sub in ("images", "labels", "body_masks", "metadata"):
        assert sorted(p.name.split("_")[0].split(".")[0] for p in (processed / sub).iterdir()) == cases
    assert (processed / "preprocessing_summary.json").exists()
    for d in ("models/checkpoints", "logs", "inference/prob_maps", "inference/bboxes"):
        assert (tmp_path / d).is_dir()


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(phantom, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config()
    calls = [
        lambda: intensity.clip_and_normalize(phantom),
        lambda: bm.generate_body_mask(phantom, cfg.data.body_mask),
        lambda: fused.normalize_and_body_mask(phantom, cfg.data.intensity, cfg.data.body_mask),
        lambda: fused.FusedVolumePipeline(lambda x: x, cfg),
        lambda: ccl.label_components(phantom > 1, backend="device"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
