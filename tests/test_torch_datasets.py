"""PyTorch port: the data path of the train stage (``datasets/``) against the
JAX package on the same files and seeds, on the CPU.

Everything here is exact: case indexes, cached volumes, pre-sampled
locations, the ``draw_index`` sequence, host batches (float32 and
quantized), corpus shapes, corners and gathered patches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.datasets import case_dataset as JC
from light_unet_tpu.datasets import device_corpus as JDC
from light_unet_tpu.datasets import index as JI
from light_unet_tpu.datasets import loader as JL
from light_unet_tpu.datasets.patch_sampler import PatchSampler as JaxSampler
from light_unet_tpu.datasets.volume_cache import VolumeCache as JaxCache
from light_unet_tpu.utils import nifti
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.datasets import case_dataset as TC
from light_unet_tpu_torch.datasets import device_corpus as TDC
from light_unet_tpu_torch.datasets import index as TI
from light_unet_tpu_torch.datasets import loader as TL
from light_unet_tpu_torch.datasets.patch_sampler import PatchSampler
from light_unet_tpu_torch.datasets.volume_cache import VolumeCache
from tests.synthetic import make_phantom, write_split_files
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

IDS = ["0001", "0002", "0003", "1005"]
PATCH = (16, 16, 16)
CFG = {"data": {"patch_size": list(PATCH)}, "training": {"batch_size": 3}}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A processed tree: images in [0, 1], labels, body masks for all but one
    case, and split files."""
    tmp = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(11)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for sub in ("images", "labels", "body_masks"):
        (tmp / sub).mkdir()
    for i, cid in enumerate(IDS):
        img, lab = make_phantom(rng, shape=(20 + 2 * i, 24, 28), n_lesions=2)
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(img, aff), tmp / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab.astype(np.uint8), aff), tmp / f"labels/{cid}.nii.gz")
        if i < 3:
            nifti.save(nifti.Nifti1Image((img > 0.05).astype(np.uint8), aff),
                       tmp / f"body_masks/{cid}.nii.gz")
    write_split_files(tmp / "splits", IDS[:3], IDS[2:])
    return tmp


def test_index_matches_jax(tree):
    split = tree / "splits/val_list.txt"
    for dom in (None, {"domain": "fl"}, {"domain": "dlbcl"}, JI.DEFAULT_FL_DOMAIN_CONFIG):
        assert TI.build_case_index(tree, split, dom) == [
            TI.CaseRecord(**vars(r)) for r in JI.build_case_index(tree, split, dom)]
    assert TI.filter_cases_by_domain(["0001", "1100", "x7"], {"domain": "dlbcl"}) == \
        JI.filter_cases_by_domain(["0001", "1100", "x7"], {"domain": "dlbcl"})
    records = TI.build_case_index(tree, split)
    with pytest.raises(FileNotFoundError) as got:
        TI.check_body_masks(records, True, "training")
    with pytest.raises(FileNotFoundError) as want:
        JI.check_body_masks(JI.build_case_index(tree, split), True, "training")
    assert str(got.value) == str(want.value)
    assert str(TI.missing_body_mask_error(7, 9, list("abcdefg"), "x")) == \
        str(JI.missing_body_mask_error(7, 9, list("abcdefg"), "x"))


def test_volume_cache_and_case_dataset_match_jax(tree):
    path = str(tree / "images/0002_0000.nii.gz")
    ours, theirs = VolumeCache(max_items=2), JaxCache()
    np.testing.assert_array_equal(ours.get(path), theirs.get(path))
    assert ours.get_with_header(path)[1].get_zooms() == theirs.get_with_header(path)[1].get_zooms()
    assert ours.drop([path, "nope"]) == ours.get(path).nbytes and len(ours) == 1
    for p in (tree / f"labels/{c}.nii.gz" for c in IDS):
        ours.get(str(p))
    assert len(ours) == 2  # LRU bound
    split = tree / "splits/val_list.txt"
    a = list(TC.CaseDataset(tree, split, return_body_mask=True))
    b = list(JC.CaseDataset(tree, split, return_body_mask=True))
    assert [s.case_id for s in a] == [s.case_id for s in b] == IDS[2:]
    for x, y in zip(a, b):
        assert x.spacing == y.spacing
        for k in ("image", "label", "body_mask"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
    with pytest.raises(FileNotFoundError):
        TC.CaseDataset(tree, split, return_body_mask=True, body_mask_required=True)


def _samplers(tree, bm_sampling):
    cfg = {**CFG, "data": {**CFG["data"], "body_mask": {"enabled": True,
                                                        "apply_to_training_sampling": bm_sampling}}}
    bm_t, bm_j = Config.from_dict(cfg).data.body_mask, JaxConfig.from_dict(cfg).data.body_mask
    split = tree / "splits/train_list.txt"
    return (PatchSampler(tree, split, PATCH, 0.5, 7, None, bm_t, VolumeCache()),
            JaxSampler(tree, split, PATCH, 0.5, 7, None, bm_j, JaxCache()))


@pytest.mark.parametrize("bm_sampling", [True, False])
def test_sampler_matches_jax(tree, bm_sampling):
    ours, theirs = _samplers(tree, bm_sampling)
    for a, b in ((ours.lesion_locations, theirs.lesion_locations),
                 (ours.background_locations, theirs.background_locations)):
        assert len(a) == len(b) > 0
        assert all(i == j and np.array_equal(c, d) for (i, c), (j, d) in zip(a, b))
    assert len(ours) == len(theirs)
    for _ in range(40):
        (w, i, c), (w2, i2, c2) = ours.draw_index(), theirs.draw_index()
        assert (w, i) == (w2, i2) and np.array_equal(c, c2)
    for _ in range(3):
        for x, y in zip(ours.sample_batch(3), theirs.sample_batch(3)):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("transfer", ["uint16", "float32"])
def test_loader_batches_match_jax(tree, transfer):
    cfg = {**CFG, "tpu": {"transfer_dtype": transfer, "prefetch_depth": 2}}
    split = tree / "splits/train_list.txt"
    ours = TL.get_data_loader(tree, split, Config.from_dict(cfg), is_train=True)
    theirs = JL.get_data_loader(tree, split, JaxConfig.from_dict(cfg), is_train=True)
    assert ours["mode"] == theirs["mode"] == "standard"
    lo, lj = ours["train_loader"], theirs["train_loader"]
    assert len(lo) == len(lj) > 1
    n = 0
    for x, y in zip(lo, lj):
        for a, b in zip(x, y):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        n += 1
    assert n == len(lj)
    no_mask = {**cfg, "data": {**CFG["data"], "body_mask": {"enabled": False}}}
    val = TL.get_data_loader(tree, tree / "splits/val_list.txt", Config.from_dict(no_mask),
                             is_train=False)
    assert val["mode"] == "validation" and len(val["val_loader"]) == 2


@pytest.mark.parametrize("mode", ["probabilistic", "fl_epoch_plus_dlbcl"])
def test_mixed_domains_factory_mode_tags(tree, mode):
    """The factory's mode tag and keys in both mixed modes are the JAX
    factory's (loaders and samplers are held against JAX in
    ``tests/test_torch_mixed.py``)."""
    cfg = {**CFG, "training": {**CFG["training"], "mixed_domains": {"enabled": True, "mode": mode}}}
    split = tree / "splits/train_list.txt"
    ours = TL.get_data_loader(tree, split, Config.from_dict(cfg), is_train=True)
    theirs = JL.get_data_loader(tree, split, JaxConfig.from_dict(cfg), is_train=True)
    assert ours["mode"] == theirs["mode"] == mode
    assert set(ours) == set(theirs)


def test_corpus_matches_jax(tree):
    """Bucket shape, estimate, quantized stacks, corners and gathered patches."""
    ours, theirs = _samplers(tree, True)
    shapes = [(20, 24, 28), (22, 24, 28), (25, 24, 31)]
    assert TDC.corpus_bucket_shape(shapes, PATCH) == JDC.corpus_bucket_shape(shapes, PATCH)
    assert TDC.DeviceCorpus.estimate_bytes(shapes, PATCH) == \
        JDC.DeviceCorpus.estimate_bytes(shapes, PATCH)
    t_corpus = TDC.DeviceCorpus.build(ours.cases, VolumeCache(), PATCH, device="cpu")
    j_corpus = JDC.DeviceCorpus.build(theirs.cases, JaxCache(), PATCH)
    np.testing.assert_array_equal(t_corpus.images.numpy().view(np.uint16),
                                  np.asarray(j_corpus.images))
    np.testing.assert_array_equal(t_corpus.labels.numpy(), np.asarray(j_corpus.labels))
    np.testing.assert_array_equal(t_corpus.shapes, j_corpus.shapes)
    assert t_corpus.per_chip_bytes == j_corpus.per_chip_bytes
    cl_t = TDC.CornerLoader(ours, t_corpus, 3)
    cl_j = JDC.CornerLoader(theirs, j_corpus, 3)
    assert len(cl_t) == len(cl_j)
    for _ in range(4):
        c_t, c_j = cl_t.sample_corners(), cl_j.sample_corners()
        np.testing.assert_array_equal(c_t, c_j)
        img_t, lbl_t = TDC.gather_patches(t_corpus.images, t_corpus.labels, torch.from_numpy(c_t),
                                          PATCH)
        img_j, lbl_j = JDC.gather_patches(j_corpus.images, j_corpus.labels, jnp.asarray(c_j), PATCH)
        np.testing.assert_array_equal(img_t.numpy().view(np.uint16), np.asarray(img_j))
        np.testing.assert_array_equal(lbl_t.numpy(), np.asarray(lbl_j))
    assert TDC.corner_for((3, 40, 9), PATCH) == JDC.corner_for((3, 40, 9), PATCH) == (0, 32, 1)


def test_corpus_gather_equals_host_quantized_batch(tree):
    """A gathered batch is bit-identical to the loader's quantized host batch
    for the same draws (two samplers on one seed)."""
    a, _ = _samplers(tree, True)
    b, _ = _samplers(tree, True)
    corpus = TDC.DeviceCorpus.build(a.cases, VolumeCache(), PATCH, device="cpu")
    corners = TDC.CornerLoader(a, corpus, 4).sample_corners()
    imgs, lbls = TL.PrefetchLoader._quantize_batch(b.sample_batch(4))
    g_img, g_lbl = TDC.gather_patches(corpus.images, corpus.labels, torch.from_numpy(corners), PATCH)
    np.testing.assert_array_equal(g_img.numpy().view(np.uint16), imgs)
    np.testing.assert_array_equal(g_lbl.numpy(), lbls)


def test_corpus_budget_falls_back_and_evicts(tree):
    ours, _ = _samplers(tree, True)
    assert TDC.DeviceCorpus.build(ours.cases, VolumeCache(), PATCH, budget_gb=1e-6,
                                  device="cpu") is None
    assert TDC.DeviceCorpus.build([], VolumeCache(), PATCH, device="cpu") is None
    cache = VolumeCache()
    TDC.DeviceCorpus.build(ours.cases, cache, PATCH, evict=True, device="cpu")
    assert len(cache) == 0
