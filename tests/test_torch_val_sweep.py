"""PyTorch port: the device validation sweep (``ops/val_metrics.py``) and the
evaluate stage (``pipeline/evaluate.py``) against the JAX package, on the CPU.

Tolerances: per-threshold counts, sums and every decision (None returns,
overflow reasons, GT cap, ledger charges) exact; ``metrics.csv`` and
``detailed_results.json`` equal after parsing; device vs host DSC <= 1e-9
(``tests/unit/test_val_metrics.py:227-229``)."""

import csv
import io
import json

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.ops.val_metrics import DeviceValidationSweep as JaxSweep
from light_unet_tpu.pipeline import evaluate as JE
from light_unet_tpu.utils import nifti
from light_unet_tpu.utils.hbm_ledger import HbmLedger as JaxLedger
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.ops import val_metrics as vm
from light_unet_tpu_torch.ops.sliding_window import quantize_out
from light_unet_tpu_torch.ops.val_metrics import DeviceValidationSweep
from light_unet_tpu_torch.pipeline import evaluate as TE
from light_unet_tpu_torch.utils.hbm_ledger import HbmLedger
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

THRESHOLDS = [0.1, 0.3, 0.5, 0.7]
SPACING = (4.0, 4.0, 4.0)


def _make_case(rng, shape=(30, 28, 34), n_lesions=4):
    target = np.zeros(shape, np.float32)
    for _ in range(n_lesions):
        c = rng.integers(4, np.array(shape) - 4)
        target[c[0] - 2:c[0] + 2, c[1] - 2:c[1] + 2, c[2] - 2:c[2] + 2] = 1
    prob = np.clip(target * rng.uniform(0.45, 1.0) + rng.random(shape, dtype=np.float32) * 0.35,
                   0, 1).astype(np.float32)
    return prob, target


def _sweeps(thresholds=THRESHOLDS, **kw):
    return DeviceValidationSweep(thresholds, device="cpu", **kw), JaxSweep(thresholds, **kw)


@pytest.mark.parametrize("pad", [False, True])
def test_sweep_matches_jax(rng, pad):
    ours, theirs = _sweeps(n_gt_cap=16)
    for i in range(3):
        prob, target = _make_case(rng)
        assert ours.add_case(f"c{i}", target) and theirs.add_case(f"c{i}", target)
        t_prob, j_prob = torch.from_numpy(prob), jnp.asarray(prob)
        if pad:  # the sliding-window engine's z-bucket padding
            t_prob = torch.nn.functional.pad(t_prob, (0, 14))
            j_prob = jnp.pad(j_prob, ((0, 0), (0, 0), (0, 14)))
        got = ours.case_metrics(f"c{i}", t_prob, SPACING)
        assert got is not None and got == theirs.case_metrics(f"c{i}", j_prob, SPACING)


def test_sweep_tables_equal_jax(rng):
    """The raw tables too: same rows in the same (seed) order."""
    from light_unet_tpu.ops.val_metrics import sweep_tables_device as jax_tables

    prob, target = _make_case(rng, shape=(16, 18, 20))
    gt = vm.prepare_gt(target)["labeled"].astype(np.uint8)
    t_tab, t_int, t_cnt = vm.sweep_tables_device(torch.from_numpy(prob), torch.from_numpy(gt),
                                                 THRESHOLDS, max_components=256, n_gt_cap=8)
    j_tab, j_int, j_cnt = jax_tables(jnp.asarray(prob), jnp.asarray(gt),
                                     jnp.asarray(np.asarray(THRESHOLDS, np.float32)),
                                     max_components=256, n_gt_cap=8)
    np.testing.assert_array_equal(t_tab.numpy(), np.asarray(j_tab))
    np.testing.assert_array_equal(t_int.numpy(), np.asarray(j_int))
    np.testing.assert_array_equal(t_cnt.numpy(), np.asarray(j_cnt))


def test_sweep_quantized_prob_input(rng):
    """uint16 maps (int16 bits in the port) dequantize as the JAX package does."""
    ours, theirs = _sweeps(n_gt_cap=16)
    prob, target = _make_case(rng)
    assert ours.add_case("q", target) and theirs.add_case("q", target)
    q_t = quantize_out(torch.from_numpy(prob))
    q_j = jnp.asarray(np.round(np.clip(prob, 0, 1) * 65535.0).astype(np.uint16))
    got = ours.case_metrics("q", q_t, SPACING)
    assert got == theirs.case_metrics("q", q_j, SPACING)
    deq = torch.from_numpy((np.round(prob * 65535) / 65535).astype(np.float32))
    assert got == ours.case_metrics("q", deq, SPACING)


def test_overflow_reasons_match_jax(rng):
    ours, theirs = _sweeps([0.8], max_components=8, n_gt_cap=16)
    prob = rng.random((24, 24, 24), dtype=np.float32)  # speckle at 0.8
    target = np.zeros_like(prob)
    target[4:8, 4:8, 4:8] = 1
    assert ours.add_case("x", target) and theirs.add_case("x", target)
    assert ours.case_metrics("x", torch.from_numpy(prob), SPACING) is None
    assert theirs.case_metrics("x", jnp.asarray(prob), SPACING) is None
    assert ours.last_overflow_reason == theirs.last_overflow_reason == "components"
    # the 4x-cap tier shares the id maps and recovers the exact counts
    big, big_j = _sweeps([0.8], max_components=4096, n_gt_cap=16)
    big._gt, big_j._gt = ours._gt, theirs._gt
    got = big.case_metrics("x", torch.from_numpy(prob), SPACING)
    assert got is not None and big.last_overflow_reason is None
    assert got == big_j.case_metrics("x", jnp.asarray(prob), SPACING)


def test_envelope_and_component_size(monkeypatch):
    ours, theirs = _sweeps([0.5], max_components=8, n_gt_cap=16)
    target = np.zeros((1, 1, 4096), np.float32)
    target[0, 0, :4] = 1
    assert ours.add_case("x", target) and theirs.add_case("x", target)
    assert ours.case_metrics("x", torch.zeros((1, 1, 4096)), SPACING) is None
    assert theirs.case_metrics("x", jnp.zeros((1, 1, 4096)), SPACING) is None
    assert ours.last_overflow_reason == theirs.last_overflow_reason == "envelope"
    # a component at the exactness bound: cap-independent, host path
    monkeypatch.setattr(vm, "_MAX_EXACT_COMPONENT", 8)
    small = DeviceValidationSweep([0.5], device="cpu")
    tgt = np.zeros((6, 6, 6), np.float32)
    assert small.add_case("y", tgt)
    prob = torch.zeros((6, 6, 6))
    prob[1:4, 1:4, 1:2] = 0.9  # 9 voxels
    assert small.case_metrics("y", prob, SPACING) is None
    assert small.last_overflow_reason == "component_size"


def test_gt_cap_and_empty_cases():
    ours, theirs = _sweeps([0.5], n_gt_cap=2)
    target = np.zeros((20, 20, 20), np.float32)
    for i in range(4):
        target[1 + 4 * i:3 + 4 * i, 1:3, 1:3] = 1  # 4 lesions > cap 2
    assert not ours.add_case("many", target) and not theirs.add_case("many", target)
    assert not ours.has_case("many")
    ours, theirs = _sweeps([0.5], n_gt_cap=8)
    shape = (16, 16, 16)
    prob = np.zeros(shape, np.float32)
    prob[4:8, 4:8, 4:8] = 0.9
    lesion = np.zeros(shape, np.float32)
    lesion[2:5, 2:5, 2:5] = 1
    for cid, p, t in (("nogt", prob, np.zeros(shape, np.float32)),
                      ("nopred", np.zeros(shape, np.float32), lesion)):
        assert ours.add_case(cid, t) and theirs.add_case(cid, t)
        got = ours.case_metrics(cid, torch.from_numpy(p), SPACING)
        assert got == theirs.case_metrics(cid, jnp.asarray(p), SPACING)
    assert got[0]["fn"] == 1 and got[0]["tp"] == 0


def test_ledger_charges_match_jax(rng):
    """GT id maps and padded variants charge the same bytes under the same
    names; a ledger with no room refuses the case in both."""
    gb = 1 << 30
    led, led_j = HbmLedger(capacity_bytes=gb), JaxLedger(capacity_bytes=gb)
    ours = DeviceValidationSweep(THRESHOLDS, ledger=led, device="cpu")
    theirs = JaxSweep(THRESHOLDS, ledger=led_j)
    prob, target = _make_case(rng)
    assert ours.add_case("a", target) and theirs.add_case("a", target)
    ours.gt_ids_padded("a", (30, 28, 48))
    theirs.gt_ids_padded("a", (30, 28, 48))
    assert dict(led.entries) == dict(led_j.entries)
    ours.release_case("a")
    assert not ours.has_case("a")
    tiny = DeviceValidationSweep(THRESHOLDS, ledger=HbmLedger(capacity_bytes=1024), device="cpu")
    tiny_j = JaxSweep(THRESHOLDS, ledger=JaxLedger(capacity_bytes=1024))
    assert not tiny.add_case("a", target) and not tiny_j.add_case("a", target)


@pytest.fixture
def eval_tree(tmp_path, rng):
    """Four cases of maps + labels on disk and a split file."""
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    (tmp_path / "prob_maps").mkdir()
    (tmp_path / "data" / "labels").mkdir(parents=True)
    ids = [f"{i:04d}" for i in range(1, 5)]
    for cid in ids:
        prob, target = _make_case(rng)
        nifti.save(nifti.Nifti1Image(prob, aff), tmp_path / f"prob_maps/{cid}_prob.nii.gz")
        nifti.save(nifti.Nifti1Image(target.astype(np.uint8), aff),
                   tmp_path / f"data/labels/{cid}.nii.gz")
    split = tmp_path / "list.txt"
    split.write_text("\n".join(ids + ["0099"]))  # a case with no map is skipped
    return tmp_path, split, ids


def test_evaluate_case_device_matches_host(eval_tree):
    tmp, _, ids = eval_tree
    for cid in ids[:2]:
        dev = TE.evaluate_case(cid, tmp / "prob_maps", tmp / "data", THRESHOLDS,
                               spacing=SPACING, use_device=True, device="cpu")
        host = TE.evaluate_case(cid, tmp / "prob_maps", tmp / "data", THRESHOLDS,
                                spacing=SPACING, use_device=False)
        want = JE.evaluate_case(cid, tmp / "prob_maps", tmp / "data", THRESHOLDS,
                                spacing=SPACING, use_device=False)
        assert host == want
        for t in THRESHOLDS:
            for k in ("tp", "fp", "fn"):
                assert dev[t][k] == host[t][k], (t, k)
            for k in ("dsc", "recall", "precision", "f1"):
                assert dev[t][k] == pytest.approx(host[t][k], abs=1e-9), (t, k)


@pytest.mark.parametrize("device_path", [True, False])
def test_run_evaluate_files_match_jax(eval_tree, device_path):
    """metrics.csv and detailed_results.json of the port equal the JAX
    package's (pandas CSV) on the same files, device sweep and host path."""
    tmp, split, ids = eval_tree
    cfg = {"validation": {"threshold_sensitivity_range": [0.1, 0.2, 0.5, 0.7],
                          "default_threshold": 0.3},
           "tpu": {"device_val_metrics": device_path}}
    TE.run_evaluate(Config.from_dict(cfg), split, tmp / "prob_maps", tmp / "data",
                    tmp / "port", device="cpu")
    JE.run_evaluate(JaxConfig.from_dict(cfg), split, tmp / "prob_maps", tmp / "data", tmp / "jax")
    port_csv, jax_csv = (tmp / "port/metrics.csv").read_text(), (tmp / "jax/metrics.csv").read_text()
    assert list(csv.reader(io.StringIO(port_csv))) == list(csv.reader(io.StringIO(jax_csv)))
    pd.testing.assert_frame_equal(pd.read_csv(io.StringIO(port_csv), index_col=0),
                                  pd.read_csv(io.StringIO(jax_csv), index_col=0))
    port_json = json.loads((tmp / "port/detailed_results.json").read_text())
    jax_json = json.loads((tmp / "jax/detailed_results.json").read_text())
    if device_path:  # DSC comes from exact integer sums: equal up to float rounding
        for cid in ids:
            for t, r in jax_json["per_case"][cid].items():
                assert port_json["per_case"][cid][t]["dsc"] == pytest.approx(r["dsc"], abs=1e-9)
                port_json["per_case"][cid][t]["dsc"] = r["dsc"]
        for t, r in jax_json["summary"].items():
            assert port_json["summary"][t]["dsc"] == pytest.approx(r["dsc"], abs=1e-9)
            port_json["summary"][t]["dsc"] = r["dsc"]
    assert port_json == jax_json
    assert sorted(port_json["per_case"]) == ids


def test_evaluate_split_one_sweep_and_release(eval_tree, monkeypatch):
    """One sweep per split; every case's GT released; ledger drained."""
    tmp, split, ids = eval_tree
    created = []

    class CountingSweep(vm.DeviceValidationSweep):
        def __init__(self, *a, **k):
            created.append(self)
            super().__init__(*a, **k)

    monkeypatch.setattr(vm, "DeviceValidationSweep", CountingSweep)
    _, per_case = TE.evaluate_split(split, tmp / "prob_maps", tmp / "data",
                                    Config.from_dict({}), device="cpu")
    assert len(created) == 1 and created[0]._gt == {} and created[0].ledger.used() == 0
    assert sorted(per_case) == ids


def test_evaluate_device_path_raises_without_cuda(eval_tree, monkeypatch):
    """No fallback hides the device: asking for the card without one raises."""
    tmp, split, _ = eval_tree
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TE.evaluate_split(split, tmp / "prob_maps", tmp / "data", Config.from_dict({}))


def test_run_evaluate_on_inferencer_maps_matches_jax(tmp_path):
    """Maps written by the port's ``Inferencer`` (seeded tiny model, CPU):
    the port's and the JAX package's evaluate stages write the same files."""
    from light_unet_tpu_torch.core.inferencer import Inferencer
    from light_unet_tpu_torch.models.unet3d import build_model, init_weights
    from tests.synthetic import make_phantom, write_split_files

    rng = np.random.default_rng(9)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    ids = ["0001", "0002"]
    for sub in ("images", "labels"):
        (tmp_path / "data" / sub).mkdir(parents=True)
    for cid in ids:
        img, lab = make_phantom(rng, shape=(24, 24, 40), n_lesions=3)
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(img, aff), tmp_path / f"data/images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image(lab.astype(np.uint8), aff), tmp_path / f"data/labels/{cid}.nii.gz")
    write_split_files(tmp_path / "splits", [], ids)
    cfg = {"data": {"patch_size": [16, 16, 16], "body_mask": {"enabled": False}},
           "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
           "tpu": {"compute_dtype": "float32", "patch_batch": 16, "z_bucket": 16}}
    model = init_weights(build_model(Config.from_dict(cfg).model, inference=True),
                         torch.Generator().manual_seed(5))
    torch.save({"model_state_dict": model.state_dict(), "epoch": 0}, tmp_path / "best.pth")
    inf = Inferencer(cfg, tmp_path / "best.pth", workdir=str(tmp_path / "work"), device="cpu")
    split = tmp_path / "splits/val_list.txt"
    assert inf.infer_split(split, tmp_path / "data")["successful"] == 2
    maps = tmp_path / "work/inference/prob_maps"
    TE.run_evaluate(Config.from_dict(cfg), split, maps, tmp_path / "data", tmp_path / "port",
                    device="cpu")
    JE.run_evaluate(JaxConfig.from_dict(cfg), split, maps, tmp_path / "data", tmp_path / "jax")
    assert (tmp_path / "port/metrics.csv").read_text() == (tmp_path / "jax/metrics.csv").read_text()
    port_json = json.loads((tmp_path / "port/detailed_results.json").read_text())
    jax_json = json.loads((tmp_path / "jax/detailed_results.json").read_text())
    assert sorted(port_json["per_case"]) == ids
    for part in ("summary", "per_case"):
        flat_p = pd.json_normalize(port_json[part]).iloc[0].to_dict()
        flat_j = pd.json_normalize(jax_json[part]).iloc[0].to_dict()
        assert set(flat_p) == set(flat_j)
        for k, v in flat_j.items():  # DSC from exact integer sums: float rounding only
            assert flat_p[k] == pytest.approx(v, abs=1e-9) if k.endswith("dsc") else flat_p[k] == v, k
