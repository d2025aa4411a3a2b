"""PyTorch port, the slice as a whole: the JAX ``Inferencer`` and the port's
``Inferencer(device="cpu")`` on the same processed cases and checkpoint
write the same prob maps and bbox files; the port imports nothing of JAX;
the port never runs on the CPU unless asked to."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from light_unet_tpu.config import Config as JaxConfig
from light_unet_tpu.core.checkpoint import save_checkpoint
from light_unet_tpu.core.inferencer import Inferencer as JaxInferencer
from light_unet_tpu.models.unet3d import build_model as jax_build_model
from light_unet_tpu.utils import nifti
from light_unet_tpu_torch import cli
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core import inferencer as inferencer_mod
from light_unet_tpu_torch.core.inferencer import Inferencer
from light_unet_tpu_torch.utils.device import precision_scope
from tests.synthetic import make_phantom, write_split_files
from tests.torch_parity import random_params

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "light_unet_tpu_torch"
CASES = ["0001", "0002"]
SHAPE = (24, 24, 40)
THRESHOLD = 0.3

CFG = {
    "data": {"patch_size": [16, 16, 16]},
    "tpu": {"compute_dtype": "float32", "fused_block": True, "mesh_shape": [1]},
}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Processed cases (images + body masks), a split file and an LU3DTPU1
    checkpoint written by the JAX package."""
    tmp = tmp_path_factory.mktemp("slice")
    rng = np.random.default_rng(5)
    data = tmp / "processed"
    for sub in ("images", "body_masks"):
        (data / sub).mkdir(parents=True)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in CASES:
        img, _ = make_phantom(rng, shape=SHAPE, n_lesions=3)
        img = np.clip(img / 9.0, 0.0, 1.0).astype(np.float32)  # processed: [0, 1]
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        body = (img > 0.1).astype(np.uint8)
        nifti.save(nifti.Nifti1Image(body, aff), data / f"body_masks/{cid}.nii.gz")
    write_split_files(tmp / "splits", CASES, CASES)

    cfg = JaxConfig.from_dict(CFG)
    model = jax_build_model(cfg.model, inference=True)
    params = random_params(model, (1, 16, 16, 16, 1), seed=2, train=False)
    params["params"]["out_conv"]["bias"][:] = 1.0  # probabilities around the threshold
    ckpt = tmp / "best_model.pth"
    save_checkpoint(ckpt, {"params": params}, {"best_epoch": 1})  # the trainer's layout
    return tmp, data, ckpt


def _run(inferencer_cls, workspace, name, **kw):
    tmp, data, ckpt = workspace
    out = tmp / name
    inf = inferencer_cls(CFG, ckpt, workdir=str(out), **kw)
    result = inf.infer_split(tmp / "splits/val_list.txt", data)
    assert result["successful"] == len(CASES) and not result["failed"]
    return out


def test_slice_matches_jax_inferencer(workspace):
    jax_out = _run(JaxInferencer, workspace, "jax")
    port_out = _run(Inferencer, workspace, "port", device="cpu")
    n_boxes = 0
    for cid in CASES:
        want = nifti.load(jax_out / f"inference/prob_maps/{cid}_prob.nii.gz")
        got = nifti.load(port_out / f"inference/prob_maps/{cid}_prob.nii.gz")
        want_map, got_map = want.get_fdata(np.float32), got.get_fdata(np.float32)
        assert got_map.shape == SHAPE
        np.testing.assert_array_equal(got.affine, want.affine)
        assert np.abs(got_map - want_map).max() <= 1e-4
        # bbox equality is meaningful only if no voxel sits at the threshold
        assert np.abs(want_map - THRESHOLD).min() > 1e-4
        want_boxes = json.loads((jax_out / f"inference/bboxes/{cid}_bboxes.json").read_text())
        got_boxes = json.loads((port_out / f"inference/bboxes/{cid}_bboxes.json").read_text())
        assert got_boxes == want_boxes
        n_boxes += want_boxes["num_candidates"]
    assert n_boxes > 0


def test_no_prob_maps_and_single_case(workspace):
    tmp, data, ckpt = workspace
    inf = Inferencer(CFG, ckpt, workdir=str(tmp / "bbox_only"), save_prob_maps=False,
                     device="cpu")
    assert inf.infer_case(CASES[0], data, threshold=THRESHOLD)
    assert not list((tmp / "bbox_only/inference/prob_maps").glob("*"))
    assert (tmp / f"bbox_only/inference/bboxes/{CASES[0]}_bboxes.json").exists()
    assert not inf.infer_case("9999", data)  # a missing case fails alone


def test_no_silent_cpu(workspace, monkeypatch):
    """Without CUDA, the port refuses to run unless the CPU was asked for."""
    _, _, ckpt = workspace
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Inferencer(CFG, ckpt)


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def tf32_on(monkeypatch):
    """Both TF32 flags on (cuDNN's default), restored after the test."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


@pytest.mark.parametrize("dtype,inside", [(torch.float32, (False, False)),
                                          (torch.bfloat16, (True, True))])
def test_precision_scope_is_scoped(tf32_on, dtype, inside):
    with precision_scope(dtype):
        assert _tf32_flags() == inside
    with pytest.raises(KeyError):
        with precision_scope(dtype):
            raise KeyError("restored on the way out too")
    assert _tf32_flags() == (True, True)


def test_float32_serving_has_no_tf32_and_restores_the_flags(workspace, tf32_on, monkeypatch):
    """A float32 ``Inferencer`` runs its forwards and its candidate table
    with TF32 off (the JAX package's "highest" precision) and leaves the
    global flags as it found them."""
    tmp, data, ckpt = workspace
    seen = []
    inf = Inferencer(CFG, ckpt, workdir=str(tmp / "tf32"), device="cpu")
    inf.model.out_conv.register_forward_pre_hook(lambda *_: seen.append(("forward", _tf32_flags())))
    table = inferencer_mod.component_table_device
    monkeypatch.setattr(inferencer_mod, "component_table_device",
                        lambda *a, **k: seen.append(("table", _tf32_flags())) or table(*a, **k))
    assert inf.infer_case(CASES[0], data, threshold=THRESHOLD)
    assert inf.infer_split(tmp / "splits/val_list.txt", data)["successful"] == len(CASES)
    assert {w for w, _ in seen} == {"forward", "table"}
    assert {f for _, f in seen} == {(False, False)}
    assert _tf32_flags() == (True, True)


def test_infer_split_writes_a_trace_to_profile_dir(workspace):
    """``tpu.profile_dir`` traces ``infer_split``, as in the JAX package."""
    tmp, data, ckpt = workspace
    cfg = {**CFG, "tpu": {**CFG["tpu"], "profile_dir": str(tmp / "profile")}}
    inf = Inferencer(cfg, ckpt, workdir=str(tmp / "profiled"), device="cpu")
    result = inf.infer_split(tmp / "splits/val_list.txt", data)
    assert result["successful"] == len(CASES) and not result["failed"]
    traces = list((tmp / "profile").glob("trace_*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


@pytest.mark.parametrize("mode", ["bench"])
def test_cli_unported_modes_name_the_roadmap(mode, tmp_path, monkeypatch, capsys):
    """No mode of the JAX CLI is left unported: ``--mode bench``, the last
    one, prints the bench's JSON line (``light_unet_tpu_torch/bench.py``,
    shrunk here to 2 volumes of 24x24x40, 16^3 patches and one pass; the
    line is held in full by ``tests/test_torch_bench.py``)."""
    import functools

    from light_unet_tpu_torch import bench

    tiny = {"data": {"patch_size": [16, 16, 16]}, "model": {"encoder_channels": [4, 8, 16, 32]},
            "tpu": {"z_bucket": 16, "compute_dtype": "float32"}}
    monkeypatch.setattr(bench, "VOLUME_SHAPE", SHAPE)
    monkeypatch.setattr(bench, "N_VOLUMES", 2)
    monkeypatch.setattr(bench, "PATCH", (16, 16, 16))
    monkeypatch.setattr(bench, "default_config", lambda: Config.from_dict(tiny))
    monkeypatch.setattr(bench, "bench_gpu", functools.partial(bench.bench_gpu, reps=1))
    monkeypatch.chdir(tmp_path)  # the CLI makes its directory tree here
    assert cli.run(["--mode", mode, "--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == bench.METRIC and line["value"] > 0
    assert line["detail"]["tpu"]["backend"] == "cpu" and line["detail"]["tpu"]["n_volumes"] == 2


def test_config_reads_the_jax_yaml():
    path = REPO / "configs/unet_fl70.yaml"
    assert Config.load(path).to_dict() == JaxConfig.load(path).to_dict()


def _port_modules():
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _port_scripts():
    return sorted(str(p) for p in (REPO / "scripts").glob("*_torch.py"))


def test_port_imports_no_jax():
    """Every module of the port, chip_smoke.py and the port's scripts
    (``scripts/*_torch.py``) load without JAX, flax or the JAX package
    (exact name or ``light_unet_tpu.`` prefix)."""
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {_port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        f"for i, path in enumerate({_port_scripts()!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'port_script_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax', 'light_unet_tpu')\n"
        "             or m.startswith(('jax.', 'flax.', 'optax.', 'light_unet_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_port_sources_name_no_jax():
    sources = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + [
        Path(p) for p in _port_scripts()]
    for p in sources:
        for line in p.read_text().splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import flax", "from flax")), (p, s)
            assert not s.startswith(("from light_unet_tpu.", "from light_unet_tpu ",
                                     "import light_unet_tpu.")), (p, s)
            assert s != "import light_unet_tpu", (p, s)
