"""PyTorch port: the user scripts beside the JAX package's.

* ``scripts/{split_dataset,preprocess_data,train,inference,evaluate}_torch.py``:
  ``--help`` exits 0 in a process that loads no JAX module, and
  ``split_dataset_torch.py`` writes the split lists of the JAX shim
  ``scripts/split_dataset.py`` on the same raw tree;
* ``scripts/synthetic_training_run_torch.py`` at a tiny size on the CPU:
  its JSON keys are the JAX script's, a run that cannot learn (lr 0, recall
  flat) fires the plateau schedule and stops early, and
  ``--mixed-mode probabilistic`` reports the sampler's domain counts;
* ``light_unet_tpu_torch/tools/synthetic.py``: the phantoms of
  ``tests/synthetic.py`` bit for bit."""

import ast
import importlib.util
import json
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from light_unet_tpu_torch.core import schedule
from light_unet_tpu_torch.tools import synthetic as port_synthetic
from light_unet_tpu_torch.utils import nifti
from tests import synthetic
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "scripts"
STAGES = {"split_dataset": "split", "preprocess_data": "preprocess", "train": "train",
          "inference": "inference", "evaluate": "evaluate"}
JAX_MODULES = ("jax", "flax", "optax", "light_unet_tpu")
TINY_RUN = ["--patch", "16", "--shape", "24", "24", "32", "--n-train", "2", "--n-val", "1",
            "--batch", "2", "--device", "cpu"]


def _run_in_fresh_process(script: Path, argv: list, cwd: Path) -> dict:
    """Run ``script`` as ``__main__`` in a new interpreter; returns its exit
    code and the JAX modules it loaded."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = [{str(script)!r}, *{argv!r}]\n"
        "try:\n"
        f"    runpy.run_path({str(script)!r}, run_name='__main__')\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code or 0\n"
        f"bad = sorted(m for m in sys.modules if m in {JAX_MODULES!r}\n"
        f"             or m.startswith(tuple(p + '.' for p in {JAX_MODULES!r})))\n"
        "print(json.dumps({'rc': rc, 'jax': bad}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def helps(tmp_path_factory):
    cwd = tmp_path_factory.mktemp("helps")
    return {name: _run_in_fresh_process(SCRIPTS / f"{name}_torch.py", ["--help"], cwd)
            for name in STAGES}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_script_help_loads_no_jax(helps, name):
    assert helps[name] == {"rc": 0, "jax": []}


@pytest.mark.parametrize("name", sorted(STAGES))
def test_stage_script_fixes_its_mode(name):
    """14 lines over ``light_unet_tpu_torch.cli.run`` with the JAX shim's
    ``--mode``."""
    text = (SCRIPTS / f"{name}_torch.py").read_text()
    jax_text = (SCRIPTS / f"{name}.py").read_text()
    assert len(text.splitlines()) == 14
    assert "from light_unet_tpu_torch.cli import run" in text
    assert f'run(["--mode", "{STAGES[name]}", *sys.argv[1:]])' in text
    assert f'run(["--mode", "{STAGES[name]}", *sys.argv[1:]])' in jax_text


def test_split_script_writes_the_jax_shims_lists(tmp_path, monkeypatch):
    synthetic.build_raw_dataset(tmp_path / "raw", [f"{i:04d}" for i in range(1, 11)],
                                shape=(16, 16, 16))
    args = ["--data_root", str(tmp_path / "raw")]
    got = _run_in_fresh_process(SCRIPTS / "split_dataset_torch.py",
                                [*args, "--splits_dir", str(tmp_path / "torch/splits")], tmp_path)
    assert got == {"rc": 0, "jax": []}
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["split_dataset.py", *args, "--splits_dir",
                                      str(tmp_path / "jax/splits")])
    with pytest.raises(SystemExit) as done:
        runpy.run_path(str(SCRIPTS / "split_dataset.py"), run_name="__main__")
    assert done.value.code in (0, None)
    for name in ("train", "val", "test"):
        want = (tmp_path / f"jax/splits/{name}_list.txt").read_text()
        assert (tmp_path / f"torch/splits/{name}_list.txt").read_text() == want
    assert ((tmp_path / "torch/split_manifest.json").exists()
            and (tmp_path / "jax/split_manifest.json").exists())


def _synthetic_run_module():
    spec = importlib.util.spec_from_file_location("synthetic_training_run_torch",
                                                  SCRIPTS / "synthetic_training_run_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_output_keys() -> set:
    """The keys of the JAX script's JSON line: its ``out = {...}`` literal
    and the keys it adds to ``out``."""
    tree = ast.parse((SCRIPTS / "synthetic_training_run.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name) \
                and node.value.id == "out" and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def _synthetic_run(tmp_path, capsys, argv) -> dict:
    rc = _synthetic_run_module().main([*TINY_RUN, "--workdir", str(tmp_path), *argv])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_synthetic_run_that_cannot_learn_stops_early(tmp_path, capsys, monkeypatch):
    """lr 0 (the warmup keeps it 0 for the 2 epochs the run lasts): the
    second validation equals the first, so with plateau patience 0 the
    schedule reduces the rate once, and with early-stopping patience 1 the
    run ends after epoch 2 of 5."""
    scales = []
    step = schedule.LRScheduler.step
    monkeypatch.setattr(schedule.LRScheduler, "step",
                        lambda self, metric=None: (step(self, metric), scales.append(self._scale))[0])
    out = _synthetic_run(tmp_path, capsys, ["--epochs", "5", "--lr", "0", "--scheduler", "plateau",
                                            "--plateau-patience", "0", "--early-patience", "1",
                                            "--validate-every", "1"])
    assert set(out) == _jax_output_keys() - {"domain_sample_counts"}
    assert out["scheduler"] == "ReduceLROnPlateau" and out["mode"] == "standard"
    assert out["early_stopped"] and len(out["val_recall"]) == 2
    assert out["val_recall"][0] == out["val_recall"][1] and out["val_dsc"][0] == out["val_dsc"][1]
    assert out["learning_rate"] == [0.0, 0.0]
    assert scales == [1.0, 0.5]  # the plateau schedule fired at the second validation
    assert [e["epoch"] for e in out["selection_events"]] == [0] and out["best_epoch"] == 0
    assert [v["n_cases"] for v in out["val_fallback_history"]] == [1, 1]
    assert (tmp_path / "models/best_model.pth").exists()


def test_synthetic_run_probabilistic_counts_domains(tmp_path, capsys):
    out = _synthetic_run(tmp_path, capsys, ["--epochs", "1", "--mixed-mode", "probabilistic",
                                            "--validate-every", "1"])
    assert set(out) == _jax_output_keys()
    counts = out["domain_sample_counts"]
    assert out["mode"] == "probabilistic" and counts["total_samples"] > 0
    assert counts["fl_samples"] + counts["dlbcl_samples"] == counts["total_samples"]
    assert sorted(p.name for p in (tmp_path / "proc/labels").iterdir()) == [
        "0001.nii.gz", "0002.nii.gz", "0003.nii.gz", "1000.nii.gz", "1001.nii.gz"]


@pytest.mark.parametrize("seed", [0, 1, 42])
@pytest.mark.parametrize("hard", [False, True])
def test_port_phantoms_are_the_tests_phantoms(seed, hard, tmp_path):
    make = "make_phantom_hard" if hard else "make_phantom"
    for shape in [(24, 24, 40), (20, 22, 26)]:
        got = getattr(port_synthetic, make)(np.random.default_rng(seed), shape=shape)
        want = getattr(synthetic, make)(np.random.default_rng(seed), shape=shape)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    port_synthetic.write_case(tmp_path / "port", "0001", *got)
    synthetic.write_case(tmp_path / "jax", "0001", *want)
    for rel in ("images/0001_0000.nii.gz", "labels/0001.nii.gz"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
        np.testing.assert_array_equal(nifti.load(tmp_path / "port" / rel).get_fdata(),
                                      nifti.load(tmp_path / "jax" / rel).get_fdata())
    port_synthetic.write_split_files(tmp_path / "port/splits", ["0001", "0002"], ["0003"])
    synthetic.write_split_files(tmp_path / "jax/splits", ["0001", "0002"], ["0003"])
    for name in ("train", "val", "test"):
        assert ((tmp_path / f"port/splits/{name}_list.txt").read_text()
                == (tmp_path / f"jax/splits/{name}_list.txt").read_text())
