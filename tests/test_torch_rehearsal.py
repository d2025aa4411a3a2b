"""PyTorch port: ``scripts/full_scale_rehearsal_torch.py``, the port's
reference-scale rehearsal, imported with no JAX and run end to end on the
CPU at a tiny size; its phantoms are ``tests/synthetic.py:make_phantom``'s."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from light_unet_tpu_torch.config import Config
from tests.synthetic import make_phantom

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts/full_scale_rehearsal_torch.py"
RECORD_KEYS = {"cases", "epochs", "shape", "config", "device", "generate_s", "z_extents",
               "z_bucket", "stage_s", "stage_rc", "device_memory", "graph_runners",
               "train_epoch_s", "validation_epoch_s", "corpus", "validation_paths",
               "steps_per_epoch", "peak_rss_gib", "checkpoints", "best_model", "inference",
               "evaluate", "val_recall"}


def _script():
    spec = importlib.util.spec_from_file_location("full_scale_rehearsal_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rehearsal_script_imports_no_jax():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('r', {str(SCRIPT)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "import light_unet_tpu_torch.cli, light_unet_tpu_torch.core.trainer\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax', 'light_unet_tpu')\n"
        "             or m.startswith(('jax.', 'flax.', 'optax.', 'light_unet_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-3000:]


def test_rehearsal_phantoms_are_the_jax_tests_phantoms():
    mod = _script()
    for seed, shape, n, radius in [(0, (24, 24, 40), 2, (2, 3)), (42, (20, 22, 26), 5, (2, 5))]:
        got = mod.make_phantom(np.random.default_rng(seed), shape, n, radius)
        want = make_phantom(np.random.default_rng(seed), shape=shape, n_lesions=n,
                            lesion_radius=radius)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_rehearsal_runs_every_stage_on_the_cpu(tmp_path):
    """6 cases of 24x24x40 (z jittered to 16-64), the tiny CLI config, 1
    epoch: all five stages return 0 and the record has every field."""
    cfg = Config.from_dict({
        "data": {"patch_size": [16, 16, 16],
                 "split_ratio": {"train": 0.5, "val": 0.34, "test": 0.16}},
        "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
        "tpu": {"compute_dtype": "float32", "patch_batch": 16, "z_bucket": 16},
        "training": {"epochs": 1},
    })
    cfg.save(tmp_path / "tiny.yaml")
    out = tmp_path / "record.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(SCRIPT), "--workdir", str(tmp_path / "work"),
                          "--cases", "6", "--shape", "24x24x40", "--epochs", "1", "--config",
                          str(tmp_path / "tiny.yaml"), "--device", "cpu", "--out", str(out)],
                         cwd=tmp_path, capture_output=True, text=True, timeout=600, env=env)
    assert res.returncode == 0, (res.stdout[-3000:], res.stderr[-3000:])
    record = json.loads(res.stdout.strip().splitlines()[-1])
    assert record == json.loads(out.read_text())
    assert set(record) == RECORD_KEYS
    assert record["stage_rc"] == {s: 0 for s in ("split", "preprocess", "train", "inference",
                                                 "evaluate")}
    assert sum(record["z_extents"].values()) == 6 and record["z_bucket"] == 16
    assert len(record["train_epoch_s"]) == len(record["validation_epoch_s"]) == 1
    assert record["checkpoints"] == ["checkpoint_epoch_001.ckpt"] and record["best_model"]
    assert record["inference"]["prob_maps"] == record["inference"]["split_cases"] > 0
    assert record["evaluate"]["cases"] == record["inference"]["split_cases"]
    assert record["validation_paths"][0]["n_cases"] == record["inference"]["split_cases"]
    saved = Config.load(tmp_path / "work/rehearsal_config.yaml")
    assert (saved.training.epochs, saved.training.scheduler.T_max, saved.training.warmup_epochs,
            saved.output.save_every_n_epochs, saved.output.keep_last_n_checkpoints) == (1, 1, 1, 1, 2)
