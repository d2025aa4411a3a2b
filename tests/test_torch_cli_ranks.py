"""PyTorch port: the CLI as a job of several ranks on the CPU (gloo).

* the stage barrier: while rank 0 runs a host stage longer than the
  default group's timeout, the other ranks wait on the wait group and the
  job ends with rc 0 on every rank;
* a process that ``torchrun`` started as one of several is one rank of a
  job even when the config does not say ``tpu.distributed: true`` (the
  posture of ``configs/unet_fl70_pod.yaml``);
* a real ``torchrun`` job of 2 ranks, ``--mode all`` into one shared
  workdir, through ``chip_smoke.py --cli-rank`` (each rank runs
  ``cli.run`` and records the files it wrote), held against the same
  command in one process with ``chip_smoke.compare_cli_runs``: history and
  best model within 1e-5 relative, maps within 1e-4, bbox JSONs and
  evaluate counts equal; rank 1 wrote nothing;
* ``python -m light_unet_tpu_torch.cli --mode split`` as torchrun starts
  it, and the rehearsal script as a 2-rank torchrun job (one group, one
  record with both ranks' numbers)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke
from light_unet_tpu_torch import cli
from light_unet_tpu_torch.config import Config, TpuConfig
from light_unet_tpu_torch.parallel import distributed
from tests import torch_parallel_ranks as ranks
from tests.synthetic import build_raw_dataset
from tests.torch_parity import one_torch_thread  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parents[1]
IDS = [f"{i:04d}" for i in range(1, 7)]
# the tiny config of tests/test_torch_trainer.py::test_cli_all_on_the_cpu
TINY = {
    "data": {"patch_size": [16, 16, 16],
             "split_ratio": {"train": 0.5, "val": 0.34, "test": 0.16}},
    "model": {"encoder_channels": [4, 8, 16, 32], "groups": 4},
    "tpu": {"compute_dtype": "float32", "patch_batch": 16, "z_bucket": 16},
    "training": {"epochs": 1, "batch_size": 2},
}


def _torchrun(tmp: Path, *args, timeout: int = 300) -> subprocess.CompletedProcess:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("TORCHELASTIC_RUN_ID", None)
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", *map(str, args)], cwd=tmp, env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, (res.stdout[-4000:], res.stderr[-4000:])
    return res


def _tree_args(tmp: Path, name: str, config: Path) -> list:
    return ["--mode", "all", "--device", "cpu", "--config", str(config),
            "--data_root", str(tmp / "raw"), "--processed_dir", str(tmp / name / "processed"),
            "--splits_dir", str(tmp / name / "splits"), "--workdir", str(tmp / name / "work")]


@pytest.fixture(scope="module")
def raw_tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_ranks")
    build_raw_dataset(tmp / "raw", IDS, shape=(24, 24, 40), seed=0)
    Config.from_dict(TINY).save(tmp / "tiny.yaml")
    return tmp


def test_stage_barrier_outlasts_the_default_groups_timeout(raw_tree, tmp_path):
    """Rank 0's preprocess sleeps 6.5 s in a group whose default timeout is
    4 s: rank 1 waits at the stage barrier, and both ranks return 0."""
    os.symlink(raw_tree / "raw", tmp_path / "raw")
    (tmp_path / "config.json").write_text(json.dumps(TINY))
    (tmp_path / "timeout.txt").write_text("4")
    (tmp_path / "sleep.txt").write_text("6.5")
    got = ranks.spawn("slow_stage", 2, tmp_path)
    assert [int(r["rc"]) for r in got] == [0, 0]
    assert all(float(r["seconds"]) > 6.5 for r in got)
    assert all(bool(r["group_alive"]) for r in got)  # cli.run ends only a group it made
    assert (tmp_path / "work/inference/detailed_results.json").exists()


def test_a_torchrun_process_is_a_rank_without_tpu_distributed(monkeypatch):
    env = {"TORCHELASTIC_RUN_ID": "job", "MASTER_ADDR": "localhost", "MASTER_PORT": "29500",
           "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "2"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed.launched_by_torchrun()
    assert distributed.wants_distributed(TpuConfig())
    assert distributed.init_args(TpuConfig()) == ("tcp://localhost:29500", 4, 2)
    assert distributed.rank_device(TpuConfig(), "cuda") == "cuda:2"
    assert distributed.rank_device(TpuConfig(), "cuda:1") == "cuda:1"
    assert distributed.rank_device(TpuConfig(), "cpu") == "cpu"
    monkeypatch.setenv("WORLD_SIZE", "1")  # torchrun with one process: a plain run
    assert not distributed.wants_distributed(TpuConfig())
    assert distributed.rank_device(TpuConfig(), "cuda") == "cuda"
    monkeypatch.delenv("TORCHELASTIC_RUN_ID")
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert not distributed.wants_distributed(TpuConfig())


def test_torchrun_job_of_the_cli_equals_one_process(raw_tree, tmp_path):
    """``--mode all`` as a 2-rank torchrun job with a config that does not
    set ``tpu.distributed`` (global batch 2, one sample a rank), against
    the same command in this process."""
    config = raw_tree / "tiny.yaml"
    os.symlink(raw_tree / "raw", tmp_path / "raw")
    assert cli.run(_tree_args(tmp_path, "one", config)) == 0
    (tmp_path / "ranks").mkdir()
    res = _torchrun(tmp_path, REPO / "chip_smoke.py", "--cli-rank", tmp_path / "ranks",
                    *_tree_args(tmp_path, "job", config))
    assert "torchrun started 2 processes: one job of 2 ranks" in res.stdout
    for stage in ("split", "preprocess", "evaluate"):
        assert f"rank 1: stage {stage} runs on rank 0" in res.stdout
    got = [json.loads((tmp_path / f"ranks/rank_{r}.json").read_text()) for r in (0, 1)]
    assert [(r["rank"], r["world"], r["rc"], r["device"]) for r in got] == [
        (0, 2, 0, "cpu"), (1, 2, 0, "cpu")]
    assert len(got[0]["stage_s"]) == len(got[1]["stage_s"]) == 5
    assert sorted(got[1]["work_s"]) == ["inference", "train"]  # host stages: rank 0's
    job = str((tmp_path / "job").resolve())
    assert any(p.startswith(job) for p in got[0]["written"])
    assert not [p for p in got[1]["written"] if p.startswith(job)]
    diffs = chip_smoke.compare_cli_runs(tmp_path / "one", tmp_path / "job", "close")
    assert diffs["history_rel"] <= 1e-5 and diffs["model_rel"] <= 1e-5


def test_torchrun_split_as_users_start_it(raw_tree, tmp_path):
    """``python -m light_unet_tpu_torch.cli`` under torchrun, the YAML with
    no ``tpu.distributed``: rank 0 splits, rank 1 waits."""
    res = _torchrun(tmp_path, "-m", "light_unet_tpu_torch.cli", "--mode", "split",
                    "--device", "cpu", "--config", raw_tree / "tiny.yaml", "--data_root", raw_tree / "raw",
                    "--splits_dir", tmp_path / "job/splits")
    assert "rank 1: stage split runs on rank 0" in res.stdout
    assert res.stdout.count("Total cases found: 6") == 1
    assert cli.run(["--mode", "split", "--config", str(raw_tree / "tiny.yaml"), "--data_root",
                    str(raw_tree / "raw"), "--splits_dir", str(tmp_path / "one/splits")]) == 0
    for name in ("train", "val", "test"):
        assert ((tmp_path / f"job/splits/{name}_list.txt").read_text()
                == (tmp_path / f"one/splits/{name}_list.txt").read_text())


def test_rehearsal_as_a_torchrun_job(raw_tree, tmp_path):
    """6 cases of 24x24x40, 1 epoch, 2 ranks: one group for the five
    stages, one record from rank 0 holding both ranks' numbers."""
    out = tmp_path / "record.json"
    res = _torchrun(tmp_path, REPO / "scripts/full_scale_rehearsal_torch.py", "--workdir",
                    tmp_path / "work", "--cases", "6", "--shape", "24x24x40", "--epochs", "1",
                    "--config", raw_tree / "tiny.yaml", "--device", "cpu", "--out", out)
    record = json.loads(out.read_text())
    assert json.loads(res.stdout.strip().splitlines()[-1]) == record
    assert record["world_size"] == 2 and record["process_groups_made"] == 1
    assert [r["rank"] for r in record["ranks"]] == [0, 1]
    stages = ["split", "preprocess", "train", "inference", "evaluate"]
    for r in record["ranks"]:
        assert r["ok"] and list(r["stage_s"]) == stages and r["stage_rc"] == dict.fromkeys(stages, 0)
        assert len(r["train_epoch_s"]) == 1
    assert record["stage_rc"] == dict.fromkeys(stages, 0) and record["best_model"]
    assert sum(record["z_extents"].values()) == 6
    assert record["evaluate"]["cases"] == record["inference"]["split_cases"] > 0
