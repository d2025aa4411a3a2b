"""PyTorch port: ``StageTimer`` (``utils/tracing.py``) against the JAX
package's on the same sequence of timed blocks, ``time.time`` patched in
both, and ``maybe_profile`` doing nothing without a directory; the
recorder (``span``, ``count``, ``snapshot``, ``take``) off and on, on a fake
clock, across threads and under the profiler, and the spans it records in
``Inferencer.infer_split`` and ``FusedVolumePipeline`` on the CPU."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from light_unet_tpu.utils import tracing as jax_tracing
from light_unet_tpu_torch.config import Config
from light_unet_tpu_torch.core.inferencer import MAX_DEVICE_COMPONENTS, Inferencer
from light_unet_tpu_torch.models.unet3d import build_model
from light_unet_tpu_torch.ops.fused import FusedVolumePipeline
from light_unet_tpu_torch.utils import nifti, tracing
from tests.synthetic import make_phantom, write_split_files

# block boundaries (enter, exit) in seconds: durations of 0.5, 0.25, 1e-5,
# 1/3 and 2.00004, so that the 4-decimal rounding and the report's .2f/.3f
# both show
TICKS = [0.0, 0.5, 1.0, 1.25, 2.0, 2.00001, 3.0, 3.3333333, 4.0, 6.00004]


def _drive(module, monkeypatch, capsys, tmp_path, prefix):
    ticks = iter(TICKS)
    monkeypatch.setattr(time, "time", lambda: next(ticks))
    timer = module.StageTimer()
    for name in ("decode", "prepare", "decode", "dispatch"):
        with timer.time(name):
            pass
    with pytest.raises(ValueError):  # a block that raises is still timed
        with timer.time("write"):
            raise ValueError("disk full")
    monkeypatch.undo()
    timer.report(prefix=prefix)
    printed = capsys.readouterr().out
    path = tmp_path / module.__name__ / "nested" / "stages.json"
    timer.save(path)
    return timer.summary(), printed, path.read_text()


@pytest.mark.parametrize("prefix", ["", "  [serving] "])
def test_stage_timer_matches_jax(monkeypatch, capsys, tmp_path, prefix):
    got = _drive(tracing, monkeypatch, capsys, tmp_path, prefix)
    want = _drive(jax_tracing, monkeypatch, capsys, tmp_path, prefix)
    assert got == want
    summary, printed, saved = got
    assert list(summary) == ["decode", "prepare", "dispatch", "write"]
    assert summary["decode"] == {"total_seconds": 0.5, "calls": 2, "seconds_per_call": 0.25}
    assert summary["write"]["calls"] == 1
    assert json.loads(saved) == summary
    assert printed.splitlines()[0] == f"{prefix}decode: 0.50s total, 2 calls, 0.250s/call"


def test_stage_timer_empty(tmp_path, capsys):
    timer = tracing.StageTimer()
    assert timer.summary() == jax_tracing.StageTimer().summary() == {}
    timer.report()
    assert capsys.readouterr().out == ""
    timer.save(tmp_path / "empty.json")
    assert json.loads((tmp_path / "empty.json").read_text()) == {}


def test_maybe_profile_without_a_directory_does_nothing(monkeypatch):
    monkeypatch.delenv("LIGHT_UNET_PROFILE", raising=False)
    with tracing.maybe_profile(None) as where:
        assert where is None


@pytest.fixture
def recorder():
    """The recorder on and empty; off and drained afterwards."""
    tracing.take()
    tracing.enable(True)
    try:
        yield
    finally:
        tracing.enable(False)
        tracing.take()


def _delta(before: dict, after: dict, name: str) -> int:
    return after.get(name, 0) - before.get(name, 0)


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("touched while off")

    tracing.enable(False)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    monkeypatch.setattr(tracing, "_clock", boom)
    before = tracing.snapshot()
    assert tracing.span("a") is tracing.span("b", req=1, unit="u") is tracing.request("c")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.request("c"), tracing.span("a"), tracing.span("b", req=1):
            tracing.count("n", 5)
    assert tracing.take() == []
    assert tracing.snapshot() == before


def test_spans_names_parents_requests_and_self_time(recorder, monkeypatch):
    ticks = iter(range(0, 1000, 10))  # every clock read advances 10 ns
    monkeypatch.setattr(tracing, "_clock", lambda: next(ticks))
    with tracing.request("case-1"):
        with tracing.span("outer"):                      # 0 .. 70
            with tracing.span("replay", unit="window"):  # 10 .. 20
                pass
            with tracing.span("fetch", req=7):           # 30 .. 60
                with tracing.span("fetch.sync"):         # 40 .. 50
                    pass
    with tracing.span("alone"):                          # 80 .. 90
        pass
    spans = tracing.take()
    assert tracing.take() == []  # drained
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["replay", "fetch.sync", "fetch", "outer", "alone"]
    assert by["outer"]["parent"] is None and by["alone"]["parent"] is None
    assert by["replay"]["parent"] == by["fetch"]["parent"] == by["outer"]["id"]
    assert by["fetch.sync"]["parent"] == by["fetch"]["id"]
    assert [by[n]["req"] for n in ("outer", "replay", "fetch", "fetch.sync", "alone")] == [
        "case-1", "case-1", 7, 7, None]
    assert by["replay"]["unit"] == "window" and by["outer"]["unit"] is None
    assert {s["tid"] for s in spans} == {threading.get_native_id()}
    assert (by["outer"]["start_ns"], by["outer"]["end_ns"]) == (0, 70)
    assert tracing.self_ns(spans) == {"outer": 70 - 10 - 30, "replay": 10, "fetch": 30 - 10,
                                      "fetch.sync": 10, "alone": 10}


def test_threads_keep_their_own_stacks_and_counters_add_up(recorder):
    before = tracing.snapshot()
    tids = {}
    start = threading.Barrier(2)

    def work(k):
        tids[k] = threading.get_native_id()
        start.wait(timeout=10)
        with tracing.span("worker", req=k):
            for _ in range(5000):
                tracing.count("n")
                tracing.count("bytes", 3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    after = tracing.snapshot()
    assert _delta(before, after, "n") == 10000 and _delta(before, after, "bytes") == 30000
    spans = tracing.take()
    assert sorted((s["req"], s["tid"], s["parent"]) for s in spans) == [
        (0, tids[0], None), (1, tids[1], None)]


def test_the_buffer_is_bounded(recorder, monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    before = tracing.snapshot()
    for k in range(5):
        with tracing.span("s", req=k):
            pass
    assert [s["req"] for s in tracing.take()] == [0, 1, 2]
    assert _delta(before, tracing.snapshot(), "spans.dropped") == 2


def test_a_span_shares_the_profilers_clock(recorder):
    """The in-memory start and the ``lu.`` range's start in the trace agree."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for k in range(3):
            with tracing.span("probe", req=k):
                time.sleep(0.002)
    spans = tracing.take()
    ranges = sorted((e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                    if e.name() == tracing.PREFIX + "probe")
    assert len(ranges) == len(spans) == 3
    for s, (start, dur) in zip(spans, ranges):
        assert abs(start - s["start_ns"]) < 2e6
        assert s["start_ns"] <= start and start + dur <= s["end_ns"]


def test_maybe_profile_writes_the_spans_beside_the_trace(tmp_path):
    tracing.enable(False)
    with tracing.maybe_profile(str(tmp_path)) as where:
        assert where == str(tmp_path) and tracing.enabled()
        with tracing.span("probe", req="x"):
            tracing.count("n", 2)
    assert not tracing.enabled() and tracing.take() == []
    record = json.loads(next(tmp_path.glob("spans_*.json")).read_text())
    assert [(s["name"], s["req"]) for s in record["spans"]] == [("probe", "x")]
    assert record["counters"]["n"] == 2 and "probe" in record["self_ms"]
    assert list(tmp_path.glob("trace_*.json"))


# the program's spans on a tiny CPU stage and pipeline
CASES = ["0001", "0002"]
SHAPE = (24, 24, 40)
CFG = {"data": {"patch_size": [16, 16, 16]}, "model": {"encoder_channels": [4, 8, 16, 32]},
       "tpu": {"compute_dtype": "float32", "z_bucket": 16, "mesh_shape": [1]}}
CASE_SPANS = {"decode", "prepare", "prepare.quantize", "prepare.upload", "wait_input",
              "dispatch", "replay", "table", "fetch", "fetch.sync", "fetch.unpack",
              "fetch.dequant", "write.map", "write.serialize", "write.deflate", "table.read",
              "bboxes", "write.json"}


def _model():
    torch.manual_seed(0)
    return build_model(Config.from_dict(CFG).model, torch.float32, inference=True).eval()


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """(data dir, split file, checkpoint) of two processed cases."""
    tmp = tmp_path_factory.mktemp("traced")
    rng = np.random.default_rng(3)
    data = tmp / "processed"
    for sub in ("images", "body_masks"):
        (data / sub).mkdir(parents=True)
    aff = np.diag([4.0, 4.0, 4.0, 1.0])
    for cid in CASES:
        img = np.clip(make_phantom(rng, shape=SHAPE)[0] / 9.0, 0.0, 1.0).astype(np.float32)
        nifti.save(nifti.Nifti1Image(img, aff), data / f"images/{cid}_0000.nii.gz")
        nifti.save(nifti.Nifti1Image((img > 0.1).astype(np.uint8), aff),
                   data / f"body_masks/{cid}.nii.gz")
    write_split_files(tmp / "splits", CASES, CASES)
    ckpt = tmp / "model.pth"
    torch.save({"model_state_dict": _model().state_dict()}, ckpt)
    return data, tmp / "splits/val_list.txt", ckpt


def test_infer_split_records_every_case_under_its_id(stage, tmp_path):
    data, split, ckpt = stage
    inf = Inferencer(CFG, ckpt, workdir=str(tmp_path), device="cpu")
    tracing.take()
    tracing.enable(False)
    assert inf.infer_split(split, data)["successful"] == len(CASES)
    assert tracing.take() == []
    tracing.enable(True)
    try:
        before = tracing.snapshot()
        assert inf.infer_split(split, data)["successful"] == len(CASES)
        after = tracing.snapshot()
    finally:
        tracing.enable(False)
    spans = tracing.take()
    assert {s["req"] for s in spans} == set(CASES)
    by_id = {s["id"]: s for s in spans}
    main = threading.get_native_id()
    for cid in CASES:
        mine = [s for s in spans if s["req"] == cid]
        assert {s["name"] for s in mine} == CASE_SPANS
        names = [s["name"] for s in mine]
        assert names.count("decode") == 2  # the image and the body mask
        for s in mine:
            if s["name"] in ("write.serialize", "write.deflate"):
                assert by_id[s["parent"]]["name"] == "write.map"
            if s["name"] in ("decode", "prepare"):
                assert s["tid"] != main
            if s["name"] in ("wait_input", "dispatch", "table", "fetch", "write.map",
                             "write.json"):
                assert s["tid"] == main
        units = {s["unit"] for s in mine if s["name"] == "replay"}
        assert units == {"window", "table"}
    assert _delta(before, after, "fetch.bytes") > 0 and _delta(before, after, "upload.bytes") > 0
    assert _delta(before, after, "table.host_fallback") == 0


def test_many_components_count_the_host_fallback_once(stage, tmp_path, recorder):
    _, _, ckpt = stage
    inf = Inferencer(CFG, ckpt, workdir=str(tmp_path), device="cpu")
    prob = torch.zeros(SHAPE)
    corners = torch.zeros(SHAPE, dtype=torch.bool)
    corners[::4, ::4, ::4] = True
    for dz, dy, dx in np.ndindex(2, 2, 2):  # 2^3-voxel blocks pass the 0.5 cc size filter
        prob[dz::4, dy::4, dx::4] = 0.9
    n = int(corners.sum())  # 360 components, past the device table's cap
    assert n > MAX_DEVICE_COMPONENTS
    header = nifti.Nifti1Image(np.zeros(SHAPE, np.float32), np.diag([4.0, 4.0, 4.0, 1.0])).header
    before = tracing.snapshot()
    assert inf._finalize_case("many", {"header": header, "spacing": [4.0, 4.0, 4.0]},
                              (prob, SHAPE), threshold=0.3)
    assert _delta(before, tracing.snapshot(), "table.host_fallback") == 1
    boxes = json.loads((tmp_path / inf.bboxes_dir / "many_bboxes.json").read_text())
    assert boxes["num_candidates"] == n


def test_fused_pipeline_spans_share_one_id_a_volume(recorder):
    cfg = Config.from_dict(CFG)
    pipe = FusedVolumePipeline(_model(), cfg, patch_batch=8, device="cpu")
    rng = np.random.default_rng(1)
    vols = [make_phantom(rng, shape=SHAPE)[0] for _ in range(2)]
    preps = [pipe.prepare(v) for v in vols]
    maps = [pipe.fetch(pipe.dispatch(p)) for p in preps]
    assert [p.req for p in preps] == [0, 1] and all(m.shape == SHAPE for m in maps)
    spans = tracing.take()
    for req in (0, 1):
        names = {s["name"] for s in spans if s["req"] == req}
        assert {"prepare", "prepare.clip", "prepare.quantize", "prepare.upload", "dispatch",
                "replay", "fetch", "fetch.sync"} <= names
    assert {s["req"] for s in spans if s["name"] == "decode"} <= {None}
