"""A whole run on the CPU at the test size (``tiny.py``; the harness's
look for a card is skipped), sound and with the timed path broken
underneath: ``correct`` must come out true, then false for each fault the
cell's check catches, with the cell's own limits."""

from tiny import run_tiny


def test_serve_sound():
    assert run_tiny("fl70.serve_raw", pool=3)["correct"]


def test_serve_answer_altered(monkeypatch):
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline

    fetch = FusedVolumePipeline.fetch
    monkeypatch.setattr(FusedVolumePipeline, "fetch",
                        staticmethod(lambda d: fetch(d) + 0.05))
    res = run_tiny("fl70.serve_raw", pool=3)
    assert not res["correct"]
    assert res["checks"]["map_gap_mean"]["value"] > res["checks"]["map_gap_mean"]["limit"]


def test_infer_sound():
    res = run_tiny("fl70.infer_stage", cases=3)
    assert res["correct"] and res["failed"] == 0


def test_infer_map_altered(monkeypatch):
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer

    fetch = SlidingWindowInferencer.fetch
    monkeypatch.setattr(SlidingWindowInferencer, "fetch", staticmethod(lambda d: fetch(d) * 0.9))
    assert not run_tiny("fl70.infer_stage", cases=3)["correct"]


def test_infer_candidate_altered(monkeypatch):
    import light_unet_tpu_torch.core.inferencer as inf

    def shifted(fn):
        def wrapped(*a, **k):
            boxes = fn(*a, **k)
            if boxes:
                boxes[0] = dict(boxes[0], bbox_voxel=[v + 1 for v in boxes[0]["bbox_voxel"]])
            return boxes
        return wrapped

    monkeypatch.setattr(inf, "bboxes_from_table", shifted(inf.bboxes_from_table))
    monkeypatch.setattr(inf, "extract_bboxes", shifted(inf.extract_bboxes))
    res = run_tiny("fl70.infer_stage", cases=3)
    assert not res["correct"] and res["checks"]["bbox_mismatch"]["value"] > 0


def test_infer_one_window_altered(monkeypatch):
    """One window's voxels off by a little: under the mean gap's limit over
    the volume, over the window gap's limit."""
    from cellbench import harness
    from light_unet_tpu_torch.ops.sliding_window import SlidingWindowInferencer
    from tiny import tiny

    limits = harness.load_json("workloads", "fl70.infer_stage")["limits"]
    shape = [40, 40, 64]
    config, workload = tiny("fl70.infer_stage", cases=2, shape=shape)
    patch = config["config"]["data"]["patch_size"]
    share = (patch[0] * patch[1] * patch[2]) / float(shape[0] * shape[1] * shape[2])
    delta = 0.5 * (limits["map_gap_window"] + limits["map_gap_mean"] / share)
    assert limits["map_gap_window"] < delta < limits["map_gap_mean"] / share
    fetch = SlidingWindowInferencer.fetch

    def altered(d):
        out = fetch(d).copy()
        out[:patch[0], :patch[1], :patch[2]] += delta
        return out

    monkeypatch.setattr(SlidingWindowInferencer, "fetch", staticmethod(altered))
    checks = run_tiny("fl70.infer_stage", cases=2, shape=shape)["checks"]
    assert checks["map_gap_mean"]["value"] <= checks["map_gap_mean"]["limit"]
    assert checks["map_gap_window"]["value"] > checks["map_gap_window"]["limit"]
