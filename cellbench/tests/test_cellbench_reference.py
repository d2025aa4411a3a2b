"""The plain reference agrees with the program at a tiny size on the CPU:
the U-Net, normalization and body mask, the windowed map and the candidate
table.  float32 on both sides: tolerances are float32 rounding (1e-5), and
1e-4 where the program's map is fetched as uint16 levels (7.6e-6 a level)
after a blend of float32 sums."""

import copy

import numpy as np
import pytest
import torch

from cellbench import common, harness, phantoms, weights
from cellbench.reference import preprocess as ref_pre
from cellbench.reference import table as ref_table
from cellbench.reference.unet import UNet
from tiny import tiny

torch.set_num_threads(2)


def settings(cell="fl70.serve_raw"):
    return tiny(cell)[0]["config"]


def program_model(s, state):
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.models.unet3d import build_model

    cfg = Config.from_dict(s)
    model = build_model(cfg.model, torch.float32, inference=True)
    model.load_state_dict(state)
    return model.eval()


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_unet_inference(seed):
    s = settings()
    state = weights.seeded_state(s["model"], seed, "cpu")
    x = torch.rand(2, 16, 16, 16, generator=torch.Generator().manual_seed(seed))
    ref = UNet(s["model"]).eval()
    ref.load_state_dict(state)
    with torch.no_grad():
        a = ref(x[:, None])[:, 0]
        b = program_model(s, state)(x[..., None])[..., 0]
    assert torch.allclose(a, b, atol=1e-5, rtol=0)


def test_body_mask_equals_the_programs():
    from light_unet_tpu_torch.ops.body_mask import generate_body_mask

    raw = phantoms.make_phantom(np.random.default_rng(5), (40, 36, 52))[0]
    s = settings()
    norm, mask = common.normalized_raw(s, raw)
    prog, _ = generate_body_mask(norm, s["data"]["body_mask"], device="cpu")
    assert mask.sum() > 0 and np.array_equal(mask, prog)


def test_raw_map_equals_the_fused_pipeline():
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline

    s = settings()
    raw = phantoms.make_phantom(np.random.default_rng(6), (24, 24, 40))[0]
    state = weights.seeded_state(s["model"], 6, "cpu")
    cfg = Config.from_dict(s)
    pipe = FusedVolumePipeline(program_model(s, state), cfg, patch_batch=8, device="cpu")
    norm, mask = common.normalized_raw(s, raw)
    ref = common.reference_map(common.reference_net(s, state, "cpu"), s, norm, "cpu", mask)
    assert np.abs(pipe(raw) - ref).max() < 1e-4


def test_candidates_equal_the_programs_host_path():
    from light_unet_tpu_torch.core.inferencer import extract_bboxes

    rng = np.random.default_rng(7)
    prob = rng.random((30, 28, 26)).astype(np.float32)
    prob = (prob + np.roll(prob, 1, 0) + np.roll(prob, 1, 2)) / 3
    for thr in (0.3, 0.5, 0.6):
        ours = ref_table.candidates(prob, thr, 0.5, (4.0, 4.0, 4.0), 3)
        theirs = extract_bboxes(prob, thr, 0.5, (4.0, 4.0, 4.0), 3)
        assert ours and ref_table.mismatches(theirs, ours) == 0


def test_uint16_transfer_round_trips():
    x = np.random.default_rng(8).random((6, 5, 4)).astype(np.float32) * 10
    lo, hi = ref_pre.clip_values(x)
    back = ref_pre.dequantize_u16(ref_pre.transfer_u16(x, lo, hi), lo, hi)
    assert np.abs(back - np.clip(x, lo, hi)).max() <= (hi - lo) / 65535


def test_workload_copy_untouched():
    before = copy.deepcopy(harness.load_json("workloads", "fl70.serve_raw"))
    tiny("fl70.serve_raw")
    assert harness.load_json("workloads", "fl70.serve_raw") == before
