"""PyTorch port, kernel K2 (fused InstanceNorm + LeakyReLU) on the CPU: the
plan that cuts samples into chunks for co-resident CTAs (a pure-Python
mirror of ``instance_norm_plan``, held equal to the C plan by a card test in
``tests/test_torch_cuda.py``), and the wrapper's cache of float32 scales."""

from collections import Counter

import pytest
import torch

from light_unet_tpu_torch.ops import norm_kernel
from torch_norm_plan import H100, assignments, norm_plan

# (B, S, C) at the four serving shapes of a 192-patch forward, then shapes
# off the path: ragged S, odd C, B = 1, B beyond one round, float32 at 48^3
CASES = [
    (192, 48 ** 3, 16), (192, 24 ** 3, 32), (192, 12 ** 3, 64), (192, 6 ** 3, 128),
    (2, 5 * 7 * 9, 3), (3, 6 ** 3, 1), (2, 8 ** 3, 5), (1, 8 ** 3, 16), (64, 16 ** 3, 128),
    (2, 48 ** 3, 16), (5, 33 ** 3, 8), (7, 40 * 41 * 43, 3), (1, 48 ** 3, 128),
]


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,c", CASES, ids=str)
def test_plan_covers_every_row_once(elt, b, s, c):
    plan = norm_plan(elt, b, s, c)
    chunks = assignments(plan, b, s)
    seen = Counter((sample, r0) for _, _, sample, r0, _ in chunks)
    assert len(seen) == b * plan["k"] and set(seen.values()) == {1}
    for sample in range(b):
        spans = sorted((r0, r1) for _, _, smp, r0, r1 in chunks if smp == sample)
        assert spans[0][0] == 0 and spans[-1][1] == s
        assert all(r1 > r0 for r0, r1 in spans)
        assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))  # contiguous


@pytest.mark.parametrize("elt", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("b,s,c", CASES, ids=str)
def test_plan_fits_the_card(elt, b, s, c):
    plan = norm_plan(elt, b, s, c)
    resident = plan["ctas_per_sm"] * plan["sms"]
    assert plan["k"] <= resident and plan["groups"] * plan["k"] <= resident
    assert 1 <= plan["groups"] <= b
    assert plan["smem"] <= H100["smem_per_block"]
    if plan["k"] > 1 and not plan["streams"]:  # chunks are sized for two CTAs per SM
        assert 2 * (plan["smem"] + H100["reserved"]) <= H100["smem_per_sm"]
        assert plan["smem"] >= plan["rows_per_chunk"] * c * elt
    # a CTA of a group waits only on its own group's CTAs, which take the same samples
    rounds = Counter(cta for cta, *_ in assignments(plan, b, s))
    for group in range(plan["groups"]):
        ctas = range(group * plan["k"], (group + 1) * plan["k"])
        assert len({rounds[i] for i in ctas}) == 1


def test_plan_at_the_serving_shapes():
    """k = 1 where a bf16 sample fits one CTA (6^3 x 128, 12^3 x 64); 48^3 x 16
    takes 31 chunks, 8 samples a round (24 rounds at B = 192)."""
    p48 = norm_plan(2, 192, 48 ** 3, 16)
    assert (p48["k"], p48["groups"], p48["ctas_per_sm"]) == (31, 8, 2)
    assert norm_plan(2, 192, 12 ** 3, 64)["k"] == 1
    p6 = norm_plan(2, 192, 6 ** 3, 128)
    assert p6["k"] == 1 and p6["groups"] == 192
    assert norm_plan(4, 192, 6 ** 3, 128)["k"] == 1
    assert norm_plan(4, 2, 48 ** 3, 16)["k"] > 31


@pytest.mark.parametrize("c,threads", [(1, 256), (3, 256), (128, 256), (2048, 256),
                                       (4096, 512), (3000, 384), (1001, 1024)])
def test_plan_threads_follow_channel_lanes(c, threads):
    assert norm_plan(2, 1, 64, c)["threads"] == threads


def test_plan_refuses_more_lanes_than_a_cta_has():
    with pytest.raises(ValueError):
        norm_plan(2, 1, 8, 5001)  # 5001 one-channel lanes > 1024 threads


@pytest.mark.parametrize("elt,b,s,c,streams", [
    (2, 192, 48 ** 3, 16, 0), (4, 192, 48 ** 3, 16, 0), (2, 4, 96 ** 3, 16, 0), (4, 4, 96 ** 3, 16, 1),
    (2, 1, 48 ** 3, 128, 1), (4, 1, 48 ** 3, 16, 1), (4, 1, 64 ** 3, 16, 0),
], ids=str)
def test_plan_streams_only_samples_too_large_to_hold(elt, b, s, c, streams):
    """A sample over the card's shared memory (here 4 SMs for the f32 48^3
    case) is read twice by the whole grid; every serving shape is held."""
    sms = 4 if (elt, s, c) == (4, 48 ** 3, 16) and b == 1 else H100["sms"]
    plan = norm_plan(elt, b, s, c, sms=sms)
    assert plan["streams"] == streams
    if streams:
        assert plan["groups"] * plan["k"] <= plan["ctas_per_sm"] * sms
        assert plan["smem"] < 16 * 1024  # no chunk held on chip


def test_as_f32_passes_float32_through():
    p = torch.randn(16)
    assert norm_kernel.as_f32(p, p.device) is p


def test_as_f32_caches_and_follows_updates():
    p = torch.nn.Parameter(torch.randn(16).to(torch.bfloat16))
    first = norm_kernel.as_f32(p, p.device)
    assert first.dtype == torch.float32 and torch.equal(first, p.detach().float())
    assert norm_kernel.as_f32(p, p.device) is first  # cached
    with torch.no_grad():
        p.mul_(2)                                    # bumps the version
    again = norm_kernel.as_f32(p, p.device)
    assert again is not first and torch.equal(again, p.detach().float())


def test_as_f32_follows_a_non_contiguous_view():
    base = torch.randn(4, 8)
    view = base[:, 0]
    got = norm_kernel.as_f32(view, view.device)
    assert got.is_contiguous() and torch.equal(got, view)
    base[0, 0] += 1.0
    assert torch.equal(norm_kernel.as_f32(view, view.device), view)
