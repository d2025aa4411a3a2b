"""PyTorch port: the residual-block kernel's weight layouts, on the CPU.

``kernel_weights`` converts a block's weights once per block, dtype and
device and must convert anew after any weight update; ``_as_mma_fragments``
packs a pointwise weight as the B operands of ``mma.m16n8k16`` in the
lane order the PTX ISA gives for that instruction."""

import numpy as np
import pytest
import torch
from torch import nn

from light_unet_tpu_torch.models.unet3d import ResidualBlock, init_weights
from light_unet_tpu_torch.ops import block_kernel as bk

POINTWISE = {"pw1": ("conv1", "pointwise"), "pw2": ("conv2", "pointwise")}


def _block(cin, c, dtype, seed=0):
    blk = ResidualBlock(cin, c, dropout_p=0.0, compute_dtype=dtype).eval()
    return init_weights(blk, torch.Generator().manual_seed(seed))


def _unpack_fragments(frag):
    """Inverse of the mma B-fragment order, written from the PTX layout:
    lane 4g + t holds (k, n) = (2t + i, g) in b0 and (8 + 2t + i, g) in b1."""
    f = frag.float().numpy()
    ks, nt = f.shape[:2]
    w = np.zeros((ks * 16, nt * 8), np.float32)
    for s in range(ks):
        for j in range(nt):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for i in range(2):
                    w[s * 16 + 2 * t + i, j * 8 + g] = f[s, j, lane, i]
                    w[s * 16 + 8 + 2 * t + i, j * 8 + g] = f[s, j, lane, 2 + i]
    return w


def _expected(blk, dtype):
    """Every layout from the plain converters."""
    want = {
        "dw1": bk._as_kernel_weights(blk.conv1.depthwise.weight, dtype, "cpu"),
        "dw2": bk._as_kernel_weights(blk.conv2.depthwise.weight, dtype, "cpu"),
        "pw1": bk._as_kernel_weights(blk.conv1.pointwise.weight, dtype, "cpu"),
        "pw2": bk._as_kernel_weights(blk.conv2.pointwise.weight, dtype, "cpu"),
        "n1s": blk.norm1.weight.float(), "n1b": blk.norm1.bias.float(),
        "n2s": blk.norm2.weight.float(), "n2b": blk.norm2.bias.float(),
    }
    if blk.shortcut is not None:
        want["sc"] = bk._as_kernel_weights(blk.shortcut[0].weight, dtype, "cpu")
        want["nss"], want["nsb"] = blk.shortcut[1].weight.float(), blk.shortcut[1].bias.float()
    return want


def _assert_layout(kw, blk, dtype):
    for name, want in _expected(blk, dtype).items():
        got = kw[name]
        mma = kw["mma2"] if name == "pw2" else kw["mma1"]
        if name in ("pw1", "pw2", "sc") and mma:
            assert got.dtype == torch.bfloat16 and got.is_contiguous()
            got = torch.from_numpy(_unpack_fragments(got))
        assert got.dtype == torch.float32, name
        torch.testing.assert_close(got, want.detach(), rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("cin,c", [(32, 16), (64, 64), (1, 16), (3, 5), (48, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_equal_plain_layouts_and_are_cached(cin, c, dtype):
    blk = _block(cin, c, dtype)
    kw = bk.kernel_weights(blk, dtype, "cpu")
    assert (kw["mma1"], kw["mma2"]) == bk.mma_paths(cin, c, dtype)
    _assert_layout(kw, blk, dtype)
    assert bk.kernel_weights(blk, dtype, "cpu") is kw  # converted once
    other = bk.kernel_weights(blk, torch.float32 if dtype == torch.bfloat16 else torch.bfloat16,
                              "cpu")
    assert other is not kw  # per dtype


@pytest.mark.parametrize("update", ["load_state_dict", "in_place", "replaced", "norm"])
def test_kernel_weights_follow_a_weight_update(update):
    dtype = torch.bfloat16
    blk = _block(32, 64, dtype)
    kw = bk.kernel_weights(blk, dtype, "cpu")
    with torch.no_grad():
        if update == "load_state_dict":
            blk.load_state_dict(_block(32, 64, dtype, seed=1).state_dict())
        elif update == "in_place":
            blk.conv1.pointwise.weight.mul_(-2.0)
        elif update == "replaced":
            blk.conv2.depthwise.weight = nn.Parameter(torch.randn_like(blk.conv2.depthwise.weight))
        else:
            blk.shortcut[1].bias.add_(0.5)
    fresh = bk.kernel_weights(blk, dtype, "cpu")
    assert fresh is not kw
    _assert_layout(fresh, blk, dtype)


@pytest.mark.parametrize("cin,c", [(16, 16), (32, 64), (128, 32), (64, 128)])
def test_mma_fragments_reproduce_the_product(cin, c):
    """The packed fragments hold the bf16 weight, and a product decoded in
    the mma lane order equals the plain one."""
    rng = np.random.default_rng(cin + c)
    w = torch.from_numpy(rng.standard_normal((c, cin, 1, 1, 1)).astype(np.float32))
    frag = bk._as_mma_fragments(w, "cpu")
    assert tuple(frag.shape) == (cin // 16, c // 8, 32, 4)
    wt = torch.from_numpy(_unpack_fragments(frag))
    torch.testing.assert_close(wt, w.reshape(c, cin).t().to(torch.bfloat16).float(), rtol=0, atol=0)
    a = torch.from_numpy(rng.standard_normal((16, cin)).astype(np.float32)).bfloat16().float()
    torch.testing.assert_close(a @ wt, a @ w.reshape(c, cin).t().bfloat16().float())


@pytest.mark.parametrize("cin,c,dtype,want", [
    (32, 16, torch.bfloat16, (True, True)),
    (1, 16, torch.bfloat16, (False, True)),
    (3, 5, torch.bfloat16, (False, False)),
    (48, 16, torch.bfloat16, (False, True)),
    (128, 256, torch.bfloat16, (False, False)),
    (32, 16, torch.float32, (False, False)),
])
def test_mma_paths(cin, c, dtype, want):
    assert bk.mma_paths(cin, c, dtype) == want
