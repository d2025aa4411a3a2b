"""PyTorch port, connected-component labels (``ops/ccl_kernel.py``,
``csrc/ccl.cu``) on the CPU.

The card's path is the union-find kernel; the CPU's is its plain version,
the JAX package's sweeps.  Here the plain version is held bit for bit
against ``light_unet_tpu/ops/ccl.py:label_propagate`` on drawn masks and on
adversarial ones (a serpentine that takes dozens of sweep rounds, one large
component, many one-voxel components, empty, full), and the kernel's
algorithm, mirrored step for step in Python with its merges in shuffled
orders (the races of the card), is held against the plain version.  The
kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra.numpy import arrays
from scipy import ndimage

from light_unet_tpu.ops import ccl as jccl
from light_unet_tpu_torch.ops import ccl, ccl_kernel
from tests.torch_ccl_masks import adversarial_masks

SHAPES = [(5, 6, 7), (1, 9, 4), (8, 3, 5)]


def sweep_rounds(mask: np.ndarray) -> int:
    """Rounds of the sweeps until nothing changes (the last one included)."""
    t = torch.from_numpy(mask.astype(np.int64))
    n = t.numel()
    labels = torch.arange(1, n + 1).reshape(t.shape) * (t > 0)
    rounds = 0
    while True:
        prev = labels
        for axis in range(3):
            for reverse in (False, True):
                labels = ccl_kernel._axis_sweep(labels, axis, reverse, n + 1)
        rounds += 1
        if torch.equal(labels, prev):
            return rounds


def union_find_mirror(mask: np.ndarray, rng) -> np.ndarray:
    """``csrc/ccl.cu`` step for step, one voxel at a time, the merges and
    the finalize in random orders.  The forest is the label array: a slot
    holds the parent's flat index + 1, the background 0.  Init points each
    voxel at the last index of its run along the last axis, merge unites
    each voxel with its -y and -z foreground neighbours where the voxel to
    its left did not already (the smaller root hooked under the larger,
    finds halving their paths), finalize walks to the root without writing
    and stores root + 1 in the voxel's own slot, which later walks read."""
    d, h, w = mask.shape
    fg = mask.reshape(-1) > 0
    n = fg.size
    forest = np.zeros(n, np.int64)
    for row in range(d * h):
        end = -1
        for i in range(row * w + w - 1, row * w - 1, -1):
            end = (end if end >= 0 else i) if fg[i] else -1
            forest[i] = end + 1 if fg[i] else 0

    def find(i):
        cur = forest[i] - 1
        if cur == i:
            return i
        prev = i
        while forest[cur] - 1 > cur:
            nxt = forest[cur] - 1
            forest[prev] = nxt + 1
            prev, cur = cur, nxt
        return cur

    def unite(a, b):
        a, b = find(a), find(b)
        while a != b:
            if a > b:
                a, b = b, a
            if forest[a] == a + 1:  # the atomicCAS
                forest[a] = b + 1
                return
            a = find(forest[a] - 1)

    for i in rng.permutation(np.flatnonzero(fg)):
        left = i % w > 0 and fg[i - 1]
        if (i // w) % h > 0 and fg[i - w] and not (left and fg[i - 1 - w]):
            unite(i, i - w)
        if i >= h * w and fg[i - h * w] and not (left and fg[i - 1 - h * w]):
            unite(i, i - h * w)
    for i in rng.permutation(n):
        if forest[i]:
            cur = forest[i] - 1
            while forest[cur] - 1 > cur:
                cur = forest[cur] - 1
            forest[i] = cur + 1
    return forest.astype(np.int32).reshape(mask.shape)


def _jax_labels(mask: np.ndarray) -> np.ndarray:
    return np.asarray(jccl.label_propagate(jnp.asarray(mask)))


@settings(max_examples=30, deadline=None)
@given(data=st.data())
def test_plain_labels_equal_jax_on_drawn_masks(data):
    shape = data.draw(st.sampled_from(SHAPES))
    mask = data.draw(arrays(np.uint8, shape, elements=st.integers(0, 1)))
    got = ccl.label_propagate(torch.from_numpy(mask))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_labels(mask))


@pytest.mark.parametrize("name", sorted(adversarial_masks()))
def test_plain_labels_equal_jax_on_adversarial_masks(name):
    mask = adversarial_masks()[name]
    got = ccl.label_propagate(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, _jax_labels(mask))
    # the labels partition as scipy's do, each the max flat index + 1 of its component
    ref, n = ndimage.label(mask)
    assert len(np.unique(got[mask > 0])) == n
    flat = np.arange(1, mask.size + 1).reshape(mask.shape)
    for c in range(1, min(n, 40) + 1):
        assert (got[ref == c] == flat[ref == c].max()).all()


def test_the_serpentine_takes_more_than_20_sweep_rounds():
    assert sweep_rounds(adversarial_masks()["serpentine"]) > 20


@pytest.mark.parametrize("name", sorted(adversarial_masks()))
def test_union_find_algorithm_equals_the_plain_version(name):
    """Whatever the order of the merges, the kernel's algorithm labels each
    component with its largest flat index + 1."""
    mask = adversarial_masks()[name]
    want = ccl_kernel.sweep_labels(torch.from_numpy(mask)).numpy()
    rng = np.random.default_rng(17)
    for _ in range(3):
        np.testing.assert_array_equal(union_find_mirror(mask, rng), want)


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_union_find_algorithm_on_drawn_masks(data):
    shape = data.draw(st.sampled_from(SHAPES))
    mask = data.draw(arrays(np.uint8, shape, elements=st.integers(0, 1)))
    seed = data.draw(st.integers(0, 2**31 - 1))
    want = ccl_kernel.sweep_labels(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(union_find_mirror(mask, np.random.default_rng(seed)), want)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel (nor counts a launch); any
    foreground value counts, as ``mask > 0``."""
    monkeypatch.setattr(ccl_kernel, "launches", 0)
    mask = adversarial_masks()["random"].astype(np.float32) * 0.7
    got = ccl_kernel.connected_labels(torch.from_numpy(mask))
    assert ccl_kernel.launches == 0 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_labels(mask))


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="3-D CUDA tensor"):
        ccl_kernel.connected_labels(torch.zeros((2, 3, 4), device="meta"))


@pytest.mark.parametrize("name", ["serpentine", "one_large", "many_single_voxels", "empty",
                                  "full"])
def test_keep_largest_and_label_components_on_adversarial_masks(name):
    mask = adversarial_masks()[name]
    got = ccl.keep_largest_component(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jccl.keep_largest_component(jnp.asarray(mask))))
    labeled, n = ccl.label_components(mask, backend="device", device="cpu")
    want, wn = ndimage.label(mask)
    assert n == wn
    np.testing.assert_array_equal(labeled, want)
