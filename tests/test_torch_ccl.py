"""PyTorch port, connected-component labels (``ops/ccl_kernel.py``,
``csrc/ccl.cu``) on the CPU.

The card's path is the union-find kernel; the CPU's is its plain version,
the JAX package's sweeps.  Here the plain version is held bit for bit
against ``light_unet_tpu/ops/ccl.py:label_propagate`` on drawn masks and on
adversarial ones (a serpentine that takes dozens of sweep rounds, one large
component, many one-voxel components, empty, full), and the kernel's
block-based algorithm, mirrored in numpy with its tiles as a parameter (so
that small masks cross many tiles) and its unions, face merges and
finalize in random orders (the races of the card), is held against the
plain version and against JAX at several tile sizes.  The kernel itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13)."""

import re
from pathlib import Path

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


KERNEL_TILE = (8, 8, 32)  # csrc/ccl.cu's kTZ, kTY, kTX
TILES = [(2, 4, 8), (3, 5, 4), (1, 2, 1), KERNEL_TILE]


def union_find_mirror(mask: np.ndarray, rng, tile=KERNEL_TILE) -> np.ndarray:
    """``csrc/ccl.cu``'s algorithm with tiles of ``tile`` = (tz, ty, tx)
    voxels (the ragged edge of each axis counts as background), the races
    of the card as random orders.  The global forest is the label array: a
    slot holds the parent's flat index + 1, the background 0.

    - ``ccl_tile``: a tile with no foreground is 0, one all foreground takes
      its last voxel as every voxel's root.  Else the nodes of a forest of
      local indices are the last voxels of the runs along the last axis;
      each contact segment with the -y row inside the tile unites the
      parents of the two runs' nodes, a row after the other of each plane
      (each distinct pair once, in random order; finds halve their paths,
      the smaller root is hooked under the larger), every node is pointed at
      its root, then the same with the -z row, the rows in random order;
      each voxel's slot gets its run's root's flat index + 1;
    - ``ccl_faces``: the contacts across each tile's -z, -y and -x faces,
      less those made through the voxel to the left (-z, -y) or at -y inside
      the tile (-x); a face row (a warp) at a time, in random order, reads
      the slot pairs of its contacts, and each pair not yet united by its
      tile's block unites once, in random order;
    - ``ccl_finalize``: 32 consecutive voxels (a warp) at a time in random
      order: each run of neighbouring voxels holding one slot walks to its
      root once, and the voxels store root + 1 in their own slots, which
      later walks read."""
    d, h, w = mask.shape
    tz, ty, tx = tile
    fg = mask > 0
    n = fg.size
    forest = np.zeros(n, np.int64)

    def on(z, y, x):
        return 0 <= z < d and 0 <= y < h and 0 <= x < w and bool(fg[z, y, x])

    def find_local(par, i):
        while par[i] != i:
            if par[par[i]] != par[i]:
                par[i] = par[par[i]]
            i = par[i]
        return i

    def unite_local(par, a, b):
        a, b = find_local(par, a), find_local(par, b)
        while a != b:
            a, b = min(a, b), max(a, b)
            if par[a] == a:  # the shared atomicCAS
                par[a] = b
                return
            a = find_local(par, par[a])

    def unite_rows(t, end, par, step, rows):
        """Each row (a warp) reads the parents of the nodes of its contact
        segments with the row ``step`` below and unites each distinct pair
        once, in random order, the rows in the order given; then every node
        is pointed at its root."""
        for zl, yl in rows:
            first = (zl * ty + yl) * tx
            pairs = list(dict.fromkeys(
                (par[end[v]], par[end[v - step]]) for v in range(first, first + tx)
                if t[v] and t[v - step] and not (v % tx and t[v - 1] and t[v - 1 - step])))
            for k in rng.permutation(len(pairs)):
                unite_local(par, *pairs[k])
        for v in np.unique(end[t]):
            par[v] = find_local(par, v)

    tiles = [(z0, y0, x0) for z0 in range(0, d, tz) for y0 in range(0, h, ty)
             for x0 in range(0, w, tx)]
    for z0, y0, x0 in tiles:
        t = np.zeros(tile, bool)
        sub = fg[z0:z0 + tz, y0:y0 + ty, x0:x0 + tx]
        t[: sub.shape[0], : sub.shape[1], : sub.shape[2]] = sub
        t = t.reshape(-1)
        end = np.arange(t.size)  # each voxel's run's last voxel
        for v in range(t.size - 2, -1, -1):
            if t[v] and t[v + 1] and (v + 1) % tx:
                end[v] = end[v + 1]
        par = np.arange(t.size)
        if t.all():
            end[:] = t.size - 1
        else:
            # the -y row, a plane's rows in order; then the -z row, all at once
            unite_rows(t, end, par, tx, [(zl, yl) for zl in range(tz) for yl in range(1, ty)])
            zs = [(zl, yl) for zl in range(1, tz) for yl in range(ty)]
            unite_rows(t, end, par, ty * tx, [zs[k] for k in rng.permutation(len(zs))])
        for v in np.flatnonzero(t):
            root = par[end[v]]
            z, y, x = z0 + v // (ty * tx), y0 + v // tx % ty, x0 + v % tx
            rz, ry, rx = z0 + root // (ty * tx), y0 + root // tx % ty, x0 + root % tx
            forest[(z * h + y) * w + x] = (rz * h + ry) * w + rx + 1

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
            a, b = min(a, b), max(a, b)
            if forest[a] == a + 1:  # the atomicCAS
                forest[a] = b + 1
                return
            a = find(forest[a] - 1)

    warps = []  # each: (its tile, the (voxel, neighbour) contacts of one face row)
    for tid, (z0, y0, x0) in enumerate(tiles):
        xs = range(x0, min(x0 + tx, w))
        if z0 > 0:  # -z face
            warps += [(tid, [((z0 * h + y) * w + x, ((z0 - 1) * h + y) * w + x) for x in xs
                             if on(z0, y, x) and on(z0 - 1, y, x)
                             and not (on(z0, y, x - 1) and on(z0 - 1, y, x - 1))])
                      for y in range(y0, min(y0 + ty, h))]
        if y0 > 0:  # -y face
            warps += [(tid, [((z * h + y0) * w + x, (z * h + y0 - 1) * w + x) for x in xs
                             if on(z, y0, x) and on(z, y0 - 1, x)
                             and not (on(z, y0, x - 1) and on(z, y0 - 1, x - 1))])
                      for z in range(z0, min(z0 + tz, d))]
        if x0 > 0:  # -x face: 32 of the tile's rows a warp
            rows = [(z0 + r // ty, y0 + r % ty) for r in range(tz * ty)]
            for k in range(0, len(rows), 32):
                warps.append((tid, [((z * h + y) * w + x0, (z * h + y) * w + x0 - 1)
                                    for z, y in rows[k:k + 32]
                                    if on(z, y, x0) and on(z, y, x0 - 1)
                                    and not (y > y0 and on(z, y - 1, x0)
                                             and on(z, y - 1, x0 - 1))]))
    united = [set() for _ in tiles]  # each block's pairs
    for k in rng.permutation(len(warps)):
        tid, contacts = warps[k]
        pairs = list(dict.fromkeys((forest[i] - 1, forest[j] - 1) for i, j in contacts))
        for p in rng.permutation(len(pairs)):
            if pairs[p] not in united[tid]:
                united[tid].add(pairs[p])
                unite(*pairs[p])

    for base in rng.permutation(range(0, n, 32)):
        slots = forest[base:base + 32].copy()
        leads = [i for i in range(len(slots)) if i == 0 or slots[i - 1] != slots[i]]
        roots = {}
        for i in rng.permutation(leads):
            cur = slots[i] - 1
            while slots[i] and forest[cur] - 1 > cur:
                cur = forest[cur] - 1
            roots[i] = cur
        for i in rng.permutation(len(slots)):
            root = roots[max(j for j in leads if j <= i)]
            if slots[i] and root + 1 != slots[i]:
                forest[base + i] = root + 1
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


def mirror_masks() -> dict:
    """The adversarial masks, a percolating random mask (6-connected site
    percolation sets in near 0.31 on the cubic lattice) and a ragged one
    whose last axis crosses the kernel's 32, neither dividing any tile."""
    rng = np.random.default_rng(23)
    masks = dict(adversarial_masks())
    masks["percolating"] = (rng.random((9, 10, 11)) < 0.6).astype(np.uint8)
    masks["ragged"] = (rng.random((7, 9, 37)) < 0.45).astype(np.uint8)
    return masks


def _check_mirror(mask, rng, tile):
    want = ccl_kernel.sweep_labels(torch.from_numpy(mask)).numpy()
    got = union_find_mirror(mask, rng, tile)
    np.testing.assert_array_equal(got, want, err_msg=f"tile {tile}")
    np.testing.assert_array_equal(got, _jax_labels(mask), err_msg=f"tile {tile}")


@pytest.mark.parametrize("name", sorted(mirror_masks()))
def test_union_find_algorithm_equals_the_plain_version(name):
    """Whatever the tiles and the order of the unions, the kernel's
    algorithm labels each component with its largest flat index + 1."""
    mask = mirror_masks()[name]
    rng = np.random.default_rng(17)
    for tile in TILES:
        for _ in range(2):
            _check_mirror(mask, rng, tile)


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_union_find_algorithm_on_drawn_masks(data):
    shape = data.draw(st.sampled_from(SHAPES))
    mask = data.draw(arrays(np.uint8, shape, elements=st.integers(0, 1)))
    seed = data.draw(st.integers(0, 2**31 - 1))
    _check_mirror(mask, np.random.default_rng(seed), (2, 3, 4))


@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_union_find_algorithm_on_drawn_tile_sizes(data):
    shape = data.draw(st.sampled_from(SHAPES))
    mask = data.draw(arrays(np.uint8, shape, elements=st.integers(0, 1)))
    tile = tuple(data.draw(st.integers(1, k)) for k in (4, 4, 8))
    seed = data.draw(st.integers(0, 2**31 - 1))
    _check_mirror(mask, np.random.default_rng(seed), tile)


def test_the_mirror_tiles_as_the_kernel_does():
    """``KERNEL_TILE`` is the tile of ``csrc/ccl.cu``."""
    src = (Path(ccl_kernel.__file__).resolve().parent.parent / "csrc/ccl.cu").read_text()
    m = re.search(r"constexpr int kTZ = (\d+), kTY = (\d+), kTX = (\d+);", src)
    assert m and tuple(map(int, m.groups())) == KERNEL_TILE


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
