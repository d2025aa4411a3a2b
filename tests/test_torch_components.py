"""PyTorch port: device CCL and candidate extraction, held against the JAX
package on the CPU (labels and integer columns exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from light_unet_tpu.core.inferencer import extract_bboxes as jax_extract_bboxes
from light_unet_tpu.ops.ccl import label_propagate as jax_label_propagate
from light_unet_tpu.ops.components import bboxes_from_table as jax_bboxes_from_table
from light_unet_tpu.ops.components import component_table_device as jax_component_table
from light_unet_tpu_torch.core.inferencer import extract_bboxes
from light_unet_tpu_torch.ops.ccl import label_propagate
from light_unet_tpu_torch.ops.components import bboxes_from_table, component_table_device


def _blobby(rng, shape, n_blobs, radius=(1, 3)):
    prob = rng.random(shape).astype(np.float32) * 0.25
    zz, yy, xx = np.ogrid[: shape[0], : shape[1], : shape[2]]
    for _ in range(n_blobs):
        c = [rng.integers(0, s) for s in shape]
        r = rng.uniform(*radius)
        blob = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2 <= r * r
        prob[blob] = rng.uniform(0.35, 1.0)
    return prob


@pytest.mark.parametrize("density", [0.2, 0.45, 0.6])
def test_label_propagate_matches_jax(rng, density):
    """Random masks (tortuous components): the same labels, voxel for voxel."""
    mask = (rng.random((12, 14, 20)) < density).astype(np.int32)
    got = label_propagate(torch.from_numpy(mask)).numpy()
    want = np.asarray(jax_label_propagate(jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    _, n = ndimage.label(mask)
    assert len(np.unique(got[got > 0])) == n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_component_table_and_bboxes_match_jax(seed):
    rng = np.random.default_rng(seed)
    prob = _blobby(rng, (24, 24, 40), n_blobs=12)
    table, n = component_table_device(torch.from_numpy(prob), 0.3)
    jtable, jn = jax_component_table(jnp.asarray(prob), jnp.float32(0.3))
    assert int(n) == int(jn) > 3
    table, jtable = table.numpy(), np.asarray(jtable)
    int_cols = [0, 1, 2, 3, 4, 5, 6, 11]
    np.testing.assert_array_equal(table[:, int_cols], jtable[:, int_cols])
    np.testing.assert_array_equal(table[:, 7], jtable[:, 7])  # max prob
    np.testing.assert_allclose(table[:, 8:11], jtable[:, 8:11], rtol=0, atol=1e-6)
    kw = dict(min_volume_cc=0.5, spacing=[4.0, 4.0, 4.0], expansion_voxels=3)
    got = bboxes_from_table(table, int(n), prob.shape, **kw)
    assert got == jax_bboxes_from_table(jtable, int(jn), prob.shape, **kw)
    assert got == jax_extract_bboxes(prob, 0.3, **kw)


def test_component_overflow_falls_back_to_host(rng):
    """More than 64 components: the count stays exact, the table path
    refuses, and the host path gives the JAX package's boxes."""
    prob = np.zeros((24, 24, 40), np.float32)
    prob[::3, ::3, ::4] = 0.9  # 8 * 8 * 10 isolated voxels
    table, n = component_table_device(torch.from_numpy(prob), 0.3)
    jtable, jn = jax_component_table(jnp.asarray(prob), jnp.float32(0.3))
    assert int(n) == int(jn) == 640
    np.testing.assert_array_equal(table.numpy()[:, :7], np.asarray(jtable)[:, :7])
    kw = dict(min_volume_cc=0.0, spacing=[4.0, 4.0, 4.0], expansion_voxels=3)
    assert bboxes_from_table(table.numpy(), int(n), prob.shape, **kw) is None
    host = extract_bboxes(prob, 0.3, **kw)
    assert len(host) == 640 and host == jax_extract_bboxes(prob, 0.3, **kw)


def test_empty_and_full_masks():
    empty = torch.zeros((8, 8, 8))
    table, n = component_table_device(empty, 0.5)
    assert int(n) == 0 and float(table[:, 0].sum()) == 0.0
    full = torch.ones((8, 8, 8))
    table, n = component_table_device(full, 0.5)
    assert int(n) == 1 and float(table[1, 0]) == 512.0
