"""The work of one MedNeXt forward, frozen for the benchmark.

A copy of ``light_unet_tpu_torch/models/cost.py:mednext_forward_terms`` and
``mednext_depthwise_cost`` as they stood when the cell was defined, reading
the widths from the configuration's ``model`` group.  The count does not
depend on what computes the forward.

* **Operations** are 2 x the multiply-accumulates of every convolution and
  transposed convolution (a transposed conv's over its input's voxels): the
  count of ``torch.utils.flop_counter.FlopCounterMode`` over the plain
  reference.  GroupNorm, GELU, pads and adds are not counted.
* **Bytes**: a depthwise or resampling conv reads its input and writes its
  output once; a block's expansion MLP with its norm, residual and the
  Down's R or the Up's RT and skip add fused reads the depthwise conv's
  output and the residual and writes the block's output (an Up the padded
  (2n)^3 output); the stem reads one channel, the head writes float32; the
  float32 parameters are read once.  The block depthwise convs alone
  (``depthwise_cost``): their input read, their output written, their
  float32 weights and biases read once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union


def _widths(model: Dict) -> List[int]:
    n = int(model["n_channels"])
    return [n, 2 * n, 4 * n, 8 * n, 16 * n, 8 * n, 4 * n, 2 * n, n]


def forward_terms(model: Dict, batch: int, patch: Union[int, Sequence[int]],
                  itemsize: int = 2) -> List[Dict]:
    """One row per op (``op``, ``kind``: depthwise, pointwise, resample or
    head, ``flops``, ``bytes``) for ``batch`` patches; ``itemsize`` is the
    activations' bytes (2: bf16)."""
    dims = (patch,) * 3 if isinstance(patch, int) else tuple(int(p) for p in patch)
    k3 = int(model["kernel_size"]) ** 3
    width, r = _widths(model), [int(v) for v in model["exp_r"]]
    counts = [int(v) for v in model["block_counts"]]
    vox = [dims[0] * dims[1] * dims[2] // 8 ** lv for lv in range(5)]
    rows = []

    def add(op, kind, flops, nbytes):
        rows.append(dict(op=op, kind=kind, flops=batch * flops, bytes=batch * nbytes * itemsize))

    def blocks(name, i, lv):
        c, v = width[i], vox[lv]
        for j in range(counts[i]):
            add(f"{name}.{j}.conv1", "depthwise", 2 * k3 * c * v, 2 * c * v)
            add(f"{name}.{j}.mlp", "pointwise", 2 * 2 * c * r[i] * c * v, 3 * c * v)

    add("stem", "pointwise", 2 * width[0] * vox[0], (1 + width[0]) * vox[0])
    for i in range(4):
        blocks(f"enc_block_{i}", i, i)
        c, c2, ri, v_in, v = width[i], 2 * width[i], r[i + 1], vox[i], vox[i + 1]
        add(f"down_{i}.conv1", "resample", 2 * k3 * c * v, c * (v_in + v))
        add(f"down_{i}.mlp", "pointwise", 2 * (c * ri * c + ri * c * c2 + c * c2) * v,
            (2 * c + c2) * v)
    blocks("bottleneck", 4, 4)
    for j, i in enumerate((3, 2, 1, 0)):
        c, c2, ri, v_in, v = width[4 + j], width[5 + j], r[5 + j], vox[i + 1], vox[i]
        inner = 1
        for d in dims:
            inner *= 2 * d // 2 ** (i + 1) - 1  # the transposed conv's 2n - 1
        add(f"up_{i}.conv1", "resample", 2 * k3 * c * v_in, c * (v_in + inner))
        add(f"up_{i}.mlp", "pointwise", 2 * (c * ri * c + ri * c * c2) * inner + 2 * c * c2 * v_in,
            c * (inner + v_in) + 2 * c2 * v)
        blocks(f"dec_block_{i}", 5 + j, i)
    out = int(model.get("output_channels", 1))
    rows.append(dict(op="out_0", kind="head", flops=2 * width[0] * out * vox[0] * batch,
                     bytes=batch * vox[0] * (width[0] * itemsize + out * 4)))
    return rows


def forward_cost(model: Dict, batch: int, patch: Union[int, Sequence[int]], itemsize: int = 2,
                 n_params: int = 0) -> Tuple[int, int]:
    """(operations, bytes) of one forward of ``batch`` patches, with
    ``n_params`` float32 parameters read once."""
    rows = forward_terms(model, batch, patch, itemsize)
    return sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows) + 4 * int(n_params)


def depthwise_cost(model: Dict, batch: int, patch: Union[int, Sequence[int]],
                   itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of the block depthwise convs alone (``kind``
    depthwise): their input read and output written, and their float32
    weights and biases read once."""
    rows = [r for r in forward_terms(model, batch, patch, itemsize) if r["kind"] == "depthwise"]
    k3 = int(model["kernel_size"]) ** 3
    params = sum(4 * (k3 + 1) * c * int(n) for c, n in zip(_widths(model), model["block_counts"]))
    return sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows) + params
