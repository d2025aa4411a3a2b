"""The work of one SwinUNETR forward, frozen for the benchmark.

A copy of ``light_unet_tpu_torch/models/cost.py:swin_forward_terms`` as it
stood when the cell was defined, reading the widths from the
configuration's ``model`` group.  The count does not depend on what
computes the forward.

* **Operations** are 2 x the multiply-accumulates of every convolution and
  transposed convolution, of the qkv and proj linears over the padded
  windows, of ``q k^T`` and ``attn v`` of every head over the padded
  windows, of the merges' reductions and of the MLPs over the unpadded
  tokens: the count of ``torch.utils.flop_counter.FlopCounterMode`` over
  the plain reference.  Norms, softmax, GELU, rolls, pads and gathers are
  not counted.
* **Bytes**: each linear and convolution reads its input and writes its
  output once (a decoder block moves ``(cin + 3 c)`` activations a voxel,
  fused inside); an MLP reads its input and writes its output; the
  attention reads q, k and v, writes its output and reads the float32 bias
  table once: the least any attention kernel moves.  The float32 parameters
  are read once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

PATCH = 2  # the patch embedding's kernel and stride (MONAI's SwinUNETR)


def _vol(d) -> int:
    return d[0] * d[1] * d[2]


def _stages(dims, window: int):
    out = []
    for _ in range(4):
        ws = tuple(d if d <= window else window for d in dims)
        pad = tuple(-(-d // w) * w for d, w in zip(dims, ws))
        out.append((dims, pad, ws[0] * ws[1] * ws[2]))
        dims = tuple(-(-d // 2) for d in dims)
    return out


def forward_terms(model: Dict, batch: int, patch: Union[int, Sequence[int]],
                  itemsize: int = 2) -> List[Dict]:
    """One row per op (``op``, ``kind``: conv, attention, linear or mlp,
    ``flops``, ``bytes``) for ``batch`` patches; ``itemsize`` is the
    activations' bytes (2: bf16)."""
    dims = (patch,) * 3 if isinstance(patch, int) else tuple(int(p) for p in patch)
    fs, pe, window = int(model["feature_size"]), PATCH, int(model["window_size"])
    rows = []

    def add(op, kind, flops, nbytes):
        rows.append(dict(op=op, kind=kind, flops=batch * flops, bytes=batch * nbytes))

    def res_block(op, cin, c, vox):
        flops = 2 * 27 * cin * c * vox + 2 * 27 * c * c * vox + (2 * cin * c * vox if cin != c else 0)
        add(op, "conv", flops, vox * (cin + 3 * c) * itemsize)

    def linear(op, kind, cin, c, tokens):
        add(op, kind, 2 * cin * c * tokens, tokens * (cin + c) * itemsize)

    emb = tuple(d // pe for d in dims)
    add("swin.embed", "conv", 2 * fs * pe ** 3 * _vol(emb), (_vol(dims) + fs * _vol(emb)) * itemsize)
    stages = _stages(emb, window)
    for i, ((sd, pad, n), depth, heads) in enumerate(zip(stages, model["depths"], model["num_heads"])):
        d, name = fs * 2 ** i, f"swin.stage{i + 1}"
        real, padded, hidden = _vol(sd), _vol(pad), int(d * float(model["mlp_ratio"]))
        for j in range(int(depth)):
            linear(f"{name}.{j}.qkv", "linear", d, 3 * d, padded)
            rows.append(dict(op=f"{name}.{j}.attn", kind="attention",
                             flops=batch * 4 * padded * n * d,
                             bytes=batch * 4 * padded * d * itemsize
                             + 4 * (2 * window - 1) ** 3 * int(heads)))
            linear(f"{name}.{j}.proj", "linear", d, d, padded)
            add(f"{name}.{j}.mlp", "mlp", 4 * d * hidden * real, real * 2 * d * itemsize)
        linear(f"{name}.merge", "linear", 8 * d, 2 * d, _vol(tuple(-(-x // 2) for x in sd)))
    size = [dims, emb] + [tuple(-(-x // 2) for x in s[0]) for s in stages]
    for op, cin, c, lv in (("encoder1", 1, fs, 0), ("encoder2", fs, fs, 1),
                           ("encoder3", 2 * fs, 2 * fs, 2), ("encoder4", 4 * fs, 4 * fs, 3),
                           ("encoder10", 16 * fs, 16 * fs, 5)):
        res_block(op, cin, c, _vol(size[lv]))
    for op, cin, c, lv in (("decoder5", 16 * fs, 8 * fs, 4), ("decoder4", 8 * fs, 4 * fs, 3),
                           ("decoder3", 4 * fs, 2 * fs, 2), ("decoder2", 2 * fs, fs, 1),
                           ("decoder1", fs, fs, 0)):
        vin = _vol(size[lv + 1])
        add(f"{op}.up", "conv", 2 * cin * c * 8 * vin, (cin * vin + c * 8 * vin) * itemsize)
        res_block(op, 2 * c, c, _vol(size[lv]))
    out = int(model.get("output_channels", 1))
    add("out", "conv", 2 * fs * out * _vol(dims), _vol(dims) * (fs * itemsize + out * 4))
    return rows


def forward_cost(model: Dict, batch: int, patch: Union[int, Sequence[int]], itemsize: int = 2,
                 n_params: int = 0) -> Tuple[int, int]:
    """(operations, bytes) of one forward of ``batch`` patches, with
    ``n_params`` float32 parameters read once."""
    rows = forward_terms(model, batch, patch, itemsize)
    return sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows) + 4 * int(n_params)


def attention_cost(model: Dict, batch: int, patch: Union[int, Sequence[int]],
                   itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of the window attention alone (``kind``
    attention): what its kernels have to do."""
    rows = [r for r in forward_terms(model, batch, patch, itemsize) if r["kind"] == "attention"]
    return sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows)
