"""The work of one U-Net forward, frozen for the benchmark.

A copy of ``light_unet_tpu_torch/models/cost.py:forward_cost`` as it stood
when the benchmark was defined, reading the model's widths from the
configuration's ``model`` group instead of the program's model.  The count
does not depend on the route that computes the forward, so any route's
time divides the same work.

* **Operations** are 2 x the multiply-accumulates of every convolution:
  depthwise 3^3, pointwise 1^3, grouped or plain 3^3, the 1^3 shortcuts,
  the 2^3 stride-2 transposed convs and the 1^3 head: the count of
  ``torch.utils.flop_counter.FlopCounterMode``.  Norms, activations,
  pooling and adds are not counted.
* **Bytes** assume perfect fusion inside a residual block: a block moves
  ``(cin + 3 c)`` activations a voxel.  Between blocks each op reads its
  input and writes its output once (max-pool, transposed conv, the head's
  float32 output).  The float32 parameters are read once.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union


def _conv3_flops(model: Dict, cin: int, c: int, s: int, grouped: bool) -> int:
    if model.get("use_depthwise_separable", True):
        return 2 * 27 * cin * s + 2 * cin * c * s
    g = int(model.get("groups", 8))
    if not (grouped and model.get("use_grouped_conv", True) and g > 1 and cin >= g and c >= g):
        g = 1
    return 2 * 27 * (cin // g) * c * s


def _block(model: Dict, name: str, batch: int, cin: int, c: int, s: int, itemsize: int,
           grouped: bool = True) -> Dict:
    flops = _conv3_flops(model, cin, c, s, grouped) + _conv3_flops(model, c, c, s, grouped)
    if cin != c:
        flops += 2 * cin * c * s  # shortcut 1^3
    return dict(op=name, flops=batch * flops, bytes=batch * s * (cin + 3 * c) * itemsize)


def forward_terms(model: Dict, batch: int, patch: Union[int, Sequence[int]],
                  itemsize: int = 2) -> List[Dict]:
    """One row per op of the forward (``op``, ``flops``, ``bytes``) for
    ``batch`` patches; ``itemsize`` is the activations' bytes (2: bf16)."""
    dims = (patch,) * 3 if isinstance(patch, int) else tuple(int(p) for p in patch)
    ch = list(model["encoder_channels"])
    sizes = [dims]
    for _ in range(3):
        sizes.append(tuple(n // 2 for n in sizes[-1]))
    vox = [a * b * c for a, b, c in sizes]
    rows = [_block(model, "init_conv", batch, 1, ch[0], vox[0], itemsize, grouped=False)]
    for lv in range(1, 4):
        rows.append(dict(op=f"down{lv}.pool", flops=0,
                         bytes=batch * ch[lv - 1] * (vox[lv - 1] + vox[lv]) * itemsize))
        rows.append(_block(model, f"down{lv}", batch, ch[lv - 1], ch[lv], vox[lv], itemsize))
    rows.append(_block(model, "bottleneck", batch, ch[3], ch[3], vox[3], itemsize))
    cin = ch[3]
    for i, lv in enumerate((2, 1, 0), start=1):
        half = cin // 2
        up_vox = 8 * vox[lv + 1]
        rows.append(dict(op=f"up{i}.up", flops=2 * cin * half * up_vox * batch,
                         bytes=batch * (cin * vox[lv + 1] + half * up_vox) * itemsize))
        rows.append(_block(model, f"up{i}", batch, half + ch[lv], ch[lv], vox[lv], itemsize))
        cin = ch[lv]
    out = int(model.get("output_channels", 1))
    rows.append(dict(op="out_conv", flops=2 * ch[0] * out * vox[0] * batch,
                     bytes=batch * vox[0] * (ch[0] * itemsize + out * 4)))
    return rows


def forward_cost(model: Dict, batch: int, patch: Union[int, Sequence[int]], itemsize: int = 2,
                 n_params: int = 0) -> Tuple[int, int]:
    """(operations, bytes) of one forward of ``batch`` patches, with
    ``n_params`` float32 parameters read once."""
    rows = forward_terms(model, batch, patch, itemsize)
    return sum(r["flops"] for r in rows), sum(r["bytes"] for r in rows) + 4 * int(n_params)
