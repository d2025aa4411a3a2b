"""Weight layouts: the JAX package's flax tree and reference ``.pth`` files
-> this package's ``state_dict`` (own copy of the mapping in
``light_unet_tpu/tools/port_torch.py:68-194``).

* conv weight: flax ``[kd, kh, kw, in/groups, out]`` -> torch
  ``[out, in/groups, kd, kh, kw]`` (transpose ``(4, 3, 0, 1, 2)``);
* transposed conv: flax ``[kd, kh, kw, in, out]`` holds the spatially
  flipped kernel, so torch ``[in, out, kd, kh, kw]`` is the flip, transposed;
* InstanceNorm ``scale``/``bias`` -> ``weight``/``bias``;
* ``shortcut_conv``/``shortcut_norm`` -> ``shortcut.0``/``shortcut.1``.

Grouped convs keep the plain name ``conv1.weight``; a reference ``.pth``
that wraps them (``conv1.conv.weight``) is renamed on load.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _conv(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k, (4, 3, 0, 1, 2)))


def _conv_transpose(k: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(k[::-1, ::-1, ::-1], (3, 4, 0, 1, 2)))


def _torch_key(path: Tuple[str, ...]) -> Tuple[str, str]:
    """Flax leaf path (without ``params``) -> (torch key, transform tag)."""
    *mods, leaf = path
    prefix = ".".join(mods)
    last = mods[-1] if mods else ""
    base = "".join(f"{m}." for m in mods[:-1])
    if leaf == "kernel":
        if last == "up":
            return f"{prefix}.weight", "convT"
        if last == "shortcut_conv":
            return f"{base}shortcut.0.weight", "conv"
        return f"{prefix}.weight", "conv"
    if leaf in ("scale", "bias"):
        name = "weight" if leaf == "scale" else "bias"
        if last == "shortcut_norm":
            return f"{base}shortcut.1.{name}", "direct"
        return f"{prefix}.{name}", "direct"
    raise KeyError(f"unrecognized flax leaf {'/'.join(path)}")


_TRANSFORMS = {"conv": _conv, "convT": _conv_transpose, "direct": lambda w: w}


def from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax parameter tree (numpy leaves, optionally under ``"params"``) ->
    this package's ``state_dict`` (float32 CPU tensors)."""
    inner = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(inner).items():
        key, tag = _torch_key(path)
        w = _TRANSFORMS[tag](np.asarray(leaf, dtype=np.float32))
        out[key] = torch.tensor(w)
    return out


def is_torch_checkpoint(path) -> bool:
    """Cheap sniff: torch zip archives start with ``PK``; legacy pickles
    with protocol-2 magic ``\\x80\\x02``."""
    try:
        with open(path, "rb") as f:
            head = f.read(2)
    except OSError:
        return False
    return head in (b"PK", b"\x80\x02")


_META_KEYS = ("epoch", "best_metric", "best_recall", "best_dsc", "best_epoch", "history")


def load_reference_pth(path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read a reference ``best_model.pth`` -> ``(state_dict, meta)``.

    Loads with ``weights_only=True``: the file may come from anywhere, and
    the unrestricted unpickler would run its code."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        state_dict = ckpt["model_state_dict"]
    elif isinstance(ckpt, dict) and all(hasattr(v, "shape") for v in ckpt.values()):
        state_dict, ckpt = ckpt, {}
    else:
        raise ValueError(f"{path}: not a reference checkpoint (no model_state_dict)")
    out = {}
    for k, v in state_dict.items():
        if k.endswith("num_batches_tracked"):
            continue
        # the reference wraps grouped convs in a module: conv1.conv.weight
        for conv in ("conv1", "conv2"):
            k = k.replace(f".{conv}.conv.weight", f".{conv}.weight")
        out[k] = v.float()
    meta = {k: v for k, v in ckpt.items() if k in _META_KEYS and isinstance(v, (int, float, str, list, dict))}
    meta["source_format"] = "torch"
    return out, meta
