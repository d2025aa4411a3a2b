"""Checkpoints (port of ``light_unet_tpu/core/checkpoint.py``).

Reading: the JAX package's ``LU3DTPU1`` file (the 8-byte magic, a ``<Q``
header length, a JSON header, then a flax msgpack blob whose arrays are
msgpack ext type 1 ``(shape, dtype name, C-order bytes)``; ``msgpack`` is
imported only here, when such a file is read), or a torch ``.pth`` in the
reference's dict layout (``tools.weights.load_reference_pth``).  Either way
the result is this package's ``state_dict``.

Writing: the trainer's checkpoints are torch files in the reference's dict
layout (``model_state_dict``, ``optimizer_state_dict``, ``epoch`` and the
trainer's meta fields), so ``load_checkpoint`` and the serving
``Inferencer`` read them unchanged.  Periodic ones are
``checkpoint_epoch_{n:03d}.ckpt``, rotated to the newest N.  Resume reads
only these: an ``LU3DTPU1`` file there raises a ``ValueError`` that names it.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from light_unet_tpu_torch.tools.weights import (
    from_jax_params,
    is_torch_checkpoint,
    load_reference_pth,
)

_MAGIC = b"LU3DTPU1"
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":  # upper halves of float32 words
        u16 = np.frombuffer(buf, dtype=np.uint16)
        arr = (u16.astype(np.uint32) << 16).view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name))
    return arr.reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    return msgpack.ExtType(code, data)


def read_lu3dtpu1(path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Raw ``(arrays, meta)`` of an ``LU3DTPU1`` file (nested dicts of numpy)."""
    import msgpack

    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise ValueError(f"{path} is not an LU3DTPU1 checkpoint")
        (hlen,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        blob = f.read()
    arrays = msgpack.unpackb(blob, ext_hook=_ext_hook, raw=False)
    return arrays, meta


def load_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(state_dict, meta)`` from an ``LU3DTPU1`` file or a reference ``.pth``."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
    if magic == _MAGIC:
        arrays, meta = read_lu3dtpu1(path)
        return from_jax_params(arrays["params"]), meta
    if is_torch_checkpoint(path):
        return load_reference_pth(path)
    raise ValueError(f"{path} is not a light_unet_tpu checkpoint")


def save_checkpoint(path, model_state_dict: Dict[str, torch.Tensor],
                    optimizer_state_dict: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Write one torch checkpoint: the two state dicts (as CPU copies) and
    the JSON-able ``meta`` fields at the top level of the dict."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def cpu(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree

    blob = {"model_state_dict": cpu(model_state_dict),
            "optimizer_state_dict": cpu(optimizer_state_dict), **meta}
    tmp = path.with_name(path.name + ".tmp")
    torch.save(blob, tmp)
    tmp.replace(path)


def load_training_checkpoint(path) -> Dict[str, Any]:
    """The whole dict of a checkpoint written by ``save_checkpoint`` (for
    resume); tensors and plain values only (``weights_only``).

    An ``LU3DTPU1`` file raises ``ValueError``: the JAX trainer keeps no
    sampler or generator state and saves one schedule step behind, so a
    resume from it would not continue that run.  ``load_checkpoint`` still
    serves its weights."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.read(len(_MAGIC))
    if magic == _MAGIC:
        raise ValueError(
            f"{path} is an {_MAGIC.decode()} checkpoint, written by the JAX trainer "
            "(light_unet_tpu); resume reads only this package's torch checkpoints. "
            "Serve its weights with load_checkpoint, or start a new run.")
    return torch.load(path, map_location="cpu", weights_only=True)


def _epoch_key(path: Path) -> Tuple[int, str]:
    """Numeric sort key (lexicographic order breaks past epoch 999)."""
    stem = path.stem
    try:
        return (int(stem.rsplit("_", 1)[1]), stem)
    except (IndexError, ValueError):
        return (-1, stem)


def rotate_checkpoints(checkpoint_dir, keep_last_n: int,
                       pattern: str = "checkpoint_epoch_*.ckpt") -> None:
    """Delete all but the newest ``keep_last_n`` periodic checkpoints."""
    ckpts = sorted(Path(checkpoint_dir).glob(pattern), key=_epoch_key)
    for old in ckpts[:-keep_last_n] if keep_last_n > 0 else ckpts:
        old.unlink()


def latest_checkpoint(checkpoint_dir, pattern: str = "checkpoint_epoch_*.ckpt") -> Optional[Path]:
    ckpts = sorted(Path(checkpoint_dir).glob(pattern), key=_epoch_key)
    return ckpts[-1] if ckpts else None
