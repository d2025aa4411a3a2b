"""Checkpoint reading (port of ``light_unet_tpu/core/checkpoint.py:52-82``).

Reads the JAX package's ``LU3DTPU1`` file: the 8-byte magic, a ``<Q``
header length, a JSON header, then a flax msgpack blob whose arrays are
msgpack ext type 1 ``(shape, dtype name, C-order bytes)``.  ``msgpack`` is
imported only here, when such a file is read.  A reference ``.pth`` goes
to ``tools.weights.load_reference_pth``.  Either way the result is this
package's ``state_dict``.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Tuple

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
