"""The benchmark's own NIfTI-1 reader and writer (single file, little-endian).

The benchmark writes its inputs and reads the program's outputs through
this module, never through the program's codec, so that a change to the
program's codec cannot change what is judged.  It writes what a scanner
export holds: a 348-byte header, ``vox_offset`` 352, an sform of the voxel
spacing, the voxels in Fortran order, gzip level 1 for ``.nii.gz``.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Sequence, Tuple

import numpy as np

CODES = {np.dtype(np.uint8): 2, np.dtype(np.int16): 4, np.dtype(np.float32): 16,
         np.dtype(np.float64): 64, np.dtype(np.uint16): 512}
DTYPES = {v: k for k, v in CODES.items()}


def header(shape: Sequence[int], dtype, spacing: Sequence[float]) -> bytes:
    """A NIfTI-1 header of a 3-D volume (sform = diag(spacing))."""
    dtype = np.dtype(dtype)
    buf = bytearray(348)
    struct.pack_into("<i", buf, 0, 348)
    buf[38] = ord("r")
    struct.pack_into("<8h", buf, 40, 3, *shape, 1, 1, 1, 1)
    struct.pack_into("<2h", buf, 70, CODES[dtype], dtype.itemsize * 8)
    struct.pack_into("<8f", buf, 76, 1.0, *spacing, 1.0, 0.0, 0.0, 0.0)
    struct.pack_into("<3f", buf, 108, 352.0, 1.0, 0.0)
    struct.pack_into("<2h", buf, 252, 0, 1)  # qform 0, sform 1 (scanner)
    srow = np.zeros((3, 4))
    srow[0, 0], srow[1, 1], srow[2, 2] = spacing
    struct.pack_into("<12f", buf, 280, *srow.ravel())
    buf[344:348] = b"n+1\x00"
    return bytes(buf)


def write(path, data: np.ndarray, spacing: Sequence[float] = (4.0, 4.0, 4.0)) -> None:
    """Write ``data`` (3-D) as ``path`` (``.nii`` or ``.nii.gz``)."""
    path = Path(path)
    data = np.asarray(data)
    payload = header(data.shape, data.dtype, spacing) + b"\x00" * 4 + data.tobytes(order="F")
    if path.name.endswith(".gz"):
        with open(path, "wb") as raw, gzip.GzipFile(fileobj=raw, mode="wb", mtime=0,
                                                      compresslevel=1) as f:
            f.write(payload)
    else:
        path.write_bytes(payload)


def read(path) -> Tuple[np.ndarray, Tuple[float, float, float]]:
    """(array in its stored dtype with scl scaling applied, spacing)."""
    path = Path(path)
    blob = path.read_bytes()
    if blob[:2] == b"\x1f\x8b":
        blob = gzip.decompress(blob)
    if struct.unpack_from("<i", blob, 0)[0] != 348:
        raise ValueError(f"{path}: not a little-endian NIfTI-1 file")
    ndim, *dims = struct.unpack_from("<8h", blob, 40)
    code = struct.unpack_from("<h", blob, 70)[0]
    pixdim = struct.unpack_from("<8f", blob, 76)
    offset, slope, inter = struct.unpack_from("<3f", blob, 108)
    shape = tuple(int(d) for d in dims[:ndim])
    dtype = DTYPES[code]
    n = int(np.prod(shape))
    arr = np.frombuffer(blob, dtype=dtype, count=n, offset=int(offset)).reshape(shape, order="F")
    if slope not in (0.0, 1.0) or inter != 0.0:
        arr = arr * np.float32(slope) + np.float32(inter)
    return np.ascontiguousarray(arr), tuple(float(p) for p in pixdim[1:4])
