"""Native host I/O (port of ``light_unet_tpu/utils/fastio.py``).

ctypes bindings of ``csrc/fastio.cpp``: NIfTI decode (the library's own
gzip inflate, dtype conversion and scl scaling, the GIL released),
batch decode on a thread pool, exact order-statistic percentiles and the
single-pass uint16 quantize + pad of the serving upload.  Every function
gives the bits of its plain version: ``utils/nifti.py:load`` +
``get_fdata(np.float32)``, ``np.percentile``, and the numpy chain of
``quantize_pad_plain``.

The library is built from the repository's source at first use
(``ops/_build.py:build_host``).  The plain versions serve only the inputs
the library does not take, chosen by the input and never after a failure:
a big-endian file goes to the codec; a non-float32, empty or non-finite
input to ``np.percentile``; a non-float32 or non-3-D image, or one whose
strides or data are not float32-aligned, to the numpy chain.  A build
failure raises, a file the native decode accepted and then failed on
raises ``nifti.NiftiError`` with the file and the error code, and a
missing file raises ``FileNotFoundError``.

``calls`` counts the library's calls by entry (``decode`` counts files),
and ``percentile_plain`` the non-finite float32 inputs that ``percentiles``
handed to ``np.percentile``, so a run can show that its path went through
the library.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from light_unet_tpu_torch.ops import _build
from light_unet_tpu_torch.utils import nifti, tracing

ERRORS = {-1: "cannot open", -2: "corrupt gzip stream", -3: "bad header", -4: "unsupported dtype",
          -5: "truncated", -6: "allocation failed", -7: "non-finite values"}
_ERR_OPEN, _ERR_DATA = -1, -7
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_ENTRIES = {
    # name: (argtypes, restype)
    "fastio_read_header": ([ctypes.c_char_p, _P], _I),
    "fastio_decode": ([ctypes.c_char_p, _P, _L, _P], _L),
    "fastio_decode_batch": ([ctypes.POINTER(ctypes.c_char_p), _I, ctypes.POINTER(_P),
                             ctypes.POINTER(_L), ctypes.POINTER(_P), ctypes.POINTER(_L), _I], None),
    "fastio_gunzip": ([ctypes.c_char_p, _L, _P, _L], _L),
    "fastio_order_stats": ([_P, _L, _P, _I, _P], _I),
    "fastio_quantize_pad": ([_P, _P, _P, _P, _P, _F, _F, _F], _I),
}
# the deflate format's largest expansion: 258 bytes from one 2-bit code
_MAX_INFLATE_RATIO = 1032

calls = {"decode": 0, "order_stats": 0, "percentile_plain": 0, "quantize_pad": 0}
_calls_lock = threading.Lock()  # decode workers count from several threads

_lib = None
_lib_lock = threading.Lock()


def _count(entry: str, n: int = 1) -> None:
    with _calls_lock:
        calls[entry] += n


def load_library() -> ctypes.CDLL:
    """``libfastio.so`` with its C entries bound (built on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build.build_host("fastio")))
            for name, (argtypes, restype) in _ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _error(path, what: str, rc: int) -> nifti.NiftiError:
    return nifti.NiftiError(f"{path}: native {what} failed with code {rc} "
                            f"({ERRORS.get(rc, 'unknown')})")


def read_header(path) -> nifti.Nifti1Header:
    """Parse just the header (a partial inflate for ``.gz``)."""
    lib = load_library()
    buf = (ctypes.c_uint8 * nifti.HEADER_SIZE)()
    rc = lib.fastio_read_header(os.fsencode(path), buf)
    if rc == _ERR_OPEN:
        Path(path).open("rb").close()  # raises the OSError (FileNotFoundError, ...)
    if rc != 0:
        raise _error(path, "header read", rc)
    return nifti.Nifti1Header.parse(bytes(buf))


def _voxel_count(path, hdr: nifti.Nifti1Header) -> Tuple[Tuple[int, ...], int]:
    """(shape, voxel count) of a little-endian header, refused (NiftiError)
    when the dims are out of range or claim more data than the file can
    hold, before any buffer is allocated."""
    shape = hdr.get_data_shape()
    if not 1 <= len(shape) <= 7 or min(shape) < 1:
        raise nifti.NiftiError(f"{path}: bad NIfTI dims {hdr.dim}")
    n = int(np.prod(shape, dtype=object))
    itemsize = nifti._DTYPES[hdr.datatype].itemsize if hdr.datatype in nifti._DTYPES else 1
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    if n * itemsize > (size * _MAX_INFLATE_RATIO if gz else size):
        raise nifti.NiftiError(f"{path}: header claims {n} voxels, more than the file holds")
    return shape, n


def _load_plain(path) -> Tuple[np.ndarray, nifti.Nifti1Header]:
    img = nifti.load(path)
    return img.get_fdata(np.float32), img.header


def load_f32(path) -> Tuple[np.ndarray, nifti.Nifti1Header]:
    """Decode one NIfTI volume to float32 with scl scaling applied (nibabel
    ``get_fdata`` semantics), in the codec's Fortran layout (the span
    ``decode``)."""
    with tracing.span("decode"):
        hdr = read_header(path)
        if hdr.endian != "<":
            return _load_plain(path)
        shape, n = _voxel_count(path, hdr)
        out = np.empty(n, dtype=np.float32)
        hbuf = (ctypes.c_uint8 * nifti.HEADER_SIZE)()
        rc = load_library().fastio_decode(os.fsencode(path),
                                          out.ctypes.data_as(ctypes.c_void_p), n, hbuf)
        _count("decode")
        if rc != n:
            raise _error(path, "decode", rc)
        return out.reshape(shape, order="F"), hdr


def load_batch_f32(paths: Sequence, n_threads: int = 0
                   ) -> List[Tuple[np.ndarray, nifti.Nifti1Header]]:
    """Decode many volumes on native threads (``n_threads`` 0: one per
    core), one call across the ctypes boundary; big-endian files go to the
    codec one by one."""
    headers = [read_header(p) for p in paths]
    results: list = [None] * len(paths)
    native = [i for i, h in enumerate(headers) if h.endian == "<"]
    if native:
        k = len(native)
        caps, dsts = (ctypes.c_int64 * k)(), (ctypes.c_void_p * k)()
        hdrs, cpaths = (ctypes.c_void_p * k)(), (ctypes.c_char_p * k)()
        bufs, hdr_bufs, shapes = [], [], []
        for j, i in enumerate(native):
            shape, n = _voxel_count(paths[i], headers[i])
            arr = np.empty(n, dtype=np.float32)
            hb = (ctypes.c_uint8 * nifti.HEADER_SIZE)()
            bufs.append(arr)
            hdr_bufs.append(hb)
            shapes.append(shape)
            caps[j] = n
            dsts[j] = arr.ctypes.data
            hdrs[j] = ctypes.addressof(hb)
            cpaths[j] = os.fsencode(paths[i])
        counts = (ctypes.c_int64 * k)()
        load_library().fastio_decode_batch(cpaths, k, dsts, caps, hdrs, counts, int(n_threads))
        _count("decode", k)
        for j, i in enumerate(native):
            if counts[j] != caps[j]:
                raise _error(paths[i], "decode", counts[j])
            results[i] = (bufs[j].reshape(shapes[j], order="F"), headers[i])
    for i, h in enumerate(headers):
        if h.endian != "<":
            results[i] = _load_plain(paths[i])
    return results


def gunzip(data: bytes, size: int) -> bytes:
    """The first ``size`` bytes of the first gzip member of ``data`` (fewer
    if the member ends first), through the library's inflate.  Raises
    ``nifti.NiftiError`` on a corrupt or truncated stream."""
    out = np.empty(max(int(size), 1), np.uint8)
    rc = load_library().fastio_gunzip(data, len(data), out.ctypes.data_as(ctypes.c_void_p),
                                      int(size))
    if rc < 0:
        raise _error("gzip stream", "inflate", rc)
    return out[:rc].tobytes()


def percentiles(data: np.ndarray, qs: Sequence[float]) -> List[float]:
    """``[float(np.percentile(data, q)) for q in qs]``, bit for bit.

    For finite float32 data the two order statistics that linear
    interpolation needs per quantile come from the library's two-pass radix
    select (no sort and no copy); a zero comes back as +0.0, equal to
    numpy's as a value.
    numpy divides q by ``float32(100)`` for float32 data, so a Python-float
    q runs the rank and gamma chain in float32 and an ``np.float64`` q in
    float64; the arithmetic below is the same numpy scalar operations in
    the same order, so either q gives ``np.percentile``'s bits.
    Non-float32, empty or non-finite data goes to ``np.percentile``;
    ``calls["percentile_plain"]`` counts the non-finite float32 inputs sent
    there.
    """
    data = np.asarray(data)
    for q in qs:
        if not 0 <= q <= 100:
            raise ValueError("Percentiles must be in the range [0, 100]")
    if data.dtype != np.float32 or data.size == 0:
        return [float(np.percentile(data, q)) for q in qs]
    flat = np.ascontiguousarray(data.ravel(order="K"))  # order statistics ignore the layout
    n = flat.size
    # numpy 'linear': qt = q / f32(100); virtual index vi = (n-1)*qt;
    # prev = floor(vi), next = prev+1, gamma = vi - floor(vi), all in qt's
    # promoted dtype
    ranks: List[int] = []
    spec = []
    for q in qs:
        qt = np.true_divide(q, np.float32(100.0))
        vi = (n - 1) * qt
        prev_f = np.floor(vi)
        prev = int(prev_f)
        nxt = prev + 1
        if vi >= n - 1:  # numpy's above-bounds clamp: both point at the max
            prev = nxt = n - 1
        prev = max(prev, 0)
        nxt = min(max(nxt, 0), n - 1)
        spec.append((prev, nxt, vi - prev_f))
        ranks.extend((prev, nxt))
    uniq = sorted(set(ranks))
    idx = np.asarray(uniq, dtype=np.int64)
    out = np.empty(len(uniq), dtype=np.float32)
    rc = load_library().fastio_order_stats(
        flat.ctypes.data_as(ctypes.c_void_p), n, idx.ctypes.data_as(ctypes.c_void_p),
        len(uniq), out.ctypes.data_as(ctypes.c_void_p))
    _count("order_stats")
    if rc == _ERR_DATA:  # NaN or inf: numpy's own handling
        _count("percentile_plain")
        return [float(np.percentile(data, q)) for q in qs]
    if rc != 0:
        raise RuntimeError(f"fastio_order_stats failed with code {rc} ({ERRORS.get(rc)})")
    by_rank = dict(zip(uniq, out))
    vals = []
    for prev, nxt, t in spec:
        a, b = by_rank[prev], by_rank[nxt]
        if prev == nxt:
            vals.append(float(a))
            continue
        # numpy _lerp: diff in the data dtype, products promote with t
        diff = b - a
        vals.append(float(b - diff * (1 - t)) if t >= 0.5 else float(a + diff * t))
    return vals


def quantize_pad_plain(image: np.ndarray, pshape, lo: float, hi: float) -> np.ndarray:
    """The numpy chain: clip to [lo, hi], -= lo, *= 65535 / (hi - lo)
    (float64, then float32), += 0.5, truncating uint16 cast into a zeroed
    C-ordered buffer of ``pshape``."""
    padded = np.zeros(pshape, np.uint16)
    scale = np.float32(65535.0 / (hi - lo)) if hi > lo else np.float32(0.0)
    tmp = np.clip(image, lo, hi)
    tmp -= np.float32(lo)
    tmp *= scale
    tmp += np.float32(0.5)  # round to nearest under the truncating cast
    padded[tuple(slice(0, s) for s in image.shape)] = tmp
    return padded


def quantize_pad(image: np.ndarray, pshape, lo: float, hi: float) -> np.ndarray:
    """uint16-quantize ``image`` into [lo, hi] inside a zero-padded
    C-ordered buffer of ``pshape``: one strided read and one sequential
    write (the decoded Fortran layout is transposed in 64x64 tiles), the
    bits of ``quantize_pad_plain``.  A non-float32, non-3-D, empty or
    misaligned image takes the numpy chain."""
    image = np.asarray(image)
    pshape = tuple(int(p) for p in pshape)
    itemsize = image.dtype.itemsize
    if (image.dtype != np.float32 or image.ndim != 3 or len(pshape) != 3 or image.size == 0
            or image.ctypes.data % itemsize or any(s % itemsize for s in image.strides)):
        return quantize_pad_plain(image, pshape, lo, hi)
    if any(p < d for p, d in zip(pshape, image.shape)):
        raise ValueError(f"pad shape {pshape} is smaller than the image {image.shape}")
    dims = np.asarray(image.shape, dtype=np.int64)
    strides_el = np.asarray([s // itemsize for s in image.strides], dtype=np.int64)
    pdims = np.asarray(pshape, dtype=np.int64)
    # numpy computes the scale in float64 and then casts
    scale = np.float32(65535.0 / (hi - lo)) if hi > lo else np.float32(0.0)
    out = np.empty(pshape, dtype=np.uint16)
    rc = load_library().fastio_quantize_pad(
        image.ctypes.data_as(ctypes.c_void_p), dims.ctypes.data_as(ctypes.c_void_p),
        strides_el.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        pdims.ctypes.data_as(ctypes.c_void_p), ctypes.c_float(lo), ctypes.c_float(hi),
        ctypes.c_float(scale))
    _count("quantize_pad")
    if rc != 0:
        raise RuntimeError(f"fastio_quantize_pad failed with code {rc} ({ERRORS.get(rc)})")
    return out
