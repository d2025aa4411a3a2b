"""Minimal, dependency-free NIfTI-1 codec.

The reference pipeline does all volume IO through nibabel (e.g.
``light_unet/datasets/case_dataset.py:64-69``, ``light_unet/core/inferencer.py:123-128``).
nibabel is not part of this framework's dependency set, so we ship our own
NIfTI-1 reader/writer.  It covers exactly what the pipeline contract needs:

* ``.nii`` and ``.nii.gz`` files (single-file NIfTI-1, magic ``n+1``)
* common datatypes (u8/i8/i16/u16/i32/u32/f32/f64)
* spacing via ``header.get_zooms()`` (pixdim), affine via srow/qform/pixdim
* ``get_fdata()`` semantics: float64 output with scl_slope/scl_inter applied
* header/affine round-trip on save, mirroring
  ``nib.save(nib.Nifti1Image(data, affine, header), path)`` at
  ``light_unet/core/inferencer.py:165``.

Data is stored Fortran-order (x fastest) per the NIfTI spec, so array shape
is ``(nx, ny, nz)`` exactly as nibabel reports it.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

from light_unet_tpu_torch.utils import tracing

HEADER_SIZE = 348
DEFAULT_VOX_OFFSET = 352

# NIfTI-1 datatype codes -> numpy dtype
_DTYPES = {
    2: np.dtype(np.uint8),
    4: np.dtype(np.int16),
    8: np.dtype(np.int32),
    16: np.dtype(np.float32),
    64: np.dtype(np.float64),
    256: np.dtype(np.int8),
    512: np.dtype(np.uint16),
    768: np.dtype(np.uint32),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}


class NiftiError(ValueError):
    """Raised on malformed NIfTI input."""


@dataclass
class Nifti1Header:
    """Parsed view over the raw 348-byte NIfTI-1 header.

    Keeps the raw bytes so unknown fields survive a load->save round trip.
    """

    raw: bytes = b""
    endian: str = "<"
    dim: Tuple[int, ...] = (3, 1, 1, 1, 1, 1, 1, 1)
    datatype: int = 16
    bitpix: int = 32
    pixdim: Tuple[float, ...] = (1.0,) * 8
    vox_offset: float = DEFAULT_VOX_OFFSET
    scl_slope: float = 1.0
    scl_inter: float = 0.0
    qform_code: int = 0
    sform_code: int = 0
    quatern: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    qoffset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    srow: np.ndarray = field(default_factory=lambda: np.eye(3, 4, dtype=np.float64))

    # -- nibabel-compatible accessors -------------------------------------
    def get_zooms(self) -> Tuple[float, ...]:
        ndim = self.dim[0]
        return tuple(float(p) for p in self.pixdim[1 : 1 + ndim])

    def get_data_shape(self) -> Tuple[int, ...]:
        ndim = self.dim[0]
        return tuple(int(d) for d in self.dim[1 : 1 + ndim])

    def set_zooms(self, zooms) -> None:
        pd = list(self.pixdim)
        for i, z in enumerate(zooms):
            pd[i + 1] = float(z)
        self.pixdim = tuple(pd)

    # ----------------------------------------------------------------------
    @classmethod
    def parse(cls, buf: bytes) -> "Nifti1Header":
        if len(buf) < HEADER_SIZE:
            raise NiftiError(f"header too short: {len(buf)} < {HEADER_SIZE}")
        sizeof_hdr = struct.unpack_from("<i", buf, 0)[0]
        endian = "<"
        if sizeof_hdr != HEADER_SIZE:
            sizeof_hdr = struct.unpack_from(">i", buf, 0)[0]
            if sizeof_hdr != HEADER_SIZE:
                raise NiftiError("not a NIfTI-1 file (bad sizeof_hdr)")
            endian = ">"
        magic = buf[344:348]
        if magic[:3] not in (b"n+1", b"ni1"):
            raise NiftiError(f"bad NIfTI magic: {magic!r}")

        e = endian
        dim = struct.unpack_from(e + "8h", buf, 40)
        datatype, bitpix = struct.unpack_from(e + "2h", buf, 70)
        pixdim = struct.unpack_from(e + "8f", buf, 76)
        vox_offset, scl_slope, scl_inter = struct.unpack_from(e + "3f", buf, 108)
        qform_code, sform_code = struct.unpack_from(e + "2h", buf, 252)
        qb, qc, qd, qx, qy, qz = struct.unpack_from(e + "6f", buf, 256)
        srow = np.array(struct.unpack_from(e + "12f", buf, 280), dtype=np.float64).reshape(3, 4)
        return cls(
            raw=bytes(buf[:HEADER_SIZE]),
            endian=endian,
            dim=dim,
            datatype=int(datatype),
            bitpix=int(bitpix),
            pixdim=pixdim,
            vox_offset=float(vox_offset),
            scl_slope=float(scl_slope),
            scl_inter=float(scl_inter),
            qform_code=int(qform_code),
            sform_code=int(sform_code),
            quatern=(qb, qc, qd),
            qoffset=(qx, qy, qz),
            srow=srow,
        )

    def to_bytes(self) -> bytearray:
        """Serialize, preserving unknown raw fields when available."""
        if self.raw and len(self.raw) == HEADER_SIZE:
            buf = bytearray(self.raw)
        else:
            buf = bytearray(HEADER_SIZE)
            struct.pack_into("<i", buf, 0, HEADER_SIZE)
            buf[38] = ord("r")  # 'regular'
            buf[344:348] = b"n+1\x00"
        e = self.endian
        struct.pack_into(e + "8h", buf, 40, *self.dim)
        struct.pack_into(e + "2h", buf, 70, self.datatype, self.bitpix)
        struct.pack_into(e + "8f", buf, 76, *self.pixdim)
        struct.pack_into(e + "3f", buf, 108, self.vox_offset, self.scl_slope, self.scl_inter)
        struct.pack_into(e + "2h", buf, 252, self.qform_code, self.sform_code)
        struct.pack_into(e + "6f", buf, 256, *self.quatern, *self.qoffset)
        struct.pack_into(e + "12f", buf, 280, *np.asarray(self.srow, dtype=np.float64).ravel())
        return buf

    def affine(self) -> np.ndarray:
        """Best affine: sform > qform > pixdim scaling (nibabel precedence)."""
        aff = np.eye(4, dtype=np.float64)
        if self.sform_code > 0:
            aff[:3, :] = self.srow
            return aff
        if self.qform_code > 0:
            b, c, d = self.quatern
            a2 = max(0.0, 1.0 - b * b - c * c - d * d)
            a = np.sqrt(a2)
            rot = np.array(
                [
                    [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                    [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
                    [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
                ]
            )
            qfac = -1.0 if self.pixdim[0] < 0 else 1.0
            zooms = np.array(self.pixdim[1:4], dtype=np.float64)
            zooms[2] *= qfac
            aff[:3, :3] = rot * zooms
            aff[:3, 3] = self.qoffset
            return aff
        aff[0, 0], aff[1, 1], aff[2, 2] = self.pixdim[1:4]
        return aff

    def copy(self) -> "Nifti1Header":
        return Nifti1Header(
            raw=self.raw,
            endian=self.endian,
            dim=tuple(self.dim),
            datatype=self.datatype,
            bitpix=self.bitpix,
            pixdim=tuple(self.pixdim),
            vox_offset=self.vox_offset,
            scl_slope=self.scl_slope,
            scl_inter=self.scl_inter,
            qform_code=self.qform_code,
            sform_code=self.sform_code,
            quatern=tuple(self.quatern),
            qoffset=tuple(self.qoffset),
            srow=np.array(self.srow, copy=True),
        )


class Nifti1Image:
    """In-memory NIfTI-1 image: raw data array + affine + header."""

    def __init__(
        self,
        dataobj: np.ndarray,
        affine: Optional[np.ndarray] = None,
        header: Optional[Nifti1Header] = None,
    ):
        data = np.asarray(dataobj)
        if header is not None:
            hdr = header.copy()
        else:
            hdr = Nifti1Header()
        # sync shape/dtype into the header
        ndim = data.ndim
        dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
        hdr.dim = tuple(int(d) for d in dim[:8])
        dt = data.dtype
        if dt not in _DTYPE_CODES:
            data = data.astype(np.float32)
            dt = data.dtype
        hdr.datatype = _DTYPE_CODES[dt]
        hdr.bitpix = dt.itemsize * 8
        hdr.vox_offset = DEFAULT_VOX_OFFSET
        # Adopting data from an in-memory array: the array values ARE the data,
        # so any scl scaling inherited from a donor header must be dropped —
        # otherwise a later load() re-applies the source file's slope/inter to
        # already-scaled values (nibabel resets scaling the same way when an
        # image is built from an array).
        hdr.scl_slope = 1.0
        hdr.scl_inter = 0.0

        if affine is not None:
            affine = np.asarray(affine, dtype=np.float64)
            hdr.srow = affine[:3, :].copy()
            if hdr.sform_code <= 0:
                hdr.sform_code = 1
            zooms = np.sqrt((affine[:3, :3] ** 2).sum(axis=0))
            pd = list(hdr.pixdim)
            pd[0] = pd[0] if pd[0] in (-1.0, 1.0) else 1.0
            pd[1:4] = [float(z) for z in zooms]
            hdr.pixdim = tuple(pd)
            self._affine = affine
        else:
            self._affine = hdr.affine()
        self._data = data
        self._header = hdr

    @property
    def affine(self) -> np.ndarray:
        return self._affine

    @property
    def header(self) -> Nifti1Header:
        return self._header

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._data.shape

    @property
    def dataobj(self) -> np.ndarray:
        return self._data

    def get_fdata(self, dtype=np.float64) -> np.ndarray:
        """Scaled floating-point data (nibabel ``get_fdata`` semantics)."""
        out = self._data.astype(dtype)
        slope = self._header.scl_slope
        inter = self._header.scl_inter
        # nibabel semantics: slope of 0 or NaN means "no scaling"; a non-finite
        # inter likewise must not poison the volume with NaNs.
        if not np.isfinite(slope) or slope == 0.0:
            slope = 1.0
        if not np.isfinite(inter):
            inter = 0.0
        if slope != 1.0 or inter != 0.0:
            out = out * slope + inter
        return out


def _read_bytes(path: Path) -> bytes:
    if path.suffix == ".gz" or str(path).endswith(".nii.gz"):
        try:
            with gzip.open(path, "rb") as f:
                return f.read()
        except (gzip.BadGzipFile, EOFError, zlib.error) as e:
            raise NiftiError(f"corrupt gzip stream in {path}: {e}") from e
    return path.read_bytes()


def load(path: Union[str, Path]) -> Nifti1Image:
    """Load a ``.nii`` / ``.nii.gz`` file."""
    path = Path(path)
    buf = _read_bytes(path)
    hdr = Nifti1Header.parse(buf)
    dtype = _DTYPES.get(hdr.datatype)
    if dtype is None:
        raise NiftiError(f"unsupported NIfTI datatype code {hdr.datatype}")
    dtype = dtype.newbyteorder(hdr.endian)
    shape = hdr.get_data_shape()
    count = int(np.prod(shape)) if shape else 0
    offset = int(hdr.vox_offset)
    data = np.frombuffer(buf, dtype=dtype, count=count, offset=offset)
    # NIfTI stores x-fastest (Fortran order)
    data = data.reshape(shape, order="F")
    if data.dtype.byteorder not in ("=", "|") and hdr.endian == ">":
        data = data.astype(data.dtype.newbyteorder("="))
    img = Nifti1Image.__new__(Nifti1Image)
    img._data = data
    img._header = hdr
    img._affine = hdr.affine()
    return img


def save(
    img: Nifti1Image, path: Union[str, Path], compresslevel: int = 1
) -> None:
    """Write a ``.nii`` / ``.nii.gz`` file (little-endian, vox_offset 352).

    ``compresslevel`` defaults to 1 — the same default nibabel uses for the
    reference's artifact writes (``nibabel.openers.Opener``) — because on a
    1-core host gzip level 9 costs seconds per whole-body f32 volume for a
    few percent smaller files (measured: the rehearsal's inference stage
    spent most of its per-case wall in level-9 deflate).

    Spans: ``write.map``, with ``write.serialize`` (header and F-order
    bytes) and ``write.deflate`` (the gzip write, or the plain one).
    """
    path = Path(path)
    with tracing.span("write.map"):
        with tracing.span("write.serialize"):
            hdr = img.header
            buf = hdr.to_bytes()
            # force single-file magic + standard offset
            buf[344:348] = b"n+1\x00"
            struct.pack_into(hdr.endian + "f", buf, 108, float(DEFAULT_VOX_OFFSET))
            payload = bytes(buf) + b"\x00" * (DEFAULT_VOX_OFFSET - HEADER_SIZE)
            data = np.asarray(img.dataobj)
            if hdr.endian == ">":
                data = data.astype(data.dtype.newbyteorder(">"))
            payload += data.tobytes(order="F")
        with tracing.span("write.deflate"):
            if str(path).endswith(".gz"):
                # mtime=0 keeps output byte-stable across runs
                with open(path, "wb") as raw:
                    with gzip.GzipFile(
                        fileobj=raw, mode="wb", mtime=0, compresslevel=compresslevel
                    ) as f:
                        f.write(payload)
            else:
                path.write_bytes(payload)
