"""PyTorch port: the native host I/O library (``csrc/fastio.cpp`` through
``utils/fastio.py``), held bit for bit against the JAX package's native
library (``light_unet_tpu/utils/fastio.py``, zlib + libdeflate) and against
the plain versions: the codec (``nifti.load(...).get_fdata(np.float32)``),
``np.percentile`` and the numpy quantize chain.  The port's inflate is its
own, so it is also fuzzed against Python's ``zlib.decompress``."""

import ctypes
import gzip
import os
import random
import shlex
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from light_unet_tpu.utils import fastio as jax_fastio
from light_unet_tpu_torch.ops import _build
from light_unet_tpu_torch.utils import fastio, nifti

REPO = Path(__file__).resolve().parent.parent
DTYPES = [np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32, np.float32, np.float64]


@pytest.fixture(scope="module", autouse=True)
def libraries():
    assert jax_fastio.ensure_built() and jax_fastio.available()
    fastio.load_library()


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal shape, dtype and bytes (so -0.0 and NaN payloads count)."""
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(_bits(a), _bits(b))


def _save(path, data, slope=None, inter=None, level=1):
    img = nifti.Nifti1Image(data, np.diag([4.0, 3.0, 2.0, 1.0]))
    if slope is not None:
        img.header.scl_slope = slope
        img.header.scl_inter = inter
    nifti.save(img, path, compresslevel=level)
    return path


def _plain(path):
    img = nifti.load(path)
    return img.get_fdata(np.float32), img.header


def _check_decode(path):
    """The port's decode equals the codec and the JAX native decode."""
    got, hdr = fastio.load_f32(path)
    want, whdr = _plain(path)
    jax_arr, jax_hdr = jax_fastio.load_f32(path)
    assert _same(got, want) and _same(got, jax_arr)
    assert got.flags.f_contiguous == want.flags.f_contiguous
    assert hdr.raw == whdr.raw == jax_hdr.raw
    assert bytes(hdr.to_bytes()) == bytes(whdr.to_bytes())
    return got


# ---------------------------------------------------------------- decode


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_decode_matches_jax_and_codec(tmp_path, suffix, dtype):
    rng = np.random.default_rng(0)
    info = np.iinfo(dtype) if np.dtype(dtype).kind in "iu" else None
    if info is not None:
        data = rng.integers(info.min, info.max, size=(9, 11, 13), endpoint=True, dtype=dtype)
    else:
        data = (rng.standard_normal((9, 11, 13)) * 1e3).astype(dtype)
    got = _check_decode(_save(tmp_path / f"vol{suffix}", data))
    assert got.dtype == np.float32 and got.shape == (9, 11, 13)


@pytest.mark.parametrize("dtype,slope,inter", [
    (np.int16, 3.0, -1.0), (np.uint8, 0.0078125, 0.5), (np.float64, 1.7, 1e-3),
    (np.int32, np.nan, np.nan), (np.int16, 0.0, 2.0), (np.float32, 2.0, np.inf),
], ids=["i16", "u8", "f64", "nan", "slope0", "inf-inter"])
def test_decode_applies_scaling(tmp_path, dtype, slope, inter):
    rng = np.random.default_rng(1)
    data = (rng.random((5, 6, 7)) * 100).astype(dtype)
    path = tmp_path / "scaled.nii.gz"
    _save(path, data)
    buf = bytearray(gzip.decompress(path.read_bytes()))
    struct.pack_into("<2f", buf, 112, slope, inter)
    path.write_bytes(gzip.compress(bytes(buf), 1))
    got = _check_decode(path)
    assert np.isfinite(got).all()


def test_fortran_order(tmp_path):
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    got = _check_decode(_save(tmp_path / "f.nii", data))
    assert np.array_equal(got, data) and got.flags.f_contiguous


@pytest.mark.parametrize("shape,level", [((1, 1, 1), 1), ((5, 7, 3), 9), ((31, 2, 64), 6),
                                         ((8, 8, 8), 0), ((13, 1, 255), 1), ((40, 40, 45), 9)])
def test_gzip_levels_and_odd_shapes(tmp_path, shape, level):
    data = (np.random.default_rng(2).random(shape) * 1000).astype(np.float32)
    data[: shape[0] // 2] = 0.0  # runs: distance-1 matches
    _check_decode(_save(tmp_path / "v.nii.gz", data, level=level))


def test_read_header_only(tmp_path):
    path = _save(tmp_path / "h.nii.gz", np.zeros((5, 6, 7), np.float32))
    hdr = fastio.read_header(path)
    assert hdr.get_data_shape() == (5, 6, 7) and hdr.get_zooms() == (4.0, 3.0, 2.0)
    assert hdr.raw == jax_fastio.read_header(path).raw


def test_batch_decode_three_threads(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i, dtype in enumerate([np.float32, np.int16, np.uint8, np.float64, np.float32]):
        suffix = ".nii" if i == 3 else ".nii.gz"
        data = (rng.random((6 + i, 7, 8)) * 90).astype(dtype)
        paths.append(_save(tmp_path / f"b{i}{suffix}", data))
    paths.append(_big_endian(tmp_path / "be.nii.gz", rng.random((4, 5, 6)).astype(np.float32)))
    n = fastio.calls["decode"]
    out = fastio.load_batch_f32(paths, n_threads=3)
    assert fastio.calls["decode"] == n + 5  # the big-endian file went to the codec
    jax_out = jax_fastio.load_batch_f32(paths, n_threads=3)
    for p, (arr, hdr), (jarr, jhdr) in zip(paths, out, jax_out):
        want, whdr = _plain(p)
        assert _same(arr, want) and _same(arr, jarr)
        assert hdr.raw == whdr.raw == jhdr.raw


def _big_endian(path, data):
    hdr = bytearray(nifti.HEADER_SIZE)
    struct.pack_into(">i", hdr, 0, nifti.HEADER_SIZE)
    struct.pack_into(">8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into(">2h", hdr, 70, 16, 32)
    struct.pack_into(">8f", hdr, 76, 1.0, 4.0, 4.0, 4.0, 1.0, 1.0, 1.0, 1.0)
    struct.pack_into(">3f", hdr, 108, 352.0, 1.0, 0.0)
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + data.astype(">f4").tobytes(order="F")
    path.write_bytes(gzip.compress(payload, 1))
    return path


def test_big_endian_goes_to_the_codec(tmp_path):
    data = np.random.default_rng(4).random((4, 5, 6)).astype(np.float32)
    path = _big_endian(tmp_path / "be.nii.gz", data)
    n = fastio.calls["decode"]
    got, hdr = fastio.load_f32(path)
    assert fastio.calls["decode"] == n and hdr.endian == ">"
    assert _same(got, _plain(path)[0]) and np.array_equal(got, data)


def test_decode_counts_native_calls(tmp_path):
    path = _save(tmp_path / "c.nii.gz", np.ones((3, 4, 5), np.float32))
    n = fastio.calls["decode"]
    fastio.load_f32(path)
    assert fastio.calls["decode"] == n + 1


# ------------------------------------------------------- gzip and inflate


def _gzip_member(payload: bytes, flags: int, level: int = 6) -> bytes:
    """A gzip member with FTEXT/FHCRC/FEXTRA/FNAME/FCOMMENT as ``flags`` say."""
    head = bytearray(b"\x1f\x8b\x08" + bytes([flags]) + b"\x00\x00\x00\x00\x00\xff")
    if flags & 0x04:
        head += struct.pack("<H", 5) + b"ab\x00cd"
    if flags & 0x08:
        head += b"case_0001.nii\x00"
    if flags & 0x10:
        head += b"a comment\x00"
    if flags & 0x02:
        head += struct.pack("<H", zlib.crc32(bytes(head)) & 0xFFFF)
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = comp.compress(payload) + comp.flush()
    return bytes(head) + body + struct.pack("<II", zlib.crc32(payload), len(payload) & 0xFFFFFFFF)


@pytest.mark.parametrize("flags", [0x00, 0x01, 0x04, 0x08, 0x10, 0x02, 0x1F],
                         ids=["none", "ftext", "fextra", "fname", "fcomment", "fhcrc", "all"])
def test_gzip_header_fields(tmp_path, flags):
    raw = tmp_path / "v.nii"
    _save(raw, (np.random.default_rng(5).random((7, 8, 9)) * 50).astype(np.float32))
    path = tmp_path / "v.nii.gz"
    path.write_bytes(_gzip_member(raw.read_bytes(), flags))
    _check_decode(path)


def test_bad_header_crc_is_refused(tmp_path):
    raw = tmp_path / "v.nii"
    _save(raw, np.ones((3, 3, 3), np.float32))
    member = bytearray(_gzip_member(raw.read_bytes(), 0x02))
    member[10] ^= 0xFF  # the FHCRC field
    path = tmp_path / "v.nii.gz"
    path.write_bytes(bytes(member))
    with pytest.raises(nifti.NiftiError):
        fastio.load_f32(path)


def test_trailing_garbage_is_ignored(tmp_path):
    data = (np.random.default_rng(6).random((6, 5, 4)) * 10).astype(np.float32)
    path = _save(tmp_path / "trail.nii.gz", data)
    with open(path, "ab") as f:
        f.write(b"\x00garbage-after-member")
    got, _ = fastio.load_f32(path)
    assert _same(got, jax_fastio.load_f32(path)[0]) and np.array_equal(got, data)


def _payload(rng: random.Random, kind: int, n: int) -> bytes:
    if kind == 0:  # incompressible
        return rng.randbytes(n)
    if kind == 1:  # one long run: distance-1 matches of 258
        return bytes([rng.randrange(256)]) * n
    if kind == 2:  # a short period: long matches at distances 2-8
        period = rng.randbytes(rng.randrange(2, 9))
        return (period * (n // len(period) + 1))[:n]
    if kind == 3:  # float32 noise, as a volume's voxels
        rs = np.random.default_rng(rng.randrange(1 << 30))
        return (rs.random(n // 4 + 1).astype(np.float32) * 3).tobytes()[:n]
    if kind == 4:  # runs of random lengths
        out = bytearray()
        while len(out) < n:
            out += bytes([rng.randrange(256)]) * rng.randrange(1, 600)
        return bytes(out[:n])
    words = [rng.randbytes(rng.randrange(3, 12)) for _ in range(40)]  # text-like
    return b"".join(rng.choice(words) for _ in range(n // 6 + 1))[:n]


STRATEGIES = {"default": zlib.Z_DEFAULT_STRATEGY, "filtered": zlib.Z_FILTERED,
              "huffman_only": zlib.Z_HUFFMAN_ONLY, "rle": zlib.Z_RLE, "fixed": zlib.Z_FIXED}


@pytest.mark.parametrize("strategy", list(STRATEGIES))
def test_inflate_fuzz_against_zlib(strategy):
    """Random streams of every kind, at levels 0 (stored blocks, several
    above 64 KiB), 1, 6 and 9: the whole member, and prefixes of it."""
    rng = random.Random(strategy)
    for trial in range(36):
        n = rng.choice([0, 1, 5, 300, 4096, 70_000, 200_000])
        payload = _payload(rng, trial % 6, n)
        comp = zlib.compressobj(rng.choice([0, 1, 6, 9]), zlib.DEFLATED, 31, 9,
                                STRATEGIES[strategy])
        member = comp.compress(payload) + comp.flush()
        want = zlib.decompress(member, 31)
        assert fastio.gunzip(member, len(want)) == want
        assert fastio.gunzip(member, len(want) + 100) == want  # the member ends first
        k = rng.randrange(len(want) + 1)
        assert fastio.gunzip(member, k) == want[:k]


def test_inflate_random_corruption_keeps_the_process_alive():
    """Corrupted streams end in NiftiError or in bytes; where zlib accepts
    the stream, the bytes are zlib's."""
    rng = random.Random(7)
    for trial in range(300):
        payload = _payload(rng, trial % 6, rng.choice([200, 5000, 40_000]))
        member = bytearray(gzip.compress(payload, rng.choice([1, 6, 9])))
        for _ in range(rng.randrange(1, 4)):
            member[rng.randrange(10, len(member))] = rng.randrange(256)
        try:
            got = fastio.gunzip(bytes(member), len(payload))
        except nifti.NiftiError:
            continue
        try:
            want = zlib.decompress(bytes(member), 31)
        except zlib.error:
            continue
        assert got == want[: len(payload)]


def _fixed_block(symbols) -> bytes:
    """One final fixed-Huffman deflate block of ("lit", byte), ("match",
    length 3, distance 97..128) and a closing end-of-block, packed LSB first."""
    acc, nbits = 0, 0

    def put(value, n):
        nonlocal acc, nbits
        acc |= value << nbits
        nbits += n

    def code(c, n):  # Huffman codes go in most significant bit first
        put(int(format(c, f"0{n}b")[::-1], 2), n)

    put(1, 1)  # BFINAL
    put(1, 2)  # BTYPE 01: fixed codes
    for kind, *args in symbols:
        if kind == "lit":
            code(0x30 + args[0], 8)
        else:
            code(1, 7)  # length symbol 257: 3
            code(13, 5)  # distance symbol 13: 97 + 5 extra bits
            put(args[1] - 97, 5)
    code(0, 7)  # end of block
    return acc.to_bytes((nbits + 7) // 8, "little")


@pytest.mark.parametrize("cap", [400, 130], ids=["fast-loop", "checked-path"])
def test_distance_before_the_output_is_refused(cap):
    """A match reaching before the first output byte is corrupt data, in the
    fast loop (room for a whole match at the match) and in the checked path
    (less room), where the output fills before the member ends (no CRC to
    catch it); the same stream with a distance inside the output decodes as
    zlib does."""
    def member(distance):
        stream = _fixed_block([("lit", 97)] * 100 + [("match", 3, distance)] + [("lit", 98)] * 400)
        return b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff" + stream + bytes(8), stream

    good, stream = member(99)
    want = zlib.decompress(stream, -15)
    assert want == b"a" * 103 + b"b" * 400
    assert fastio.gunzip(good, cap) == want[:cap]
    with pytest.raises(nifti.NiftiError):
        fastio.gunzip(member(120)[0], cap)


def _corrupt(path: Path, how: str) -> Path:
    raw = bytearray(path.read_bytes())
    if how == "crc":
        raw[-8] ^= 0x01
    elif how == "isize":
        raw[-1] ^= 0x40
    elif how == "btype":  # the first block header (after FNAME): type 3 is reserved
        start = raw.index(b"\x00", 10) + 1
        raw[start] |= 0x06
    elif how == "magic":
        raw[2] = 7  # compression method 7
    else:  # truncated at a fraction
        raw = raw[: int(len(raw) * float(how))] if float(how) < 1 else raw[:-4]
    path.write_bytes(bytes(raw))
    return path


@pytest.mark.parametrize("how", ["crc", "isize", "btype", "magic", "0.02", "0.5", "0.999", "1"])
def test_corrupt_and_truncated_streams_raise(tmp_path, how):
    data = (np.random.default_rng(8).random((20, 21, 22)) * 9).astype(np.float32)
    path = _corrupt(_save(tmp_path / "bad.nii.gz", data, level=6), how)
    with pytest.raises(nifti.NiftiError):
        fastio.load_f32(path)
    with pytest.raises(nifti.NiftiError):  # the plain codec refuses it as well
        _plain(path)


def test_hostile_header_dims_do_not_crash(tmp_path):
    """A header claiming 7 x 32767 voxels, or negative dims: a negative code
    from the C entry, NiftiError from load_f32, and the process alive."""
    path = _save(tmp_path / "hostile.nii.gz", np.zeros((2, 2, 2), np.float32))
    buf = bytearray(gzip.decompress(path.read_bytes()))
    lib = fastio.load_library()
    out = np.empty(64, dtype=np.float32)
    hbuf = (ctypes.c_uint8 * nifti.HEADER_SIZE)()
    for dims in [(7,) + (32767,) * 7, (3, -5, 4, 4, 1, 1, 1, 1), (9, 2, 2, 2, 1, 1, 1, 1)]:
        struct.pack_into("<8h", buf, 40, *dims)
        path.write_bytes(gzip.compress(bytes(buf)))
        rc = lib.fastio_decode(str(path).encode(), out.ctypes.data_as(ctypes.c_void_p), 64, hbuf)
        assert rc < 0
        with pytest.raises(nifti.NiftiError):
            fastio.load_f32(path)


def test_missing_file_raises_file_not_found(tmp_path):
    for fn in (fastio.load_f32, fastio.read_header, lambda p: fastio.load_batch_f32([p])):
        with pytest.raises(FileNotFoundError):
            fn(tmp_path / "nope.nii.gz")


def test_garbage_file_raises_nifti_error(tmp_path):
    path = tmp_path / "garbage.nii"
    path.write_bytes(b"not a nifti file at all" * 30)
    with pytest.raises(nifti.NiftiError):
        fastio.load_f32(path)


# ------------------------------------------------------------ percentiles


def _normal(shape):
    return (np.random.default_rng(9).standard_normal(shape) * 100).astype(np.float32)


def _shuffled(*parts):
    data = np.concatenate([np.asarray(p, np.float32) for p in parts])
    return np.random.default_rng(11).permutation(data)


def _zero_background():
    """Half the voxels exactly 0.0; q 30 and 49.9 rank inside the zero run,
    49.99 and 50 straddle its end and 50.03 lands just past it."""
    return _shuffled(np.zeros(2000), np.random.default_rng(12).uniform(0.5, 3.0, 2000))


def _signed_zeros():
    """-0.0 and +0.0 mixed between negatives and positives; q 83.35
    straddles the zeros' end."""
    rng = np.random.default_rng(13)
    return _shuffled(np.full(1000, -0.0), np.zeros(1000), -rng.uniform(1, 5, 500),
                     rng.uniform(1, 5, 500))


def _mixed_sign():
    """Both signs over 60 decades, so the keys spread over many high bins."""
    rng = np.random.default_rng(14)
    return (rng.choice([-1.0, 1.0], 20000) * 10.0 ** rng.uniform(-30, 30, 20000)).astype(np.float32)


def _denormals_and_extremes():
    """Denormals of both signs beside -FLT_MAX and FLT_MAX (three of each)."""
    rng = np.random.default_rng(15)
    sub = rng.integers(1, 1 << 23, 400, dtype=np.uint32).view(np.float32)
    big = np.finfo(np.float32).max
    return _shuffled(sub[:200], -sub[200:], _normal((394,)), np.full(3, big), np.full(3, -big))


def _one_high_bin():
    """Keys that differ only in their low 16 bits: every rank in one high bin."""
    bits = np.uint32(0x3F800000) + np.random.default_rng(16).integers(0, 1 << 16, 5000,
                                                                       dtype=np.uint32)
    return bits.view(np.float32)


def _two_high_bins():
    """100 values in [1, 1.0078) and 100 in [3, 3.02): q 50's prev is the
    last of the first high bin and its next the first of another."""
    rng = np.random.default_rng(17)
    return _shuffled(rng.uniform(1.0, 1.0078, 100), rng.uniform(3.0, 3.02, 100))


def _phantom():
    from cellbench.phantoms import make_phantom

    return np.asfortranarray(make_phantom(np.random.default_rng(5), (144, 144, 272))[0])


EDGE_QS = (0.0, 0.5, 50.0, 99.5, 100.0)


@pytest.mark.parametrize("qkind", ["python", "float64"])
@pytest.mark.parametrize("make,qs", [
    (lambda: _normal((67,)), (0.5, 99.5)),
    (lambda: _normal((40, 31, 17)), (0.5, 99.5)),
    (lambda: _normal((123456,)), (0.0, 0.5, 37.2, 50.0, 99.5, 100.0)),
    (_zero_background, (0.5, 30.0, 49.9, 49.99, 50.0, 50.03, 99.5)),
    (_signed_zeros, (0.5, 20.0, 50.0, 83.35, 83.4, 99.5)),
    (lambda: -np.abs(_normal((5000,))) - np.float32(1.0), EDGE_QS),
    (_mixed_sign, EDGE_QS),
    (_denormals_and_extremes, (0.0, 0.25, 0.5, 10.0, 50.0, 99.5, 100.0)),
    (_one_high_bin, EDGE_QS),
    (_two_high_bins, (0.5, 50.0, 99.5)),
    (lambda: np.float32([2.75]), EDGE_QS),
    (lambda: np.float32([5.5, -2.25]), EDGE_QS + (37.5,)),
    (_phantom, EDGE_QS),
], ids=["67", "40x31x17", "123456", "zero-background", "signed-zeros", "all-negative",
        "mixed-sign", "denormals-extremes", "one-high-bin", "two-high-bins", "n1", "n2",
        "phantom-144x144x272-F"])
def test_percentiles_match_numpy(make, qs, qkind):
    """Equal to np.percentile and to the JAX library, bit for bit; +0.0 and
    -0.0 compare as values (``==`` on Python floats)."""
    data = make()
    assert data.dtype == np.float32 and np.isfinite(data).all()
    if qkind == "float64":
        qs = tuple(np.float64(q) for q in qs)
    want = [float(np.percentile(data, q)) for q in qs]
    assert fastio.percentiles(data, qs) == want == jax_fastio.percentiles(data, qs)
    assert fastio.percentiles(np.asfortranarray(data), qs) == want


def test_percentiles_duplicates_constant_single():
    assert fastio.percentiles(np.full((5000,), 3.25, np.float32), (0.5, 99.5)) == [3.25, 3.25]
    data = np.repeat(np.float32([1, 2, 2, 2, 9]), 1000)
    qs = (10.0, 50.0, 90.0)
    assert fastio.percentiles(data, qs) == [float(np.percentile(data, q)) for q in qs]
    assert fastio.percentiles(np.float32([7.5]), (0.5, 99.5)) == [7.5, 7.5]


@pytest.mark.parametrize("data", [np.float32([1.0, np.nan, 2.0]), np.float32([1.0, np.inf, 2.0]),
                                  np.float32([-np.inf, 0.5, 2.0, 3.0]), np.empty((0,), np.float32),
                                  np.arange(50, dtype=np.float64) / 7, np.arange(50, dtype=np.int16)],
                         ids=["nan", "inf", "-inf", "empty", "float64", "int16"])
def test_percentiles_other_inputs_take_numpy(data):
    qs = (0.5, 50.0, 99.5)
    try:
        want = [float(np.percentile(data, q)) for q in qs]
    except IndexError:  # numpy's answer for an empty array
        with pytest.raises(IndexError):
            fastio.percentiles(data, qs)
        return
    got = fastio.percentiles(data, qs)
    assert np.array_equal(np.float64(got), np.float64(want), equal_nan=True)


def test_percentile_plain_counts_non_finite_inputs():
    finite = _normal((300,))
    n = fastio.calls["percentile_plain"]
    fastio.percentiles(finite, (0.5, 99.5))
    assert fastio.calls["percentile_plain"] == n
    with_nan = finite.copy()
    with_nan[7] = np.nan
    assert np.isnan(fastio.percentiles(with_nan, (0.5, 99.5))).all()
    assert fastio.calls["percentile_plain"] == n + 1


def test_percentiles_refuse_out_of_range_q():
    with pytest.raises(ValueError):
        fastio.percentiles(np.ones(4, np.float32), (101.0,))


def test_compute_clip_values_goes_through_the_library():
    from light_unet_tpu_torch.ops.intensity import compute_clip_values

    data = (np.random.default_rng(10).random((30, 30, 30)) * 1000).astype(np.float32)
    n = fastio.calls["order_stats"]
    lo, hi = compute_clip_values(data)
    assert fastio.calls["order_stats"] == n + 1  # one selection serves both ranks
    assert (lo, hi) == (float(np.percentile(data, 0.5)), float(np.percentile(data, 99.5)))
    d64 = data.astype(np.float64)
    assert compute_clip_values(d64) == (float(np.percentile(d64, 0.5)),
                                        float(np.percentile(d64, 99.5)))


# ---------------------------------------------------------- quantize + pad


def test_quantize_pad_fuzz():
    rng = np.random.default_rng(11)
    for trial in range(30):
        d = tuple(int(x) for x in rng.integers(1, 24, size=3))
        p = tuple(dd + int(x) for dd, x in zip(d, rng.integers(0, 9, size=3)))
        img = (rng.random(d, dtype=np.float32) * 20 - 3).astype(np.float32)
        if trial % 3 == 1:
            img = np.asfortranarray(img)  # the decoded NIfTI layout
        elif trial % 3 == 2:
            big = rng.random((d[0] + 4, d[1] + 2, d[2] + 5), dtype=np.float32) * 20
            img = big[2: 2 + d[0], 1: 1 + d[1], 3: 3 + d[2]]  # a strided view
        lo = float(rng.random() * 4 - 1)
        hi = lo + float(rng.random() * 10)
        got = fastio.quantize_pad(img, p, lo, hi)
        want = fastio.quantize_pad_plain(img, p, lo, hi)
        assert _same(got, want) and _same(got, jax_fastio.quantize_pad(img, p, lo, hi))


def test_quantize_pad_wholebody_fortran_layout():
    img = np.asfortranarray(
        (np.random.default_rng(12).random((80, 80, 120)) * 15 - 1).astype(np.float32))
    got = fastio.quantize_pad(img, (80, 80, 128), 0.2, 11.7)
    assert _same(got, fastio.quantize_pad_plain(img, (80, 80, 128), 0.2, 11.7))
    assert _same(got, jax_fastio.quantize_pad(img, (80, 80, 128), 0.2, 11.7))


@pytest.mark.parametrize("lo,hi", [(3.0, 3.0), (5.0, 2.0)], ids=["hi==lo", "hi<lo"])
def test_quantize_pad_degenerate_range(lo, hi):
    img = np.full((4, 4, 4), 3.0, np.float32)
    got = fastio.quantize_pad(img, (4, 4, 6), lo, hi)
    assert _same(got, fastio.quantize_pad_plain(img, (4, 4, 6), lo, hi))
    assert _same(got, jax_fastio.quantize_pad(img, (4, 4, 6), lo, hi))


def test_quantize_pad_extremes_clip_exactly():
    img = np.array([[[-1e30, 1e30, 0.0, 0.5]]], np.float32)
    got = fastio.quantize_pad(img, (1, 1, 4), 0.0, 1.0)
    assert _same(got, fastio.quantize_pad_plain(img, (1, 1, 4), 0.0, 1.0))
    assert got[0, 0, 0] == 0 and got[0, 0, 1] == 65535


def test_quantize_pad_other_inputs_take_the_numpy_chain():
    rng = np.random.default_rng(13)
    n = fastio.calls["quantize_pad"]
    f64 = rng.random((3, 3, 3))
    f32_2d = rng.random((3, 3)).astype(np.float32)
    empty = np.zeros((0, 3, 3), np.float32)
    raw = np.zeros(4 * 27 + 1, np.uint8)
    raw[1:] = rng.integers(0, 256, 4 * 27, dtype=np.uint8)
    misaligned = np.frombuffer(raw.data, dtype=np.float32, count=27, offset=1).reshape(3, 3, 3)
    for img in (f64, f32_2d, empty, misaligned):
        got = fastio.quantize_pad(img, (3, 3, 3), 0.0, 1.0)
        assert _same(got, fastio.quantize_pad_plain(img, (3, 3, 3), 0.0, 1.0))
    assert fastio.calls["quantize_pad"] == n  # none of them reached the library
    with pytest.raises(ValueError):
        fastio.quantize_pad(rng.random((4, 4, 4)).astype(np.float32), (4, 4, 3), 0.0, 1.0)


def test_fused_prepare_matches_jax():
    """``FusedVolumePipeline.prepare``'s uint16 upload buffer and clip values
    equal the JAX package's, and came from the library."""
    from light_unet_tpu.config import Config as JaxConfig
    from light_unet_tpu.ops.fused import FusedVolumePipeline as JaxPipeline
    from light_unet_tpu_torch.config import Config
    from light_unet_tpu_torch.ops.fused import FusedVolumePipeline

    cfg = {"data": {"patch_size": [16, 16, 16]}}
    img = np.asfortranarray((np.random.default_rng(14).random((20, 22, 30)) * 12 - 1)
                            .astype(np.float32))
    jax_pipe = JaxPipeline(lambda p, x: x[..., :1], JaxConfig.from_dict(cfg), patch_batch=8,
                           transfer_dtype="uint16")
    pipe = FusedVolumePipeline(lambda x: x[..., :1], Config.from_dict(cfg), patch_batch=8,
                               transfer_dtype="uint16", device="cpu")
    n = fastio.calls["quantize_pad"]
    got = pipe.prepare(img)
    want = jax_pipe.prepare(img)
    assert fastio.calls["quantize_pad"] == n + 1
    assert _same(got[0].numpy().view(np.uint16), np.asarray(want[0]))
    assert got[2:4] == tuple(want[2:4])


# ------------------------------------------------------- source and build


def test_source_carries_its_own_inflate():
    src = (_build.CSRC / "fastio.cpp").read_text()
    assert "zlib.h" not in src and "libdeflate" not in src.replace("libdeflate's", "")
    flags = " ".join(_build.CXX_FLAGS)
    assert "-ffp-contract=off" in flags and "-O3" in flags
    for bad in ("-lz", "-ldeflate", "-ffast-math", "-march=native"):
        assert bad not in flags
    assert "fastio.cpp" not in [p.name for p in _build.CSRC.glob("*.cu*")]  # not an nvcc source


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    monkeypatch.setenv("CXX", f"{sys.executable} -c \"import sys; print('compiler says no'); "
                              f"sys.exit(3)\"")
    with pytest.raises(RuntimeError, match="compiler says no"):
        _build.build_host("fastio")


def test_concurrent_builds_compile_once(tmp_path):
    """Three processes reach an empty build directory together: one
    compiles (a counting wrapper around the compiler), all load the same
    library."""
    counter = tmp_path / "compiles"
    wrapper = tmp_path / "cxx.sh"
    cxx = " ".join(shlex.quote(c) for c in _build.cxx_command())
    wrapper.write_text(f"#!/bin/sh\necho x >> {shlex.quote(str(counter))}\nexec {cxx} \"$@\"\n")
    wrapper.chmod(0o755)
    code = ("import sys; from pathlib import Path; from light_unet_tpu_torch.ops import _build; "
            f"_build.BUILD_ROOT = Path({str(tmp_path / 'build')!r}); "
            "import ctypes; p = _build.build_host('fastio'); ctypes.CDLL(str(p)); print(p)")
    env = {**os.environ, "CXX": str(wrapper), "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    assert len({o[0].strip() for o in outs}) == 1
    assert counter.read_text().count("x") == 1
