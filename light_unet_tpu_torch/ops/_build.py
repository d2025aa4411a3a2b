"""Build and load the CUDA kernels and the host library under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use, one ``nvcc`` per source, all started together, into
``_kernels_build/<hash>/`` beside this package (git-ignored).  The hash
covers every source and header and the flags, so an edited source builds
anew and an unchanged one loads at once.

Each ``csrc/<name>.cpp`` is host code (``build_host``): the C++ compiler
(``$CXX``, else ``g++``, else ``c++``) builds it at first use into
``_kernels_build/<its own hash>/lib<name>.so``, one process at a time
(a file lock), so that the CUDA kernels and the host library never rebuild
each other and test workers that reach it together compile it once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_kernels_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# host code: -ffp-contract=off keeps every float32 operation its own rounding
# (no FMA), as numpy rounds them; no -ffast-math, no -march=native
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-ffp-contract=off"]

# C entries of each library: name -> (argtypes, restype is int)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
ENTRIES = {
    "ccl": {
        # fg, labels, D, H, W, stream
        "ccl_label": [_P] * 2 + [_I] * 3 + [_P],
    },
    "depthwise_conv": {
        # x, weight, y, dtype, B, D, H, W, C, stream
        "depthwise_conv3d": [_P] * 3 + [_I] * 6 + [_P],
        # x, weight, bias, y, dtype, B, D, H, W, C, stream
        "depthwise_conv3d_k5": [_P] * 4 + [_I] * 6 + [_P],
    },
    "instance_norm": {
        # x, scale, bias, y, part, sync, dtype, B, S, C, plan[8], eps, slope, stream
        "instance_norm_leaky": [_P] * 6 + [_I, _I, _L, _I, _P, _F, _F, _P],
        # dtype, B, S, C, plan[8]
        "instance_norm_plan": [_I, _I, _L, _I, _P],
    },
    "residual_block": {
        # x, dw1, pw1, n1s, n1b, dw2, pw2, n2s, n2b, sc, nss, nsb,
        # h, h2, out, stats, dtype, B, D, H, W, Cin, C, mma1, mma2, eps, stream
        "residual_block": [_P] * 16 + [_I] * 9 + [_F, _P],
        # D, H, W, Cin, C, projection, mma1, mma2, plan[6]
        "residual_block_plan": [_I] * 8 + [_P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(cuda_home) / "bin" / "nvcc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built (in parallel); return the
    library paths.  Raises with the compiler's output if a build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in sorted(CSRC.glob("*.cu"))}
    todo = {name: path for name, path in libs.items() if not path.exists()}
    if not todo:
        return libs
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}) ---\n{log}")
        else:
            os.replace(tmp, libs[name])  # atomic: a concurrent build loses nothing
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


def cxx_command() -> List[str]:
    """The C++ compiler: ``$CXX`` (split as a shell would), else ``g++``,
    else ``c++``.  Raises when none is found."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return [found]
    raise RuntimeError("no C++ compiler to build the host library: set $CXX or install g++")


def host_hash(name: str) -> str:
    """Hash of ``csrc/<name>.cpp`` and the host flags alone."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    src = CSRC / f"{name}.cpp"
    h.update(src.name.encode())
    h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build_host(name: str) -> Path:
    """``lib<name>.so`` from ``csrc/<name>.cpp``, compiled at first use under
    a file lock (one compile across processes).  Raises with the compiler's
    output if the build fails."""
    out_dir = BUILD_ROOT / host_hash(name)
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes (or the process dies)
        if lib.exists():
            return lib
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [*cxx_command(), *CXX_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        (out_dir / f"{name}.log").write_text(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"host library build failed ({' '.join(cmd)}, exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The library ``lib<name>.so`` with its C entries bound (builds on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build_all()[name]
            lib = ctypes.CDLL(str(path))
            for fn_name, argtypes in ENTRIES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry of ``lib``."""
    if rc != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        msg = lib.kernel_error_string(ctypes.c_int(rc)).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
