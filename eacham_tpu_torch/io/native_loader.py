"""ctypes binding of the native C++ batch image loader (port of
eacham_tpu/io/native_loader.py).

``native/image_loader.cpp`` is compiled on first use with the flags of
``native/Makefile`` into this package's ``_build/`` directory, named by a
hash of the source, the flags and the host's CPU model (an edited source
is rebuilt, a stale library or one built for another CPU never loaded). PNG (zlib), PPM/PGM and BMP decode + grayscale + the
<=1500-row downsize policy all run in native threads; JPEG and exotic
formats fall back to PIL per image (``io/images.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = _ROOT / "native" / "image_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXXFLAGS = ("-O3", "-std=c++20", "-fPIC", "-Wall", "-march=native")
LDFLAGS = ("-shared", "-lz", "-lpthread")
_lib = None

EL_OK = 0


def _cpu_model() -> bytes:
    """The host CPU's model line: ``-march=native`` code built on one CPU
    may not run on another, so a tree copied to another machine rebuilds."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"model name")), b"")
    except OSError:
        return b""


def lib_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(CXXFLAGS + LDFLAGS).encode()
                          + _cpu_model()).hexdigest()[:12]
    return BUILD_DIR / f"libeacham_native-{digest}.so"


def _build(out: Path) -> bool:
    """Compile into a per-process temporary name, then rename: concurrent
    first uses (test workers) never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXXFLAGS, str(SOURCE), "-o", str(tmp), *LDFLAGS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if not SOURCE.exists():
        return None
    path = lib_path()
    if not path.exists() and not _build(path):
        return None
    lib = ctypes.CDLL(str(path))
    lib.el_probe.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.el_probe.restype = ctypes.c_int
    lib.el_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int,
    ]
    lib.el_load_batch.restype = ctypes.c_int
    _lib = lib
    return _lib


def probe(path: str | Path):
    """(width, height) after the downsize policy, or None if undecodable
    natively."""
    lib = get_lib()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.el_probe(str(path).encode(), ctypes.byref(w), ctypes.byref(h))
    if rc != EL_OK:
        return None
    return w.value, h.value


def load_batch_native(paths: list, out_h: int, out_w: int, workers: int = 8):
    """Decode a batch into ([N, out_h, out_w] float32, sizes [N, 2],
    status [N]). status != 0 rows must be filled by the fallback."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    out = np.zeros((n, out_h, out_w), np.float32)
    sizes = np.zeros((n, 2), np.int32)
    status = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.el_load_batch(
        arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out_h, out_w,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        workers,
    )
    return out, sizes, status
