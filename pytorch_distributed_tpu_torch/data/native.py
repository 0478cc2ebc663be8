"""ctypes bridge to the C++ packed-record core, ``csrc/recordio.cpp``
(``pytorch_distributed_tpu/data/native.py``: ``NativeReader``,
``SizeMismatch``, the same C ABI).

The library is host code: ``g++ -O2 -std=c++17 -shared -fPIC -pthread``,
built on first use into the ignored ``csrc/build/`` as
``librecordio-<hash>.so``, the hash that of the source, so an edited
source never loads an old build (``ops/_build.library_path`` names the
CUDA libraries the same way). Nothing is built at import time.

Where the JAX package quietly takes the Python reader when the build
fails, here ``available()`` is False only where there is no ``g++``; a
compiler that fails raises with its output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCE = CSRC / "recordio.cpp"
BUILD_DIR = CSRC / "build"
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None

_u64p = ctypes.POINTER(ctypes.c_uint64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "tpr_open": (ctypes.c_void_p, [ctypes.c_char_p]),
    "tpr_close": (None, [ctypes.c_void_p]),
    "tpr_count": (ctypes.c_int64, [ctypes.c_void_p]),
    "tpr_size": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_uint64]),
    "tpr_read": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
                                  ctypes.c_int]),
    "tpr_read_batch": (ctypes.c_int64, [ctypes.c_void_p, _u64p, ctypes.c_int64,
                                        ctypes.c_char_p, _u64p, ctypes.c_int]),
    "tpr_crop_batch": (ctypes.c_int64, [ctypes.c_void_p, _u64p, ctypes.c_int64, _i32p, _i32p,
                                        _u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                                        _u8p, _i32p, ctypes.c_int]),
}


def library_path() -> Path:
    return BUILD_DIR / f"librecordio-{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]}.so"


def find_compiler():
    """Path of ``g++``, or None."""
    return shutil.which("g++")


def build() -> Path:
    """Compile the library unless its current build exists. Raises
    without a compiler or with the compiler's output on a failure. The
    output lands under a per-process name and is renamed into place, so
    processes building at once never load a half-written file."""
    path = library_path()
    if path.exists():
        return path
    cxx = find_compiler()
    if cxx is None:
        raise RuntimeError("g++ not found: the native record reader builds only where a "
                           "C++ compiler is installed")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([cxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The library, built if need be, with every entry point declared."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib


def available() -> bool:
    """True where the native reader can be used: a compiler is found (the
    build, if it is still to come, then runs and raises on a failure)."""
    return _lib is not None or library_path().exists() or find_compiler() is not None


class SizeMismatch(IOError):
    """A raw record's stored (h, w) differs from what the caller planned
    crop coordinates for: take the per-record-size path."""


class NativeReader:
    """One open TPRC file in the C++ core."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.tpr_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"tpr_open failed for {path}")
        self.n = int(self._lib.tpr_count(self._h))

    def size(self, i: int) -> int:
        return int(self._lib.tpr_size(self._h, i))

    def read(self, i: int, verify_crc: bool = True) -> bytes:
        size = self.size(i)
        if size < 0:
            raise IndexError(i)
        buf = ctypes.create_string_buffer(size)
        status = self._lib.tpr_read(self._h, i, buf, int(verify_crc))
        if status == -2:
            raise IOError(f"crc mismatch in record {i}")
        if status < 0:
            raise IOError(f"read failed for record {i}")
        return buf.raw[:size]

    def read_batch(self, indices: Sequence[int], verify_crc: bool = True) -> list:
        idx = np.asarray(indices, np.uint64)
        sizes = np.asarray([self.size(int(i)) for i in idx], np.int64)
        if (sizes < 0).any():
            raise IndexError("index out of range in batch")
        offsets = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.uint64)
        buf = ctypes.create_string_buffer(int(sizes.sum()))
        status = self._lib.tpr_read_batch(self._h, idx.ctypes.data_as(_u64p), len(idx), buf,
                                          offsets.ctypes.data_as(_u64p), int(verify_crc))
        if status == -2:
            raise IOError("crc mismatch in batch read")
        if status < 0:
            raise IOError("batch read failed")
        raw = buf.raw
        return [raw[int(o):int(o) + int(s)] for o, s in zip(offsets, sizes)]

    def crop_batch(self, indices: Sequence[int], tops: Sequence[int], lefts: Sequence[int],
                   flips: Sequence[bool], crop: int, expect_h: int, expect_w: int,
                   n_threads: int = 0):
        """Read raw image records (``data/raw.py``'s layout) and return
        ``(images [B, crop, crop, 3] uint8, labels [B] int32)``, each
        sample's window and horizontal flip applied in C, on ``n_threads``
        threads (0: the host's cores, at most 8). A record whose stored
        size is not ``expect_h`` x ``expect_w`` raises ``SizeMismatch``; a
        bad index, a short record or a window out of bounds ``IOError``."""
        idx = np.ascontiguousarray(indices, np.uint64)
        t = np.ascontiguousarray(tops, np.int32)
        l = np.ascontiguousarray(lefts, np.int32)
        f = np.ascontiguousarray(flips, np.uint8)
        b = len(idx)
        if not len(t) == len(l) == len(f) == b:
            raise ValueError("indices, tops, lefts and flips differ in length")
        images = np.empty((b, crop, crop, 3), np.uint8)
        labels = np.empty((b,), np.int32)
        if n_threads <= 0:
            n_threads = min(os.cpu_count() or 1, 8)
        status = self._lib.tpr_crop_batch(
            self._h, idx.ctypes.data_as(_u64p), b, t.ctypes.data_as(_i32p),
            l.ctypes.data_as(_i32p), f.ctypes.data_as(_u8p), crop, expect_h, expect_w,
            images.ctypes.data_as(_u8p), labels.ctypes.data_as(_i32p), n_threads)
        if status == -3:
            raise SizeMismatch(f"record size differs from expected {expect_h}x{expect_w}")
        if status < 0:
            raise IOError("native crop_batch failed (bad index, truncated record, or crop "
                          "window out of bounds)")
        return images, labels

    def close(self) -> None:
        if self._h:
            self._lib.tpr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter teardown: the library may be gone
            pass
