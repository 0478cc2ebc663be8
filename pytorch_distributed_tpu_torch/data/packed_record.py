"""The TPRC packed-record container (``pytorch_distributed_tpu/data/
packed_record.py``): the same file format, so a file written by either
package reads in the other, byte for byte.

Millions of small records (JPEG bytes, raw images) collapse into one large
sequential file per split, read at random through an in-memory offset
table: the property the reference's ffrecord files gave its input path
(``hfai.datasets.ImageNet``, ``restnet_ddp.py:107-119``).

Layout (little-endian)::

    magic "TPRC" | version u32 | n u64 | flags u64
    offsets u64[n+1]      payload-relative record boundaries
    crcs u32[n]           iff flags & 1
    payload               concatenated record bytes

Two readers share the format: ``_PyReader`` (``os.pread``, the plain
version) and the C++ core (``data.native``, ``csrc/recordio.cpp``).
``PackedRecordReader`` takes the native one where a compiler is found
(``use_native=None``) and pickles by its path, so a dataset crosses to a
spawned rank and reopens its file there.
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib
from typing import Iterable, Sequence

import numpy as np

from pytorch_distributed_tpu_torch.data import native
from pytorch_distributed_tpu_torch.resilience.retry import retry_call

_MAGIC = b"TPRC"
_VERSION = 1
_FLAG_CRC = 1
_HEADER = struct.Struct("<4sIQQ")


class PackedRecordWriter:
    """Streaming writer of ``bytes`` records.

    The payload streams to a temporary file as records arrive (memory
    O(records), not O(payload)); ``close`` assembles header, tables and
    payload and publishes the file by an atomic rename. An exception
    inside the ``with`` block abandons the write: nothing is published and
    the temporary files are removed."""

    def __init__(self, path: str | os.PathLike, with_crc: bool = True):
        self.path = os.fspath(path)
        self.with_crc = with_crc
        self._payload_tmp = self.path + ".payload.tmp"
        self._payload = open(self._payload_tmp, "wb")
        self._offsets = [0]
        self._crcs: list = []
        self._closed = False

    def write(self, record: bytes) -> int:
        """Append one record; returns its index."""
        if self._closed:
            raise ValueError("writer is closed")
        self._payload.write(record)
        self._offsets.append(self._offsets[-1] + len(record))
        if self.with_crc:
            self._crcs.append(zlib.crc32(record) & 0xFFFFFFFF)
        return len(self._offsets) - 2

    def write_all(self, records: Iterable[bytes]) -> None:
        for r in records:
            self.write(r)

    def abort(self) -> None:
        """Discard everything written; publish nothing."""
        if self._closed:
            return
        self._closed = True
        self._payload.close()
        for p in (self._payload_tmp, self.path + ".tmp"):
            try:
                os.remove(p)
            except FileNotFoundError:
                pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._payload.close()
        n = len(self._offsets) - 1
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "wb") as f, open(self._payload_tmp, "rb") as payload:
                f.write(_HEADER.pack(_MAGIC, _VERSION, n, _FLAG_CRC if self.with_crc else 0))
                f.write(np.asarray(self._offsets, "<u8").tobytes())
                if self.with_crc:
                    f.write(np.asarray(self._crcs, "<u4").tobytes())
                shutil.copyfileobj(payload, f, length=16 * 1024 * 1024)
            os.replace(tmp, self.path)
        finally:
            try:
                os.remove(self._payload_tmp)
            except FileNotFoundError:
                pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class _PyReader:
    """The plain reader: ``os.pread`` on the file, tables in numpy."""

    def __init__(self, path: str):
        self._f = open(path, "rb", buffering=0)
        try:
            self._parse(path)
        except BaseException:
            self._f.close()
            raise

    def _parse(self, path: str) -> None:
        header = self._f.read(_HEADER.size)
        if len(header) < _HEADER.size:
            raise ValueError(f"{path}: truncated TPRC header")
        magic, version, n, flags = _HEADER.unpack(header)
        if magic != _MAGIC or version != _VERSION:
            raise ValueError(f"{path}: not a TPRC v{_VERSION} file")
        self.n = n
        self.flags = flags
        # a corrupt n must not reach read(): the offset table alone needs
        # 8 (n + 1) bytes, so the file's size bounds n (as in the C++ core)
        if n > (os.fstat(self._f.fileno()).st_size - _HEADER.size) // 8:
            raise ValueError(f"{path}: truncated TPRC offset table")
        raw = self._f.read(8 * (n + 1))
        if len(raw) < 8 * (n + 1):
            raise ValueError(f"{path}: truncated TPRC offset table")
        self.offsets = np.frombuffer(raw, "<u8")
        self.crcs = None
        payload_start = _HEADER.size + 8 * (n + 1)
        if flags & _FLAG_CRC:
            raw = self._f.read(4 * n)
            if len(raw) < 4 * n:
                raise ValueError(f"{path}: truncated TPRC crc table")
            self.crcs = np.frombuffer(raw, "<u4")
            payload_start += 4 * n
        self.payload_start = payload_start

    def read(self, i: int, verify_crc: bool = True) -> bytes:
        start, end = int(self.offsets[i]), int(self.offsets[i + 1])
        data = os.pread(self._f.fileno(), end - start, self.payload_start + start)
        if len(data) != end - start:
            raise IOError(f"short read of record {i}")
        if verify_crc and self.crcs is not None:
            if zlib.crc32(data) & 0xFFFFFFFF != int(self.crcs[i]):
                raise IOError(f"crc mismatch in record {i}")
        return data

    def close(self) -> None:
        self._f.close()


class PackedRecordReader:
    """O(1) random access over a TPRC file, safe for concurrent reads
    (both readers are stateless preads).

    ``use_native``: True the C++ core, False the Python reader, None the
    C++ core where ``g++`` is found (a failed build raises)."""

    def __init__(self, path: str | os.PathLike, use_native: bool | None = None):
        self.path = os.fspath(path)
        self._native = None
        self._py = None
        if use_native is None:
            use_native = native.available()
        if use_native:
            self._native = native.NativeReader(self.path)
            self.n = self._native.n
        else:
            self._py = _PyReader(self.path)
            self.n = self._py.n

    def __len__(self) -> int:
        return self.n

    def __getstate__(self) -> dict:
        return {"path": self.path, "use_native": self._native is not None}

    def __setstate__(self, state: dict) -> None:
        self.__init__(state["path"], use_native=state["use_native"])

    def read(self, i: int, verify_crc: bool = True) -> bytes:
        """One record, under a bounded retry (a transient pread failure or
        a CRC mismatch from a page in flight: a retry is a clean re-read)."""
        if not 0 <= i < self.n:
            raise IndexError(i)
        reader = self._native if self._native is not None else self._py
        return retry_call(reader.read, i, verify_crc, what=f"record read {i}")

    def read_batch(self, indices: Sequence[int], verify_crc: bool = True) -> list:
        """Many records (one native call where available), retried as
        ``read``."""
        if self._native is not None:
            return retry_call(self._native.read_batch, indices, verify_crc,
                              what="record batch read")
        return [self.read(int(i), verify_crc) for i in indices]

    def verify_all(self) -> None:
        """The whole file's CRC sweep; raises ``IOError`` at the first
        corrupt record. The datasets skip the per-read CRC
        (``verify_crc=False``): run this after packing or copying a split."""
        for lo in range(0, self.n, 1024):
            self.read_batch(range(lo, min(lo + 1024, self.n)), verify_crc=True)

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        if self._py is not None:
            self._py.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
