"""Bulk CRC32C checksums for the DFS client's data plane.

The port's copy of ``hadoop_tpu/util/crc.py``: every storage packet
carries one big-endian u32 CRC32C per ``bytes_per_chunk`` (512) bytes,
verified by the reader, so the bits must be the reference's.

Two backends, the reference's optional-native policy:

1. ``native/crc32c.cc`` (the reference's source, SSE4.2 ``crc32`` or
   slice-by-8), compiled at first use with the host C++ compiler
   (``c++ -O3 -fPIC -shared -std=c++17``) into ``build/hadoop_tpu_torch/``
   at the root of the checkout, named by a hash of the source and the
   flags, and loaded with ``ctypes``; ``CXX`` names another compiler;
2. a pure-Python table walk, always there and slow (a per-byte loop).

:func:`native_available` builds and loads the library once and says
which backend is live; the first time the fallback is taken it logs a
warning with the reason. :func:`build` raises instead, for callers that
need the native backend. :func:`python_backend` forces the fallback for
a block (tests compare the two).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional

log = logging.getLogger(__name__)

_CASTAGNOLI = 0x82F63B78
SOURCE = Path(__file__).resolve().parents[1] / "native" / "crc32c.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hadoop_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None      # guarded-by: _lock
_tried = False                          # guarded-by: _lock
_force_python = False


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("c++") or \
        shutil.which("g++")
    if not cxx:
        raise RuntimeError("no host C++ compiler (c++, g++ or $CXX) to "
                           "build the native CRC32C")
    return cxx


def target() -> Path:
    """The library built from ``SOURCE`` with ``CXX_FLAGS``."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhtpu_crc32c-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``SOURCE`` unless its build exists; raise on failure."""
    out = target()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)     # atomic: a concurrent loader sees all or none
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.htpu_crc32c.restype = ctypes.c_uint32
    lib.htpu_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p,
                                ctypes.c_size_t]
    lib.htpu_crc32c_chunked.restype = None
    lib.htpu_crc32c_chunked.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                        ctypes.c_size_t, u8p]
    lib.htpu_crc32c_verify.restype = ctypes.c_int64
    lib.htpu_crc32c_verify.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_size_t, ctypes.c_char_p]
    return lib


def _native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _force_python:
        return None
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                _lib = _bind(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, AttributeError) as e:
                log.warning("native CRC32C unavailable, using the "
                            "pure-Python fallback (a few MB/s): %s", e)
            _tried = True
    return _lib


def native_available() -> bool:
    """True when the native library is built, loaded and in use."""
    return _native() is not None


@contextlib.contextmanager
def python_backend():
    """Use the pure-Python backend inside the block (process-wide)."""
    global _force_python
    prev, _force_python = _force_python, True
    try:
        yield
    finally:
        _force_python = prev


# ---------------------------------------------------------------- pure python

def _make_table():
    tbl = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CASTAGNOLI if c & 1 else c >> 1
        tbl.append(c)
    return tbl


_TABLE = _make_table()


def _crc32c_py(crc: int, data) -> int:
    crc ^= 0xFFFFFFFF
    tbl = _TABLE
    for b in data:
        crc = tbl[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _as_bytes(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


def crc32c(data, crc: int = 0) -> int:
    """CRC32C (Castagnoli) of ``data``, continuing from ``crc``."""
    lib = _native()
    if lib is not None:
        buf = _as_bytes(data)
        return lib.htpu_crc32c(crc, buf, len(buf))
    return _crc32c_py(crc, memoryview(data).cast("B"))


class ChecksumError(IOError):
    def __init__(self, msg: str, pos: int = -1):
        super().__init__(msg)
        self.pos = pos


class DataChecksum:
    """Chunked checksum codec: one u32 CRC32C per ``bytes_per_chunk``
    bytes, the reference's ``DataChecksum`` (its header, its error
    texts and positions)."""

    HEADER_LEN = 5  # type byte + u32 bytes_per_chunk

    TYPE_NULL = 0
    TYPE_CRC32C = 2

    def __init__(self, bytes_per_chunk: int = 512, ctype: int = TYPE_CRC32C):
        if bytes_per_chunk <= 0:
            raise ValueError("bytes_per_chunk must be positive")
        self.bytes_per_chunk = bytes_per_chunk
        self.type = ctype

    @property
    def checksum_size(self) -> int:
        return 0 if self.type == self.TYPE_NULL else 4

    def header(self) -> bytes:
        return struct.pack(">BI", self.type, self.bytes_per_chunk)

    @classmethod
    def from_header(cls, hdr: bytes) -> "DataChecksum":
        t, bpc = struct.unpack(">BI", hdr[:5])
        return cls(bpc, t)

    def checksums_for(self, data) -> bytes:
        """Concatenated big-endian u32 CRCs, one per chunk of ``data``."""
        if self.type == self.TYPE_NULL:
            return b""
        lib = _native()
        bpc = self.bytes_per_chunk
        if lib is not None:
            buf = _as_bytes(data)
            out = (ctypes.c_uint8 * (4 * ((len(buf) + bpc - 1) // bpc)))()
            lib.htpu_crc32c_chunked(buf, len(buf), bpc, out)
            return bytes(out)
        mv = memoryview(data).cast("B")
        return b"".join(struct.pack(">I", _crc32c_py(0, mv[off:off + bpc]))
                        for off in range(0, len(mv), bpc))

    def _mismatch(self, data, sums: bytes, i: int, base_pos: int):
        off = i * self.bytes_per_chunk
        expect = struct.unpack_from(">I", sums, 4 * i)[0]
        actual = crc32c(memoryview(data)[off:off + self.bytes_per_chunk])
        return ChecksumError(
            f"checksum mismatch at chunk {i} "
            f"(stream offset {base_pos + off}): "
            f"expected {expect:#010x} got {actual:#010x}",
            pos=base_pos + off)

    def verify(self, data, sums: bytes, base_pos: int = 0) -> None:
        """Raise ``ChecksumError`` at the first corrupt chunk."""
        if self.type == self.TYPE_NULL:
            return
        mv = memoryview(data).cast("B")
        bpc = self.bytes_per_chunk
        n_chunks = (len(mv) + bpc - 1) // bpc
        if len(sums) < 4 * n_chunks:
            raise ChecksumError(
                f"need {4 * n_chunks} checksum bytes, got {len(sums)}")
        lib = _native()
        if lib is not None:
            buf = _as_bytes(data)
            bad = lib.htpu_crc32c_verify(buf, len(buf), bpc, bytes(sums))
            if bad >= 0:
                raise self._mismatch(buf, sums, bad, base_pos)
            return
        for i in range(n_chunks):
            off = i * bpc
            if _crc32c_py(0, mv[off:off + bpc]) != \
                    struct.unpack_from(">I", sums, 4 * i)[0]:
                raise self._mismatch(mv, sums, i, base_pos)
