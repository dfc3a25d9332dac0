"""Page-cache hints for the DataNode's block files.

The port's copy of the NativeIO part of ``hadoop_tpu/native/__init__.py``
(``fadvise``, ``sync_file_range``): the block store drops written bytes
out of the page cache behind the cursor (``dfs.datanode.drop.cache.
behind.writes``) and asks for sequential readahead on a block scan.

- :func:`fadvise` is ``os.posix_fadvise``;
- :func:`sync_file_range` calls ``native/native_io.cc`` (the reference's
  source), compiled at first use by ``util/crc.py``'s
  ``build_library`` as ``crc32c.cc`` is (``c++ -O3 -fPIC -shared
  -std=c++17`` into ``build/hadoop_tpu_torch/``, named by a hash of the
  source).

Both are hints: without the call or the library they return False and do
nothing, as the reference does without its native library.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path
from typing import Optional

from hadoop_tpu_torch.util import crc

log = logging.getLogger(__name__)

FADV_SEQUENTIAL = 2
FADV_DONTNEED = 4
FADV_WILLNEED = 3

_ADVICE = {FADV_SEQUENTIAL: "POSIX_FADV_SEQUENTIAL",
           FADV_DONTNEED: "POSIX_FADV_DONTNEED",
           FADV_WILLNEED: "POSIX_FADV_WILLNEED"}

SOURCE = Path(__file__).resolve().parents[1] / "native" / "native_io.cc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None      # guarded-by: _lock
_tried = False                          # guarded-by: _lock


def fadvise(fd: int, offset: int, length: int, advice: int) -> bool:
    """``posix_fadvise`` with the reference's advice numbers; False (and
    nothing done) where the platform lacks it."""
    fn = getattr(os, "posix_fadvise", None)
    name = _ADVICE.get(advice)
    if fn is None or name is None or not hasattr(os, name):
        return False
    try:
        fn(fd, offset, length, getattr(os, name))
        return True
    except (OSError, ValueError):
        return False


def _native() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    with _lock:
        if not _tried:
            try:
                lib = ctypes.CDLL(str(crc.build_library(
                    SOURCE, "libhtpu_nativeio")))
                lib.htpu_sync_range.restype = ctypes.c_int
                lib.htpu_sync_range.argtypes = [
                    ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int]
                _lib = lib
            except (OSError, RuntimeError, AttributeError) as e:
                log.warning("native IO unavailable, sync_file_range is a "
                            "no-op: %s", e)
            _tried = True
    return _lib


def native_available() -> bool:
    return _native() is not None


def sync_file_range(fd: int, offset: int, nbytes: int,
                    wait: bool = False) -> bool:
    """Start (and with ``wait``, await) writeback of a byte range."""
    lib = _native()
    if lib is None:
        return False
    try:
        return lib.htpu_sync_range(fd, offset, nbytes, 1 if wait else 0) == 0
    except (OSError, ValueError):
        return False
