"""DFS KV tier: hot shared prefixes persisted as files, mapped back by ANY
replica.

The port's own copy of ``hadoop_tpu/serving/kvstore/dfstier.py``, over
the port's filesystem seam (``hadoop_tpu_torch/fs.py``): it uses
``mkdirs``, ``write_all``, ``rename``, ``delete``, ``exists`` and
``read_all`` only, so a ``hadoop_tpu`` ``FileSystem`` (a
``MiniDFSCluster``'s, a ``DistributedFileSystem`` with its replicated
write pipeline and hedged reads) passes in unchanged, and the port's
``LocalFileSystem`` serves runs without one. A replica restart loses HBM
and host RAM, but the store survives; it is also the disaggregation
channel: a prefill replica persists a finished prompt's blocks here and
the decode replica maps them instead of re-prefilling.

Layout: ``<base>/<digest[:2]>/<digest>.kvb`` (two-level fan-out), the
reference's, so either package reads the other's store. Writes go to a
unique ``.tmp`` sibling and rename into place — a reader can never see a
half-written block, and when two replicas race to persist the same
prefix the loser's rename fails against the existing file and its tmp is
deleted (the content is identical by construction: the digest IS the
prefix).
"""

from __future__ import annotations

import logging
import uuid
from typing import Optional, Tuple

import numpy as np

from hadoop_tpu_torch.serving.kvstore.codec import (decode_block,
                                                    dtype_name,
                                                    encode_block)

log = logging.getLogger(__name__)


class DFSTier:
    """KV block store over any ``FileSystemLike`` (DFS in production)."""

    def __init__(self, fs, base_dir: str, *, shape, dtype,
                 codec: str = "raw"):
        self.fs = fs
        self.base_dir = base_dir.rstrip("/") or "/kvcache"
        self.shape = tuple(shape)
        self.dtype = dtype_name(dtype)
        self.codec = codec
        self._made_dirs = set()

    def path(self, digest: bytes) -> str:
        hexd = digest.hex()
        return f"{self.base_dir}/{hexd[:2]}/{hexd}.kvb"

    def _ensure_dir(self, path: str) -> None:
        d = path.rsplit("/", 1)[0]
        if d not in self._made_dirs:
            self.fs.mkdirs(d)
            self._made_dirs.add(d)

    def put(self, digest: bytes, k: np.ndarray, v: np.ndarray) -> bool:
        """Persist one block. Returns True when the block is durable under
        its final name (including the lost-a-race-to-an-identical-writer
        case)."""
        final = self.path(digest)
        tmp = f"{final}.{uuid.uuid4().hex[:8]}.tmp"
        try:
            self._ensure_dir(final)
            self.fs.write_all(tmp, encode_block(k, v, self.codec,
                                                dtype=self.dtype))
            if not self.fs.rename(tmp, final):
                try:
                    self.fs.delete(tmp)
                except (OSError, IOError) as e:
                    log.debug("kv tmp cleanup of %s failed: %s", tmp, e)
                # a refused rename usually means another replica
                # persisted the same prefix first (the digest keys
                # identical content, so theirs is ours) — but verify:
                # claiming durability on any other refusal would mark
                # the block persisted forever with nothing on disk
                if not self.fs.exists(final):
                    log.warning("kv block rename %s -> %s refused with "
                                "no winner in place; not durable",
                                tmp, final)
                    return False
            return True
        except (OSError, IOError) as e:
            log.debug("kv block persist %s failed: %s", final, e)
            try:
                self.fs.delete(tmp)
            except (OSError, IOError):
                log.debug("kv tmp cleanup of %s failed after write "
                          "error", tmp)
            return False

    def get(self, digest: bytes
            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Fetch + decode one block; any failure is a miss — the caller
        falls back to prefill, never to a corrupt context."""
        try:
            data = self.fs.read_all(self.path(digest))
        except (OSError, IOError):
            return None
        try:
            k, v, _ = decode_block(data, shape=self.shape,
                                   dtype=self.dtype)
        except (ValueError, KeyError) as e:
            log.warning("undecodable KV block %s (%s); treating as "
                        "miss", self.path(digest), e)
            return None
        return k, v
