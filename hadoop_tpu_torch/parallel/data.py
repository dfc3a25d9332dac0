"""Token dataloader streaming from a filesystem.

The counterpart of ``hadoop_tpu/parallel/data.py``: the trainer's input
reads flat little-endian token files (uint16 or int32) straight off the
filesystem the caller passes (``hadoop_tpu_torch.fs``), and cuts the
stream into batches deterministically, so that a resumed run sees
exactly the continuation of the stream. It stays numpy on the host; the
trainer moves the rows to the device.

Resume contract: ``state()`` is a tiny dict (the global token cursor)
that travels with the model checkpoint; ``restore(state)`` repositions
the stream so that batch N+1 after a restore equals batch N+1 of an
uninterrupted run.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from hadoop_tpu_torch.fs import FileSystemLike


class TokenDataset:
    """Sequential [batch, seq+1] int32 batches from token files.

    Each batch row is ``seq + 1`` tokens so the caller can slice
    (inputs, targets) = (row[:-1], row[1:]). ``path`` is a file or a
    directory; a directory's files are walked in sorted order, skipping
    names that start with ``_`` or ``.``. The concatenated stream is tiled
    into rows and wraps around at its end (epochs are implicit). Reads
    take spans of ``read_mb`` MiB (at least one batch).
    """

    def __init__(self, fs: FileSystemLike, path: str, batch: int, seq: int,
                 dtype: str = "uint16", read_mb: int = 8):
        self.fs = fs
        self.batch = batch
        self.seq = seq
        self.dtype = np.dtype(dtype)
        st = fs.get_file_status(path)
        if st.is_dir:
            listing = fs.list_status(path)
            self.files: List[str] = sorted(
                s.path for s in listing
                if not s.is_dir and not s.path.rsplit("/", 1)[-1]
                .startswith(("_", ".")))
            sizes = {s.path: s.length for s in listing}
            self.sizes = [sizes[f] for f in self.files]
        else:
            self.files = [path]
            self.sizes = [st.length]
        itemsize = self.dtype.itemsize
        self.tokens_per_file = [n // itemsize for n in self.sizes]
        self.total_tokens = sum(self.tokens_per_file)
        need = batch * (seq + 1)
        if self.total_tokens < need:
            raise ValueError(f"dataset {path} has {self.total_tokens} "
                             f"tokens < one batch ({need})")
        self._pos = 0          # global token cursor
        self._buf = np.empty(0, np.int32)
        self._read_tokens = max(need, (read_mb << 20) // itemsize)

    # ------------------------------------------------------------- cursor

    def state(self) -> Dict:
        """Resume state: save it alongside the model checkpoint."""
        return {"pos": int(self._pos) - int(self._buf.size)}

    def restore(self, state: Dict) -> None:
        self._pos = int(state["pos"]) % max(self.total_tokens, 1)
        self._buf = np.empty(0, np.int32)

    # -------------------------------------------------------------- reads

    def _read_span(self, pos: int, n: int) -> np.ndarray:
        """Read n tokens at global token offset pos (wrapping)."""
        out = np.empty(n, np.int32)
        filled = 0
        pos %= self.total_tokens
        while filled < n:
            fi, in_file = self._locate(pos)
            take = min(n - filled, self.tokens_per_file[fi] - in_file)
            stream = self.fs.open(self.files[fi])
            try:
                stream.seek(in_file * self.dtype.itemsize)
                raw = stream.read(take * self.dtype.itemsize)
            finally:
                stream.close()
            got = len(raw) // self.dtype.itemsize
            out[filled:filled + got] = np.frombuffer(
                raw, self.dtype, count=got).astype(np.int32)
            filled += got
            pos = (pos + got) % self.total_tokens
            if got == 0:
                raise IOError(f"short read from {self.files[fi]}")
        return out

    def _locate(self, pos: int):
        for fi, n in enumerate(self.tokens_per_file):
            if pos < n:
                return fi, pos
            pos -= n
        raise IndexError(pos)

    def next_batch(self) -> np.ndarray:
        """[batch, seq+1] int32, advancing the cursor."""
        need = self.batch * (self.seq + 1)
        if self._buf.size < need:
            span = self._read_span(self._pos, self._read_tokens)
            self._pos = (self._pos + span.size) % self.total_tokens
            self._buf = np.concatenate([self._buf, span]) \
                if self._buf.size else span
        out = self._buf[:need].reshape(self.batch, self.seq + 1)
        self._buf = self._buf[need:]
        return out

    def __iter__(self):
        while True:
            yield self.next_batch()
