"""The filesystem the port's trainer, data and checkpoints run on.

The port does not carry a DFS client. Its data loader, checkpoints and
serving loader take any object with the nine methods of
:class:`FileSystemLike`, the part of ``hadoop_tpu``'s ``FileSystem``
they use, so the caller passes a filesystem in: a ``hadoop_tpu``
``FileSystem`` (a ``MiniDFSCluster``'s, a ``DistributedFileSystem``)
works unchanged, and the port never imports or checks for its types.

- ``get_file_status(path)`` returns a status with ``.path`` (str),
  ``.is_dir`` (bool) and ``.length`` (bytes); it raises
  ``FileNotFoundError`` when ``path`` does not exist.
- ``list_status(path)`` returns the statuses of a directory's entries
  (of the file itself, for a file); it raises ``FileNotFoundError``.
- ``open(path)`` returns a binary stream with ``seek``, ``read`` and
  ``close``.
- ``mkdirs(path)``, ``delete(path, recursive=...)``, ``exists(path)``,
  ``rename(src, dst)``.
- ``read_all(path)`` returns a file's bytes; ``write_all(path, data)``
  replaces a file with ``data``.

:class:`LocalFileSystem` is the port's own copy of the reference's local
filesystem (``hadoop_tpu/fs/filesystem.py``'s ``LocalFileSystem``), for
runs that have no ``hadoop_tpu`` to import.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import BinaryIO, List, Protocol


@dataclasses.dataclass
class FileStatus:
    """A path's status: the fields of the reference's ``FileStatus``."""
    path: str
    is_dir: bool
    length: int = 0
    replication: int = 0
    block_size: int = 0
    mtime: float = 0.0
    atime: float = 0.0
    owner: str = ""
    group: str = ""
    permission: int = 0o644


class FileSystemLike(Protocol):
    """What the port asks of a filesystem (see the module docstring)."""

    def get_file_status(self, path: str): ...

    def list_status(self, path: str) -> list: ...

    def open(self, path: str): ...

    def mkdirs(self, path: str) -> bool: ...

    def delete(self, path: str, recursive: bool = False) -> bool: ...

    def exists(self, path: str) -> bool: ...

    def read_all(self, path: str) -> bytes: ...

    def write_all(self, path: str, data: bytes) -> None: ...

    def rename(self, src: str, dst: str) -> bool: ...


class LocalFileSystem:
    """The local disk, as the reference's ``LocalFileSystem``."""

    def open(self, path: str) -> BinaryIO:
        return open(path, "rb")

    def create(self, path: str, overwrite: bool = False) -> BinaryIO:
        if not overwrite and os.path.exists(path):
            raise FileExistsError(path)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        return open(path, "wb")

    def mkdirs(self, path: str) -> bool:
        os.makedirs(path, exist_ok=True)
        return True

    def delete(self, path: str, recursive: bool = False) -> bool:
        if not os.path.exists(path):
            return False
        if os.path.isdir(path):
            if os.listdir(path) and not recursive:
                raise OSError(f"{path} is non-empty")
            shutil.rmtree(path)
        else:
            os.remove(path)
        return True

    def rename(self, src: str, dst: str) -> bool:
        if os.path.isdir(dst):
            dst = os.path.join(dst, os.path.basename(src.rstrip("/")))
        if os.path.exists(dst):
            raise FileExistsError(dst)
        os.rename(src, dst)
        return True

    def _status(self, path: str) -> FileStatus:
        st = os.stat(path)
        return FileStatus(path, os.path.isdir(path), st.st_size, 1, 0,
                          st.st_mtime, st.st_atime, owner=str(st.st_uid),
                          permission=st.st_mode & 0o777)

    def list_status(self, path: str) -> List[FileStatus]:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if os.path.isfile(path):
            return [self._status(path)]
        return [self._status(os.path.join(path, n))
                for n in sorted(os.listdir(path))]

    def get_file_status(self, path: str) -> FileStatus:
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        return self._status(path)

    def exists(self, path: str) -> bool:
        try:
            self.get_file_status(path)
            return True
        except FileNotFoundError:
            return False

    def read_all(self, path: str) -> bytes:
        with self.open(path) as f:
            return f.read()

    def write_all(self, path: str, data: bytes,
                  overwrite: bool = True) -> None:
        with self.create(path, overwrite=overwrite) as f:
            f.write(data)
