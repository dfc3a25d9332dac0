"""DistributedFileSystem: the filesystem face of the DFS client.

The port's copy of ``hadoop_tpu/dfs/client/filesystem.py``, the
``htpu://host:port`` scheme. It has the nine methods of the port's
``FileSystemLike`` (``fs.py``), so the trainer, checkpoints, data
loader, serving loader and KV tier run on it as on the local disk, and
``create``, ``open``, listing, a content summary, EC policies and
cache directives. :func:`create_instance` takes the NameNode from
the URI's authority, or from ``dfs.namenode.rpc-address`` (a comma list
of ``host:port``, an HA pair) when the URI has none.

Encryption zones are not ported (ROADMAP Queue A 9 part 2, the KMS
client and the crypto streams): a filesystem whose conf sets
``dfs.encryption.key.provider.uri`` is refused with
``NotImplementedError``, and opening or creating a file inside a zone
raises the reference's ``PermissionError`` for a client with no KMS,
never hands out the zone's ciphertext as the file.
"""

from __future__ import annotations

from typing import List, Optional
from urllib.parse import urlparse

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.dfs.client.dfsclient import DFSClient
from hadoop_tpu_torch.dfs.protocol.records import FileStatus

KMS_URI_KEY = "dfs.encryption.key.provider.uri"
NN_RPC_ADDRESS_KEY = "dfs.namenode.rpc-address"
NN_RPC_ADDRESS_DEFAULT = "127.0.0.1:8020"


def parse_addr_list(spec: str):
    """``host:port[,host:port...]`` -> [(host, port)], strictly."""
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"invalid host:port {part!r} in {spec!r}")
        out.append((host or "127.0.0.1", int(port)))
    return out


class DistributedFileSystem:
    def __init__(self, nn_addrs, conf: Optional[ConfLike] = None):
        conf = conf or Configuration()
        if conf.get(KMS_URI_KEY, ""):
            raise NotImplementedError(
                f"encryption zones ({KMS_URI_KEY}: the KMS client and the "
                f"crypto streams) are not ported to hadoop_tpu_torch yet "
                f"(ROADMAP Queue A 9 part 2)")
        self.client = DFSClient(nn_addrs, conf)

    @classmethod
    def create_instance(cls, uri: str, conf: Optional[ConfLike] = None
                        ) -> "DistributedFileSystem":
        conf = conf or Configuration()
        authority = urlparse(uri).netloc
        if authority:
            host, _, port = authority.partition(":")
            addrs = [(host, int(port))]
        else:
            addrs = parse_addr_list(conf.get(NN_RPC_ADDRESS_KEY,
                                             NN_RPC_ADDRESS_DEFAULT))
        return cls(addrs, conf)

    def _refuse_zone(self, path: str) -> None:
        if self.client.nn.get_encryption_info(path) is not None:
            raise PermissionError(
                f"{path} is in an encryption zone but this client has no "
                f"KMS configured ({KMS_URI_KEY})")

    # ---------------------------------------------------------- streams

    def open(self, path: str):
        stream = self.client.open(path)
        self._refuse_zone(path)
        return stream

    def create(self, path: str, overwrite: bool = False, replication=None,
               block_size=None):
        stream = self.client.create(path, overwrite=overwrite,
                                    replication=replication,
                                    block_size=block_size)
        try:
            self._refuse_zone(path)
        except PermissionError:
            stream.close()
            self.client.nn.delete(path, False)
            raise
        return stream

    def read_all(self, path: str) -> bytes:
        with self.open(path) as f:
            return f.read()

    def write_all(self, path: str, data: bytes,
                  overwrite: bool = True) -> None:
        with self.create(path, overwrite=overwrite) as f:
            f.write(data)

    # -------------------------------------------------------- namespace

    def mkdirs(self, path: str) -> bool:
        return self.client.nn.mkdirs(path)

    def delete(self, path: str, recursive: bool = False) -> bool:
        return self.client.nn.delete(path, recursive)

    def rename(self, src: str, dst: str) -> bool:
        return self.client.nn.rename(src, dst)

    def list_status(self, path: str) -> List[FileStatus]:
        return [FileStatus.from_wire(d) for d in self.client.nn.listing(path)]

    def get_file_status(self, path: str) -> FileStatus:
        info = self.client.nn.get_file_info(path)
        if info is None:
            raise FileNotFoundError(path)
        return FileStatus.from_wire(info)

    def exists(self, path: str) -> bool:
        try:
            self.get_file_status(path)
            return True
        except FileNotFoundError:
            return False

    def content_summary(self, path: str):
        return self.client.nn.content_summary(path)

    # --------------------------------------- erasure coding, cache, zones

    def set_ec_policy(self, path: str, policy: Optional[str]) -> bool:
        return self.client.set_ec_policy(path, policy)

    def get_ec_policy(self, path: str) -> Optional[str]:
        return self.client.get_ec_policy(path)

    def add_cache_directive(self, path: str) -> int:
        return self.client.nn.add_cache_directive(path)

    def remove_cache_directive(self, directive_id: int) -> bool:
        return self.client.nn.remove_cache_directive(directive_id)

    def list_cache_directives(self):
        return {int(k): v
                for k, v in self.client.nn.list_cache_directives().items()}

    def get_encryption_info(self, path: str):
        return self.client.nn.get_encryption_info(path)

    def close(self) -> None:
        self.client.close()
