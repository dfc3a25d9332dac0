"""DistributedFileSystem: the filesystem face of the DFS client.

The port's copy of ``hadoop_tpu/dfs/client/filesystem.py``, the
``htpu://host:port`` scheme. It has the nine methods of the port's
``FileSystemLike`` (``fs.py``), so the trainer, checkpoints, data
loader, serving loader and KV tier run on it as on the local disk, and
``create``, ``open``, listing, a content summary, EC policies, cache
directives and the namespace features (replication, permissions and
owners, quotas, xattrs, ACLs, storage policies, snapshots, concat and
truncate). :func:`create_instance` takes the NameNode from
the URI's authority, or from ``dfs.namenode.rpc-address`` (a comma list
of ``host:port``, an HA pair) when the URI has none.

Encryption zones: with ``dfs.encryption.key.provider.uri`` set, a file
inside a zone is opened through ``crypto.CryptoInputStream`` and created
through ``crypto.CryptoOutputStream`` on its DEK, which the client (not
the NameNode) decrypts from the file's EDEK at the KMS, calling as
``security.ugi.current_user()``. The URI takes the reference's form,
``kms://host:port``, and Hadoop's, ``kms://http@host:port/kms``, whose
path is the root of the KMS's ``/v1`` REST resource (the reference's
client reads the whole remainder as ``host:port`` and cannot dial it).
A client with no KMS gets ``PermissionError`` for a file in a zone and
never hands out the zone's ciphertext as the file.
"""

from __future__ import annotations

import base64
from typing import List, Optional, Tuple
from urllib.parse import urlparse

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.dfs.client.dfsclient import DFSClient
from hadoop_tpu_torch.dfs.protocol.records import FileStatus
from hadoop_tpu_torch.util.misc import parse_addr_list

KMS_URI_KEY = "dfs.encryption.key.provider.uri"
NN_RPC_ADDRESS_KEY = "dfs.namenode.rpc-address"
NN_RPC_ADDRESS_DEFAULT = "127.0.0.1:8020"


def kms_endpoint(uri: str) -> Tuple[str, str]:
    """(``host:port``, REST base path) of a KMS provider URI:
    ``kms://host:port`` or ``kms://http@host:port[/path]`` (the path
    ``/kms`` when absent)."""
    if not uri.startswith("kms://"):
        raise ValueError(f"{KMS_URI_KEY}: {uri!r} is not a kms:// URI")
    rest = uri[len("kms://"):]
    scheme, at, rest = rest.partition("@")
    if not at:
        scheme, rest = "http", scheme
    if scheme != "http":
        raise ValueError(f"{KMS_URI_KEY}: {uri!r}: the KMS client speaks "
                         f"http, not {scheme!r}")
    hostport, slash, path = rest.partition("/")
    if not hostport:
        raise ValueError(f"{KMS_URI_KEY}: {uri!r} names no host")
    return hostport, ("/" + path.strip("/")) if slash and path.strip("/") \
        else "/kms"


class DistributedFileSystem:
    def __init__(self, nn_addrs, conf: Optional[ConfLike] = None):
        conf = conf or Configuration()
        uri = conf.get(KMS_URI_KEY, "")
        self._kms_endpoint = kms_endpoint(uri) if uri else None
        self._kms_provider = None
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

    # -------------------------------------------------- encryption at rest

    def _kms(self):
        if self._kms_endpoint is None:
            return None
        if self._kms_provider is None:
            from hadoop_tpu_torch.crypto.kms import KMSKeyProvider
            from hadoop_tpu_torch.security.ugi import current_user
            addr, base = self._kms_endpoint
            self._kms_provider = KMSKeyProvider(
                addr, user=current_user().user_name, base_path=base)
        return self._kms_provider

    def _dek_for(self, path: str):
        """(DEK, IV) of a file in an encryption zone, or None outside
        one. The client resolves EDEK to DEK, so plaintext keys never
        reach the metadata plane."""
        info = self.client.nn.get_encryption_info(path)
        if info is None:
            return None
        kms = self._kms()
        if kms is None:
            raise PermissionError(
                f"{path} is in an encryption zone but this client has no "
                f"KMS configured ({KMS_URI_KEY})")
        from hadoop_tpu_torch.crypto.keys import EncryptedKeyVersion
        ekv = EncryptedKeyVersion(
            info["key"], info["version"], base64.b64decode(info["iv"]),
            base64.b64decode(info["edek"]))
        return kms.decrypt_encrypted_key(ekv), ekv.iv

    def create_encryption_zone(self, path: str, key_name: str) -> bool:
        return self.client.nn.create_encryption_zone(path, key_name)

    def get_encryption_info(self, path: str):
        return self.client.nn.get_encryption_info(path)

    def list_encryption_zones(self):
        return self.client.nn.list_encryption_zones()

    # ---------------------------------------------------------- streams

    def open(self, path: str):
        stream = self.client.open(path)
        try:
            dek_iv = self._dek_for(path)
        except BaseException:
            stream.close()
            raise
        if dek_iv is None:
            return stream
        from hadoop_tpu_torch.crypto.streams import CryptoInputStream
        return CryptoInputStream(stream, *dek_iv)

    def create(self, path: str, overwrite: bool = False, replication=None,
               block_size=None):
        stream = self.client.create(path, overwrite=overwrite,
                                    replication=replication,
                                    block_size=block_size)
        try:
            dek_iv = self._dek_for(path)
        except BaseException:
            stream.close()
            self.client.nn.delete(path, False)
            raise
        if dek_iv is None:
            return stream
        from hadoop_tpu_torch.crypto.streams import CryptoOutputStream
        return CryptoOutputStream(stream, *dek_iv)

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

    def set_replication(self, path: str, replication: int) -> bool:
        return self.client.nn.set_replication(path, replication)

    def set_permission(self, path: str, permission: int) -> None:
        self.client.nn.set_permission(path, permission)

    def set_owner(self, path: str, owner: str, group: str) -> None:
        self.client.nn.set_owner(path, owner, group)

    # ------------------------------------------------- namespace features

    def set_quota(self, path: str, ns_quota: int = -1,
                  space_quota: int = -1) -> bool:
        return self.client.nn.set_quota(path, ns_quota, space_quota)

    def set_xattr(self, path: str, name: str, value: bytes) -> bool:
        return self.client.nn.set_xattr(path, name, value)

    def get_xattrs(self, path: str, names=None):
        return self.client.nn.get_xattrs(path, names)

    def remove_xattr(self, path: str, name: str) -> bool:
        return self.client.nn.remove_xattr(path, name)

    def set_acl(self, path: str, entries) -> bool:
        return self.client.nn.set_acl(path, entries)

    def get_acl(self, path: str):
        return self.client.nn.get_acl(path)

    def set_storage_policy(self, path: str, policy: str) -> bool:
        return self.client.nn.set_storage_policy(path, policy)

    def get_storage_policy(self, path: str) -> str:
        return self.client.nn.get_storage_policy(path)

    def allow_snapshot(self, path: str) -> bool:
        return self.client.nn.allow_snapshot(path)

    def create_snapshot(self, path: str, name: str) -> str:
        return self.client.nn.create_snapshot(path, name)

    def delete_snapshot(self, path: str, name: str) -> bool:
        return self.client.nn.delete_snapshot(path, name)

    def rename_snapshot(self, path: str, old: str, new: str) -> bool:
        return self.client.nn.rename_snapshot(path, old, new)

    def snapshot_diff(self, path: str, from_snap: str, to_snap: str):
        return self.client.nn.snapshot_diff(path, from_snap, to_snap)

    def concat(self, target: str, srcs) -> bool:
        return self.client.nn.concat(target, srcs)

    def truncate(self, path: str, new_length: int) -> bool:
        return self.client.nn.truncate(path, new_length)

    def content_summary(self, path: str):
        return self.client.nn.content_summary(path)

    # ------------------------------------------- erasure coding, cache

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

    def close(self) -> None:
        self.client.close()
