"""The key provider API, a file-backed keystore and a KMS client.

The port's copy of ``hadoop_tpu/crypto/keys.py``: named keys with rolled
versions, and EDEKs (encrypted data-encryption keys) that are generated
under a zone key and decrypted only by the provider, so the NameNode
never sees a plaintext DEK (the envelope encryption that encryption
zones rely on).

- :class:`FileKeyProvider` keeps a JSON keystore on the local disk, in
  the reference's format: a file one writes, the other reads.
- :class:`KMSClientProvider` speaks the KMS's REST face.
- :func:`make_provider` turns a provider URI into one of them.

The cipher (``streams._crypt``) is imported lazily, as the streams do.
"""

from __future__ import annotations

import base64
import json
import os
import threading
from typing import Dict, List, Optional

from hadoop_tpu_torch.crypto.streams import _crypt


class KeyVersion:
    __slots__ = ("name", "version", "material")

    def __init__(self, name: str, version: str, material: bytes):
        self.name = name
        self.version = version
        self.material = material


class EncryptedKeyVersion:
    """An EDEK: a DEK encrypted under a zone-key version."""

    __slots__ = ("key_name", "key_version", "iv", "edek")

    def __init__(self, key_name: str, key_version: str, iv: bytes,
                 edek: bytes):
        self.key_name = key_name
        self.key_version = key_version
        self.iv = iv
        self.edek = edek

    def to_wire(self) -> Dict:
        return {"kn": self.key_name, "kv": self.key_version,
                "iv": self.iv, "e": self.edek}

    @classmethod
    def from_wire(cls, d: Dict) -> "EncryptedKeyVersion":
        return cls(d["kn"], d["kv"], d["iv"], d["e"])


class KeyProvider:
    """The abstract provider, with the envelope-encryption extension."""

    def create_key(self, name: str, bits: int = 128) -> KeyVersion:
        raise NotImplementedError

    def roll_key(self, name: str) -> KeyVersion:
        raise NotImplementedError

    def get_current_key(self, name: str) -> KeyVersion:
        raise NotImplementedError

    def get_key_version(self, name: str, version: str) -> KeyVersion:
        raise NotImplementedError

    def get_keys(self) -> List[str]:
        raise NotImplementedError

    def delete_key(self, name: str) -> None:
        raise NotImplementedError

    def generate_encrypted_key(self, name: str) -> EncryptedKeyVersion:
        """A fresh random DEK, returned encrypted under the named key."""
        zone_key = self.get_current_key(name)
        dek = os.urandom(len(zone_key.material))
        iv = os.urandom(16)
        edek = _crypt(zone_key.material, iv, 0, dek)
        return EncryptedKeyVersion(name, zone_key.version, iv, edek)

    def decrypt_encrypted_key(self, ekv: EncryptedKeyVersion) -> bytes:
        zone_key = self.get_key_version(ekv.key_name, ekv.key_version)
        return _crypt(zone_key.material, ekv.iv, 0, ekv.edek)


class FileKeyProvider(KeyProvider):
    """A JSON keystore on the local disk, written 0600 through a rename:
    ``{name: {"current": version, "versions": {version: base64}}}``."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._keys: Dict[str, Dict] = {}
        self._load()

    def _load(self) -> None:
        if os.path.exists(self.path):
            with open(self.path) as f:
                raw = json.load(f)
            self._keys = {
                name: {"current": k["current"],
                       "versions": {v: base64.b64decode(m)
                                    for v, m in k["versions"].items()}}
                for name, k in raw.items()}

    def _save_locked(self) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        raw = {
            name: {"current": k["current"],
                   "versions": {v: base64.b64encode(m).decode()
                                for v, m in k["versions"].items()}}
            for name, k in self._keys.items()}
        tmp = self.path + ".tmp"
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(raw, f)
        os.replace(tmp, self.path)

    def create_key(self, name: str, bits: int = 128) -> KeyVersion:
        with self._lock:
            if name in self._keys:
                raise KeyError(f"key {name} exists")
            material = os.urandom(bits // 8)
            self._keys[name] = {"current": f"{name}@0",
                                "versions": {f"{name}@0": material}}
            self._save_locked()
            return KeyVersion(name, f"{name}@0", material)

    def roll_key(self, name: str) -> KeyVersion:
        with self._lock:
            k = self._keys[name]
            version = f"{name}@{len(k['versions'])}"
            material = os.urandom(len(next(iter(k["versions"].values()))))
            k["versions"][version] = material
            k["current"] = version
            self._save_locked()
            return KeyVersion(name, version, material)

    def get_current_key(self, name: str) -> KeyVersion:
        with self._lock:
            k = self._keys.get(name)
            if k is None:
                raise KeyError(f"no such key {name}")
            return KeyVersion(name, k["current"],
                              k["versions"][k["current"]])

    def get_key_version(self, name: str, version: str) -> KeyVersion:
        with self._lock:
            k = self._keys.get(name)
            if k is None or version not in k["versions"]:
                raise KeyError(f"no such key version {version}")
            return KeyVersion(name, version, k["versions"][version])

    def get_keys(self) -> List[str]:
        with self._lock:
            return sorted(self._keys)

    def delete_key(self, name: str) -> None:
        with self._lock:
            self._keys.pop(name, None)
            self._save_locked()


class KMSClientProvider(KeyProvider):
    """REST client of the KMS daemon at ``base_url``
    (``http://host:port``). A 404 is ``KeyError``."""

    def __init__(self, base_url: str):
        self.base = base_url.rstrip("/")

    def _req(self, method: str, path: str, body: Optional[Dict] = None):
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(f"{self.base}{path}", data=data,
                                     method=method)
        if data:
            req.add_header("Content-Type", "application/json")
        try:
            with urllib.request.urlopen(req, timeout=15) as r:
                payload = r.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KeyError(f"KMS: {path} not found") from e
            raise

    @staticmethod
    def _kv(d: Dict) -> KeyVersion:
        return KeyVersion(d["name"], d["versionName"],
                          base64.b64decode(d["material"]))

    def create_key(self, name: str, bits: int = 128) -> KeyVersion:
        return self._kv(self._req("POST", "/kms/v1/keys",
                                  {"name": name, "length": bits}))

    def roll_key(self, name: str) -> KeyVersion:
        return self._kv(self._req("POST", f"/kms/v1/key/{name}/_roll", {}))

    def get_current_key(self, name: str) -> KeyVersion:
        return self._kv(self._req("GET",
                                  f"/kms/v1/key/{name}/_currentversion"))

    def get_key_version(self, name: str, version: str) -> KeyVersion:
        return self._kv(self._req("GET", f"/kms/v1/keyversion/{version}"))

    def get_keys(self) -> List[str]:
        return self._req("GET", "/kms/v1/keys/names")

    def delete_key(self, name: str) -> None:
        self._req("DELETE", f"/kms/v1/key/{name}")

    def generate_encrypted_key(self, name: str) -> EncryptedKeyVersion:
        # the server routes on eek_op and nests the EDEK's material
        d = self._req("GET", f"/kms/v1/key/{name}/_eek?eek_op=generate")
        return EncryptedKeyVersion(
            d["name"], d["versionName"], base64.b64decode(d["iv"]),
            base64.b64decode(d["encryptedKeyVersion"]["material"]))

    def decrypt_encrypted_key(self, ekv: EncryptedKeyVersion) -> bytes:
        d = self._req("POST", f"/kms/v1/keyversion/{ekv.key_version}"
                              f"/_eek?eek_op=decrypt",
                      {"name": ekv.key_name,
                       "iv": base64.b64encode(ekv.iv).decode(),
                       "material": base64.b64encode(ekv.edek).decode()})
        return base64.b64decode(d["material"])


def make_provider(uri: str) -> KeyProvider:
    """``kms://http@host:port[/path]`` -> :class:`KMSClientProvider` on
    ``http://host:port[/path]``; ``file:///path`` or a bare path ->
    :class:`FileKeyProvider`."""
    if uri.startswith("kms://"):
        rest = uri[len("kms://"):]
        scheme, _, hostport = rest.partition("@")
        return KMSClientProvider(f"{scheme or 'http'}://{hostport}")
    if uri.startswith("file://"):
        uri = uri[len("file://"):]
    return FileKeyProvider(uri)
