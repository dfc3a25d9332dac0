"""The KMS's REST client, as the DFS client uses it.

The port's copy of ``KMSKeyProvider`` from ``hadoop_tpu/crypto/kms.py``:
a remote KMS behind the same ``KeyProvider`` seam the crypto streams
use, calling as ``user`` (the ``user.name`` query parameter). The KMS
server and its ACLs are the fleet's daemon, used as it is.

Endpoints (JSON), under ``<base>/v1``, ``base`` ``/kms`` by default:

    GET    keys/names                          list keys
    POST   keys                                {name, length} create
    GET    key/<name>/_currentversion
    POST   key/<name>/_roll
    GET    key/<name>/_eek?eek_op=generate
    POST   keyversion/<ver>/_eek?eek_op=decrypt   {name, iv, material}
    DELETE key/<name>

A 403, or a 500 whose body names ``PermissionError`` (older servers), is
``PermissionError``; another HTTP error is ``IOError`` with the body.
"""

from __future__ import annotations

import base64
import json
from typing import Dict, List, Optional

from hadoop_tpu_torch.crypto.keys import (EncryptedKeyVersion, KeyProvider,
                                          KeyVersion)


def _b64(b: bytes) -> str:
    return base64.b64encode(b).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


class KMSKeyProvider(KeyProvider):
    """Client provider of the KMS at ``addr`` (``host:port``)."""

    def __init__(self, addr: str, user: str = "client",
                 base_path: str = "/kms"):
        self._base = f"http://{addr}{base_path.rstrip('/')}/v1"
        self._user = user

    def _call(self, method: str, path: str, body: Optional[Dict] = None):
        import urllib.error
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            f"{self._base}/{path}"
            f"{'&' if '?' in path else '?'}user.name={self._user}",
            data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            if e.code == 403 or (e.code == 500 and
                                 "PermissionError" in detail):
                raise PermissionError(detail) from e
            raise IOError(f"KMS {e.code}: {detail}") from e

    @staticmethod
    def _kv(d: Dict) -> KeyVersion:
        return KeyVersion(d["name"], d["versionName"], _unb64(d["material"]))

    def create_key(self, name: str, bits: int = 128) -> KeyVersion:
        return self._kv(self._call("POST", "keys",
                                   {"name": name, "length": bits}))

    def get_current_key(self, name: str) -> KeyVersion:
        return self._kv(self._call("GET", f"key/{name}/_currentversion"))

    def roll_key(self, name: str) -> KeyVersion:
        return self._kv(self._call("POST", f"key/{name}/_roll", {}))

    def get_keys(self) -> List[str]:
        return self._call("GET", "keys/names")

    def delete_key(self, name: str) -> None:
        self._call("DELETE", f"key/{name}")

    def generate_encrypted_key(self, name: str) -> EncryptedKeyVersion:
        d = self._call("GET", f"key/{name}/_eek?eek_op=generate")
        return EncryptedKeyVersion(
            d["name"], d["versionName"], _unb64(d["iv"]),
            _unb64(d["encryptedKeyVersion"]["material"]))

    def decrypt_encrypted_key(self, ekv: EncryptedKeyVersion) -> bytes:
        d = self._call(
            "POST", f"keyversion/{ekv.key_version}/_eek?eek_op=decrypt",
            {"name": ekv.key_name, "iv": _b64(ekv.iv),
             "material": _b64(ekv.edek)})
        return _unb64(d["material"])
