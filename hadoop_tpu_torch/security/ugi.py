"""The caller's identity on an RPC connection, and the tokens it carries.

The client half of ``hadoop_tpu/security/ugi.py``: what the port's RPC
client puts in a connection header (the effective user, the real user
under impersonation, the auth method), the credentials its SASL
handshake proves (``sasl_password``, from ``login_from_keytab``) and
the tokens it holds (``tokens``, by kind). The login user is the
process's OS user; ``do_as`` runs a callable as another user, whom
:func:`current_user` then returns, as in the reference.

:class:`Token` is the reference's delegation and block token, in the
same wire form (``to_wire``: kind, identifier, password, service); its
identifier is a wirepack record the client can read
(``identifier_fields``: owner, renewer, issue and expiry times, master
key id, extra claims such as a block token's block and modes).
:class:`SecretManager` mints and verifies them (HMAC-SHA256 under
rolling master keys), for the port's RPC server: its TOKEN
authentication and the SASL TOKEN mechanism.
"""

from __future__ import annotations

import contextvars
import getpass
import hashlib
import hmac
import os
import secrets
import threading
import time
from typing import Dict, List, Optional

from hadoop_tpu_torch.io.wire import pack, unpack


class AccessControlError(PermissionError):
    pass


_current: contextvars.ContextVar[Optional["UserGroupInformation"]] = \
    contextvars.ContextVar("htpu_torch_current_ugi", default=None)


class UserGroupInformation:
    AUTH_SIMPLE = "SIMPLE"
    AUTH_TOKEN = "TOKEN"
    AUTH_KERBEROS = "KERBEROS"

    _login_user: Optional["UserGroupInformation"] = None
    _lock = threading.Lock()

    def __init__(self, user_name: str, groups: Optional[List[str]] = None,
                 auth_method: str = AUTH_SIMPLE,
                 real_user: Optional["UserGroupInformation"] = None):
        self.user_name = user_name
        self.groups = list(groups or [])
        self.auth_method = auth_method
        self.real_user = real_user
        self.tokens: Dict[str, "Token"] = {}
        self.sasl_password: Optional[bytes] = None  # set by keytab login

    @classmethod
    def get_login_user(cls) -> "UserGroupInformation":
        with cls._lock:
            if cls._login_user is None:
                cls._login_user = cls(getpass.getuser())
            return cls._login_user

    @classmethod
    def create_remote_user(cls, name: str, auth: str = AUTH_SIMPLE
                           ) -> "UserGroupInformation":
        return cls(name, auth_method=auth)

    @classmethod
    def create_proxy_user(cls, name: str, real: "UserGroupInformation"
                          ) -> "UserGroupInformation":
        return cls(name, auth_method=real.auth_method, real_user=real)

    @classmethod
    def login_from_keytab(cls, principal: str, keytab_path: str
                          ) -> "UserGroupInformation":
        """The principal's secret from a keytab (the reference's MiniKdc
        writes them), for the SASL client to prove without sending it.
        The returned user becomes the login user, as in the reference."""
        if not os.path.exists(keytab_path):
            raise AccessControlError(f"keytab not found: {keytab_path}")
        from hadoop_tpu_torch.security.sasl import password_from_keytab
        user = principal.split("/")[0].split("@")[0]
        ugi = cls(user, auth_method=cls.AUTH_KERBEROS)
        ugi.sasl_password = password_from_keytab(keytab_path, principal)
        with cls._lock:
            cls._login_user = ugi
        return ugi

    def do_as(self, fn, *args, **kwargs):
        """Run ``fn`` with this user as the current caller."""
        token = _current.set(self)
        try:
            return fn(*args, **kwargs)
        finally:
            _current.reset(token)

    def add_token(self, token: "Token") -> None:
        self.tokens[token.kind] = token

    def short_name(self) -> str:
        return self.user_name

    def effective_and_real(self) -> Dict[str, Optional[str]]:
        return {
            "user": self.user_name,
            "real": self.real_user.user_name if self.real_user else None,
        }

    def __repr__(self) -> str:
        via = f" via {self.real_user.user_name}" if self.real_user else ""
        return f"{self.user_name}{via} (auth:{self.auth_method})"


def current_user() -> UserGroupInformation:
    ugi = _current.get()
    return ugi if ugi is not None else UserGroupInformation.get_login_user()


class Token:
    """A signed token: identifier + HMAC password from a master key."""

    def __init__(self, kind: str, identifier: bytes, password: bytes,
                 service: str = ""):
        self.kind = kind
        self.identifier = identifier
        self.password = password
        self.service = service

    def to_wire(self) -> Dict:
        return {"k": self.kind, "i": self.identifier, "p": self.password,
                "s": self.service}

    @classmethod
    def from_wire(cls, d: Dict) -> "Token":
        return cls(d["k"], d["i"], d["p"], d.get("s", ""))

    def identifier_fields(self) -> Dict:
        """The identifier's claims: ``owner``, ``renewer``, ``issue``,
        ``expiry``, ``key_id``, ``extra``."""
        return unpack(self.identifier)


class SecretManager:
    """HMAC secret manager with rolling master keys: the last three keys
    stay, so tokens minted before a rotation still verify."""

    def __init__(self, kind: str, key_rotation_s: float = 24 * 3600.0,
                 token_ttl_s: float = 7 * 24 * 3600.0):
        self.kind = kind
        self.key_rotation_s = key_rotation_s
        self.token_ttl_s = token_ttl_s
        self._keys: Dict[int, bytes] = {}      # guarded-by: _lock
        self._key_id = 0                       # guarded-by: _lock
        self._lock = threading.Lock()
        self._roll_key()

    def _roll_key(self) -> None:
        with self._lock:
            self._key_id += 1
            self._keys[self._key_id] = secrets.token_bytes(32)
            for kid in list(self._keys):
                if kid < self._key_id - 2:
                    del self._keys[kid]

    def _sign(self, key: bytes, ident: bytes) -> bytes:
        return hmac.new(key, ident, hashlib.sha256).digest()

    def create_token(self, owner: str, renewer: str = "",
                     extra: Optional[Dict] = None) -> Token:
        with self._lock:
            kid = self._key_id
            key = self._keys.get(kid)
        if key is None:
            raise AccessControlError(
                f"no current master key (id {kid}) to mint {self.kind}")
        ident = pack({
            "owner": owner, "renewer": renewer, "issue": time.time(),
            "expiry": time.time() + self.token_ttl_s, "key_id": kid,
            "extra": extra or {},
        })
        return Token(self.kind, ident, self._sign(key, ident))

    def password_for(self, identifier: bytes) -> bytes:
        """A token's password recomputed from its identifier: the SASL
        TOKEN mechanism's server side, where only the identifier crosses
        the wire."""
        ident = unpack(identifier)
        kid = ident.get("key_id")
        with self._lock:
            key = self._keys.get(kid)
        if key is None:
            raise AccessControlError(f"unknown/expired master key {kid}")
        if ident.get("expiry", 0) < time.time():
            raise AccessControlError("token expired")
        return self._sign(key, identifier)

    def verify_token(self, token: Token) -> Dict:
        """The decoded identifier; ``AccessControlError`` for another
        kind, a bad signature or an expired token."""
        if token.kind != self.kind:
            raise AccessControlError(
                f"token kind {token.kind!r} != expected {self.kind!r}")
        ident = unpack(token.identifier)
        kid = ident.get("key_id")
        with self._lock:
            key = self._keys.get(kid)
        if key is None:
            raise AccessControlError(f"unknown/expired master key {kid}")
        if not hmac.compare_digest(self._sign(key, token.identifier),
                                   token.password):
            raise AccessControlError("token signature mismatch")
        if ident["expiry"] < time.time():
            raise AccessControlError("token expired")
        return ident
