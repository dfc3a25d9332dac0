"""SASL mutual authentication and wire protection, client side.

The client half of ``hadoop_tpu/security/sasl.py``, byte for byte its
handshake, so the port's RPC client and data sockets authenticate to
the reference's ``ipc.Server`` and DataNodes. A SCRAM-style
challenge/response (SHA-256) proves a shared secret that never crosses
the wire, both ways:

- ``SCRAM-HTPU``: the secret is a principal's password from a keytab
  (the reference's ``MiniKdc`` writes them: a wirepack map of short
  principal name to password);
- ``TOKEN``: the secret is a delegation token's password, and only the
  token's identifier is sent; the server recomputes the password.

  C->S  initiate: mech, user or token identifier, client nonce, QoP
  S->C  challenge: server nonce, salt, iterations, granted QoP
  C->S  response: ClientKey XOR HMAC(StoredKey, transcript)
  S->C  success: HMAC(ServerKey, transcript), which the client checks

QoP (``hadoop.rpc.protection``, ``dfs.data.transfer.protection``):
``authentication`` leaves the channel plaintext; ``integrity`` MACs
every frame (HMAC-SHA256, per-direction keys and counters);
``privacy`` encrypts every frame with per-direction AES-256-GCM keys
bound to both nonces. The client never accepts less than it asked for.

``cryptography``'s ``AESGCM`` is imported only where a privacy cipher
is built, so this module imports on a machine without the package; a
privacy QoP there raises an error that says so. The server session
(``SaslServerSession``) and the credential store stay the reference
daemons': the port runs none.
"""

from __future__ import annotations

import hashlib
import hmac
import secrets
import struct
import threading
from typing import Dict, Optional, Tuple

from hadoop_tpu_torch.io.wire import unpack
from hadoop_tpu_torch.security.ugi import AccessControlError, Token

MECH_SCRAM = "SCRAM-HTPU"
MECH_TOKEN = "TOKEN"

QOP_AUTH = "authentication"
QOP_INTEGRITY = "integrity"
QOP_PRIVACY = "privacy"
_QOP_RANK = {QOP_AUTH: 0, QOP_INTEGRITY: 1, QOP_PRIVACY: 2}

_DEFAULT_ITERS = 4096


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def salted_password(password: bytes, salt: bytes, iters: int) -> bytes:
    return hashlib.pbkdf2_hmac("sha256", password, salt, iters)


def scram_verifier(password: bytes, salt: Optional[bytes] = None,
                   iters: int = _DEFAULT_ITERS) -> Dict:
    """The server-side record of a password (salt, iterations, stored
    and server keys), as the reference's."""
    salt = salt or secrets.token_bytes(16)
    sp = salted_password(password, salt, iters)
    client_key = _hmac(sp, b"Client Key")
    return {"salt": salt, "iters": iters,
            "stored_key": hashlib.sha256(client_key).digest(),
            "server_key": _hmac(sp, b"Server Key")}


def _auth_message(user: str, cnonce: bytes, snonce: bytes, salt: bytes,
                  iters: int, qop: str) -> bytes:
    return b"|".join([user.encode(), cnonce, snonce, salt,
                      str(iters).encode(), qop.encode()])


def _derive_wire_keys(client_key: bytes, cnonce: bytes,
                      snonce: bytes) -> Tuple[bytes, bytes]:
    """(client->server key, server->client key), bound to both nonces."""
    base = _hmac(client_key, b"htpu-wire|" + cnonce + snonce)
    return _hmac(base, b"c2s"), _hmac(base, b"s2c")


def _aesgcm():
    try:
        from cryptography.hazmat.primitives.ciphers.aead import AESGCM
    except ImportError as e:
        raise AccessControlError(
            "the privacy QoP needs the 'cryptography' package (AES-GCM), "
            "which is not installed: use the authentication or "
            "integrity QoP, or install it") from e
    return AESGCM


class WireCipher:
    """Per-connection AES-256-GCM frame protection: each record is a
    12-byte counter nonce then ciphertext and tag; the receiver takes
    only the next expected counter, so a record can be neither replayed
    nor reordered."""

    def __init__(self, c2s_key: bytes, s2c_key: bytes, is_client: bool):
        aesgcm = _aesgcm()
        out_key, in_key = (c2s_key, s2c_key) if is_client \
            else (s2c_key, c2s_key)
        self._out = aesgcm(out_key)
        self._in = aesgcm(in_key)
        self._out_ctr = 0
        self._in_ctr = 0
        self._in_lock = threading.Lock()
        self._out_lock = threading.Lock()

    def wrap(self, payload: bytes) -> bytes:
        with self._out_lock:
            nonce = struct.pack(">4xQ", self._out_ctr)
            self._out_ctr += 1
        return nonce + self._out.encrypt(nonce, payload, b"")

    def unwrap(self, record: bytes) -> bytes:
        if len(record) < 12 + 16:
            raise AccessControlError("truncated encrypted frame")
        with self._in_lock:
            expect = struct.pack(">4xQ", self._in_ctr)
            if record[:12] != expect:
                raise AccessControlError(
                    "frame decryption failed: out-of-order nonce "
                    "(replayed or reordered record)")
            try:
                out = self._in.decrypt(record[:12], record[12:], b"")
            except Exception as e:  # noqa: BLE001 — InvalidTag
                raise AccessControlError(
                    f"frame decryption failed: {e}") from e
            self._in_ctr += 1
            return out


class IntegrityWrapper:
    """The integrity QoP: each record is a u64 counter, HMAC-SHA256 of
    counter and payload, then the payload in the clear."""

    MACLEN = 32

    def __init__(self, c2s_key: bytes, s2c_key: bytes, is_client: bool):
        self._out_key, self._in_key = (c2s_key, s2c_key) if is_client \
            else (s2c_key, c2s_key)
        self._out_ctr = 0
        self._in_ctr = 0
        self._out_lock = threading.Lock()
        self._in_lock = threading.Lock()

    def wrap(self, payload: bytes) -> bytes:
        with self._out_lock:
            ctr = struct.pack(">Q", self._out_ctr)
            self._out_ctr += 1
        return ctr + _hmac(self._out_key, ctr + payload) + payload

    def unwrap(self, record: bytes) -> bytes:
        if len(record) < 8 + self.MACLEN:
            raise AccessControlError("truncated integrity frame")
        ctr, mac = record[:8], record[8:8 + self.MACLEN]
        payload = record[8 + self.MACLEN:]
        with self._in_lock:
            expect = struct.pack(">Q", self._in_ctr)
            self._in_ctr += 1
        if ctr != expect or not hmac.compare_digest(
                mac, _hmac(self._in_key, ctr + payload)):
            raise AccessControlError(
                "frame integrity check failed (tampered or replayed)")
        return payload


class CipherSocket:
    """A stream socket whose every ``sendall`` is one protected record
    (u32 length, then the wrapped bytes) and whose ``recv`` and
    ``recv_into`` serve unwrapped bytes, so the data plane's framing
    runs over it unchanged."""

    MAX_RECORD = 256 * 1024 * 1024

    def __init__(self, sock, cipher):
        self._sock = sock
        self._cipher = cipher
        self._rbuf = bytearray()

    def sendall(self, data) -> None:
        record = self._cipher.wrap(bytes(data))
        self._sock.sendall(struct.pack(">I", len(record)) + record)

    def _fill(self) -> bool:
        """Unwrap one record into the buffer; False at a clean EOF."""
        while not self._rbuf:
            hdr = self._read_exact(4)
            if hdr is None:
                return False
            (rlen,) = struct.unpack(">I", hdr)
            if rlen > self.MAX_RECORD:
                raise AccessControlError("oversized encrypted record")
            rec = self._read_exact(rlen)
            if rec is None:
                return False
            self._rbuf += self._cipher.unwrap(rec)
        return True

    def recv(self, n: int) -> bytes:
        if not self._fill():
            return b""
        out = bytes(self._rbuf[:n])
        del self._rbuf[:n]
        return out

    def recv_into(self, view) -> int:
        if not self._fill():
            return 0
        n = min(len(view), len(self._rbuf))
        view[:n] = self._rbuf[:n]
        del self._rbuf[:n]
        return n

    def _read_exact(self, n: int) -> Optional[bytes]:
        chunks = bytearray()
        while len(chunks) < n:
            chunk = self._sock.recv(n - len(chunks))
            if not chunk:
                if not chunks:
                    return None          # clean EOF at a record boundary
                raise ConnectionError(
                    f"connection closed mid-record ({len(chunks)}/{n}B)")
            chunks += chunk
        return bytes(chunks)

    def settimeout(self, t) -> None:
        self._sock.settimeout(t)

    def close(self) -> None:
        self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()


class SaslClientSession:
    """The client half: ``initiate()``, then ``step(challenge)`` gives
    the response, then ``step(success)`` checks the server's proof and
    builds ``cipher`` for an integrity or privacy QoP."""

    def __init__(self, mech: str, user: str = "",
                 password: Optional[bytes] = None,
                 token: Optional[Token] = None, qop: str = QOP_AUTH):
        self.mech = mech
        self.user = user
        if mech == MECH_TOKEN:
            if token is None:
                raise AccessControlError("TOKEN mechanism without a token")
            self.password = token.password
        else:
            if password is None:
                raise AccessControlError(
                    f"no credentials for principal {user!r}")
            self.password = password
        self.token = token
        self.qop = qop
        if qop == QOP_PRIVACY:
            _aesgcm()            # fail before the handshake, not after
        self.cnonce = secrets.token_bytes(16)
        self.cipher = None
        self.complete = False
        self._expect_proof: Optional[bytes] = None
        self._client_key: Optional[bytes] = None
        self._granted_qop = qop

    def initiate(self) -> Dict:
        msg: Dict = {"state": "initiate", "mech": self.mech,
                     "cnonce": self.cnonce, "qop": self.qop}
        if self.mech == MECH_TOKEN:
            # only the identifier crosses the wire
            msg["token_ident"] = self.token.identifier
            msg["token_kind"] = self.token.kind
        else:
            msg["user"] = self.user
        return msg

    def step(self, msg: Dict) -> Optional[Dict]:
        state = msg.get("state")
        if self.complete:
            # a replayed terminal message must not reset the counters
            raise AccessControlError("SASL message after completion")
        if state == "challenge":
            salt, iters = msg["salt"], msg["iters"]
            self._granted_qop = msg.get("qop", QOP_AUTH)
            sp = salted_password(self.password, salt, iters)
            client_key = _hmac(sp, b"Client Key")
            stored_key = hashlib.sha256(client_key).digest()
            user = self.user if self.mech == MECH_SCRAM else \
                self.token.identifier_fields()["owner"]
            auth_msg = _auth_message(user, self.cnonce, msg["snonce"],
                                     salt, iters, self._granted_qop)
            self._client_key = client_key
            self._nonces = (self.cnonce, msg["snonce"])
            self._expect_proof = _hmac(_hmac(sp, b"Server Key"), auth_msg)
            return {"state": "response",
                    "proof": _xor(client_key, _hmac(stored_key, auth_msg))}
        if state == "success":
            if self._expect_proof is None:
                raise AccessControlError(
                    "SASL success before challenge — impostor endpoint")
            if not hmac.compare_digest(msg.get("server_proof", b""),
                                       self._expect_proof):
                raise AccessControlError(
                    "server failed mutual authentication (bad server "
                    "proof) — possible impostor endpoint")
            if _QOP_RANK.get(self._granted_qop, 0) < \
                    _QOP_RANK.get(self.qop, 0):
                raise AccessControlError(
                    f"server granted qop {self._granted_qop!r} below "
                    f"the required {self.qop!r}")
            self.complete = True
            if self._granted_qop in (QOP_PRIVACY, QOP_INTEGRITY):
                c2s, s2c = _derive_wire_keys(self._client_key,
                                             *self._nonces)
                cls = WireCipher if self._granted_qop == QOP_PRIVACY \
                    else IntegrityWrapper
                self.cipher = cls(c2s, s2c, is_client=True)
            return None
        raise AccessControlError(f"unexpected SASL state {state!r}")


def password_from_keytab(path: str, principal: str) -> bytes:
    """The password of ``principal`` (``user[/host][@REALM]``) in a
    keytab (a wirepack map of short principal name to password)."""
    with open(path, "rb") as f:
        entries = unpack(f.read())
    user = principal.split("/")[0].split("@")[0]
    if user not in entries:
        raise AccessControlError(
            f"principal {principal!r} not in keytab {path}")
    return entries[user]
