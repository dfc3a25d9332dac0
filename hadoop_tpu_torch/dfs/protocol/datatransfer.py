"""DataTransferProtocol, the dial side: the bulk-data streaming plane.

The client half of ``hadoop_tpu/dfs/protocol/datatransfer.py``, byte for
byte its frames, so the port's streams talk to the reference's
DataNodes. One long-lived TCP stream per block transfer; frames are
u32-length-prefixed wirepack dicts:

  op request   {"op": "write_block"|"read_block"|..., "b": <block>, ...}
  op response  {"ok": bool, "em": str, "bpc": int}
  data packet  {"seq": int, "off": int, "last": bool, "data": bytes,
                "sums": bytes}   (one big-endian CRC32C per chunk)
  ack          {"seq": int, "statuses": [str, ...]}   (pipeline order)

With ``dfs.encrypt.data.transfer`` the DFS client installs a
:class:`TransferSecurity` as the process's dial default: each data
socket then runs a SASL handshake (user ``dek-<key id>``, the
NameNode's data encryption key as the secret) before its first op
frame and is wrapped for integrity or privacy. The accept side
(``secure_accept``) is the DataNode's.
"""

from __future__ import annotations

import socket
import struct
from typing import Dict, Optional

from hadoop_tpu_torch.io.wire import pack, read_frame, unpack
from hadoop_tpu_torch.tracing import current_context
from hadoop_tpu_torch.util.crc import DataChecksum

OP_WRITE_BLOCK = "write_block"
OP_READ_BLOCK = "read_block"
OP_TRANSFER_BLOCK = "transfer"   # DN→DN re-replication push
# Short-circuit replica-layout request (ref: the REQUEST_SHORT_CIRCUIT_FDS
# op in the reference's DataTransferProtocol; see client/shortcircuit.py)
OP_SHORT_CIRCUIT = "short_circuit"

STATUS_SUCCESS = "ok"
STATUS_ERROR = "error"
STATUS_ERROR_CHECKSUM = "checksum"

# ref: dfs.client-write-packet-size. The reference ships 64 KB packets;
# that sizing amortizes C/JNI per-packet costs. Here every per-packet step
# is interpreted Python, so the bulk plane uses 1 MB packets — same
# separated-checksum wire format (one CRC per 512 B chunk either way),
# 16x fewer per-packet interpreter round trips per hop.
PACKET_SIZE = 1024 * 1024
CHUNK_SIZE = 512                 # ref: dfs.bytes-per-checksum


def checked_bpc(setup: dict) -> int:
    """The replica's bytes-per-checksum from a read setup reply, bounds-
    checked: a corrupt/malicious peer sending bpc<=0 must fail the
    REPLICA (IOError → the reader's failover path), not crash the read
    with a ZeroDivisionError the retry loop doesn't catch."""
    bpc = setup.get("bpc", CHUNK_SIZE)
    if not isinstance(bpc, int) or not 0 < bpc <= (1 << 20):
        raise IOError(f"peer sent invalid bytes-per-checksum {bpc!r}")
    return bpc

# Pipeline stages (ref: BlockConstructionStage)
STAGE_PIPELINE_SETUP_CREATE = "create"
STAGE_PIPELINE_SETUP_APPEND = "append"
STAGE_TRANSFER = "transfer"
STAGE_PIPELINE_RECOVERY = "recovery"


def send_frame(sock: socket.socket, msg: Dict) -> None:
    payload = pack(msg)
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def recv_frame(sock: socket.socket) -> Dict:
    msg = unpack(read_frame(sock))
    if not isinstance(msg, dict):
        raise IOError(f"malformed transfer frame ({type(msg).__name__})")
    return msg


# Process-wide dial-side security default (ref: the reference resolves
# SaslDataTransferClient from the client conf everywhere a data socket
# is dialed). Explicit ``security=`` wins; the DFS client installs the
# default when dfs.encrypt.data.transfer is on so every dial site —
# pipelines, preads, striped IO, balancer, EC reconstruction — is
# covered without threading a handle through each.
_default_security = None


def set_default_security(sec) -> None:
    global _default_security
    _default_security = sec


def default_security():
    return _default_security


def connect(addr, timeout: float = 30.0, security=None,
            buffer_bytes: int = 0):
    sock = socket.create_connection(addr, timeout=timeout)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    # Throughput plane: fat buffers (≥ a few packets in flight per hop);
    # bulk writers can deepen the per-hop pipe with ``buffer_bytes``
    # (dfs.client.write.socket.buffer — sized to
    # packet_size × packets-in-flight on high-BDP paths).
    buf = buffer_bytes if buffer_bytes > 0 else (4 << 20)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, buf)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, buf)
    sec = security if security is not None else _default_security
    if sec is not None:
        return sec.dial(sock)
    return sock


# ------------------------------------------------------- transfer security

class TransferSecurity:
    """Client-dial half: fetch/cache a DEK, SASL-handshake each data
    socket, return the (possibly cipher-wrapped) channel. Ref:
    SaslDataTransferClient.java."""

    def __init__(self, dek_provider, qop: str = "privacy"):
        self._dek_provider = dek_provider
        self.qop = qop
        self._cached: Optional[Dict] = None

    def _dek(self) -> Dict:
        import time as _time
        if self._cached is None or \
                self._cached["expiry"] - _time.time() < 60.0:
            dek = self._dek_provider()
            if not dek:
                # e.g. the NN has dfs.encrypt.data.transfer off while
                # this client has it on — a config mismatch, not a bug
                # in the dial path.
                raise IOError(
                    "client requires data transfer encryption but the "
                    "NameNode issued no data encryption key")
            self._cached = dek
        return self._cached

    def dial(self, sock):
        from hadoop_tpu_torch.security.sasl import (MECH_SCRAM,
                                                    CipherSocket,
                                                    SaslClientSession)
        dek = self._dek()
        sess = SaslClientSession(MECH_SCRAM, user=f"dek-{dek['kid']}",
                                 password=dek["key"], qop=self.qop)
        send_frame(sock, {"sasl": sess.initiate()})
        reply = recv_frame(sock)
        if "sasl" not in reply:
            raise IOError(reply.get("em", "DN did not negotiate SASL"))
        send_frame(sock, {"sasl": sess.step(reply["sasl"])})
        reply = recv_frame(sock)
        if "sasl" not in reply:
            raise IOError(reply.get("em", "SASL handshake refused"))
        sess.step(reply["sasl"])
        return CipherSocket(sock, sess.cipher) if sess.cipher else sock


def read_block_range(addr, block_wire: Dict, offset: int,
                     length: int, security=None, token=None) -> bytes:
    """Read [offset, offset+length) of one replica over OP_READ_BLOCK,
    verifying checksums. The shared client of BlockSender — used by the
    striped reader, the EC reconstruction worker, and the balancer
    (ref: the remote half of BlockReaderFactory.getRemoteBlockReader)."""
    if length <= 0:
        return b""
    sock = connect(addr, timeout=10.0, security=security)
    try:
        req = {"op": OP_READ_BLOCK, "b": block_wire,
               "offset": offset, "length": length, "tok": token}
        ctx = current_context()   # trace rides the op header
        if ctx is not None:
            req["t"] = ctx.to_wire()
        send_frame(sock, req)
        setup = recv_frame(sock)
        if not setup.get("ok"):
            raise IOError(setup.get("em", "read setup failed"))
        checksum = DataChecksum(checked_bpc(setup))
        out = bytearray()
        skip: Optional[int] = None
        while True:
            pkt = recv_frame(sock)
            if pkt.get("last"):
                break
            data = pkt["data"]
            checksum.verify(data, pkt["sums"], base_pos=pkt["off"])
            if skip is None:
                skip = offset - pkt["off"]  # chunk-alignment slack
            take = data[skip:skip + (length - len(out))] if skip else \
                data[:length - len(out)]
            out += take
            skip = 0
        return bytes(out)
    finally:
        sock.close()


class DataEncryptionKeys:
    """Rotating shared secrets for SASL on the data plane.

    Ref: the reference's DataEncryptionKey flow — the NN's
    BlockTokenSecretManager mints encryption keys
    (``dfs.encrypt.data.transfer``), DNs learn them via the NN, clients
    fetch them with getDataEncryptionKey(), and
    SaslDataTransferClient/Server run DIGEST-MD5 with
    ``user = <keyId>``. Same contract here with the SCRAM-analog:
    user ``dek-<kid>``, secret = the key bytes.

    One class serves both roles: the NN generates/rotates; DNs/clients
    ingest wire copies. ``credentials`` is the SaslServerSession
    callable for the accepting DN.
    """

    def __init__(self, ttl_s: float = 10 * 3600.0):
        import threading
        import time as _time
        self._ttl = ttl_s
        self._time = _time
        self._lock = threading.Lock()
        self._keys: Dict[int, Dict] = {}
        self._current_kid = 0
        self._verifiers: Dict[int, Dict] = {}

    def current(self) -> Dict:
        """NN role: the active key, rotating it when 80% expired."""
        import secrets
        now = self._time.time()
        with self._lock:
            cur = self._keys.get(self._current_kid)
            if cur is None or cur["expiry"] - now < 0.2 * self._ttl:
                self._current_kid += 1
                cur = {"kid": self._current_kid,
                       "key": secrets.token_bytes(32),
                       "expiry": now + self._ttl}
                self._keys[self._current_kid] = cur
                for kid in list(self._keys):
                    if self._keys[kid]["expiry"] < now:
                        del self._keys[kid]
                        self._verifiers.pop(kid, None)
            return dict(cur)

    def all_wire(self) -> list:
        self.current()  # ensure at least one live key
        with self._lock:
            return [dict(k) for k in self._keys.values()]

    def update(self, entries: list) -> None:
        """DN role: ingest the NN's key set."""
        with self._lock:
            for e in entries:
                self._keys[e["kid"]] = dict(e)

    def newest(self) -> Dict:
        """Dial-side key for a node that only ingests (DN→DN push)."""
        with self._lock:
            if not self._keys:
                raise IOError("no data encryption keys received yet")
            return dict(self._keys[max(self._keys)])

    def credentials(self, user: str):
        if not user.startswith("dek-"):
            return None
        try:
            kid = int(user[4:])
        except ValueError:
            return None
        from hadoop_tpu_torch.security.sasl import scram_verifier
        with self._lock:
            if kid not in self._verifiers:
                key = self._keys.get(kid)
                if key is None or key["expiry"] < self._time.time():
                    return None
                self._verifiers[kid] = scram_verifier(key["key"])
            return dict(self._verifiers[kid])


def secure_accept(sock, keys: DataEncryptionKeys, required_qop: str):
    """DN-accept half (ref: SaslDataTransferServer.java). Raises
    AccessControlError on a plaintext or unauthenticated peer."""
    from hadoop_tpu_torch.security.sasl import CipherSocket, SaslServerSession
    from hadoop_tpu_torch.security.ugi import AccessControlError
    sess = SaslServerSession(keys.credentials, required_qop=required_qop)
    first = recv_frame(sock)
    if "sasl" not in first:
        send_frame(sock, {"ok": False,
                          "em": "data transfer protection is required"})
        raise AccessControlError("unprotected data-transfer peer rejected")
    send_frame(sock, {"sasl": sess.step(first["sasl"])})
    second = recv_frame(sock)
    send_frame(sock, {"sasl": sess.step(second.get("sasl") or {})})
    return CipherSocket(sock, sess.cipher) if sess.cipher else sock
