"""RPC client: one multiplexed connection per (address, protocol, user),
calls completed by a receive thread.

The port's copy of ``hadoop_tpu/ipc/client.py``, speaking the reference's
protocol to the reference's ``ipc.Server`` (the service registry, and
any other daemon of the fleet). A connection opens with a header frame
(``MAGIC``, the protocol, the caller's user, the auth method); each call
is a u32-framed wirepack dict (``id``, ``p``, ``m``, ``a``, ``kw``, the
client id ``cid``, the retry count ``rc``, the newest server state id
seen ``sid``, and the caller's trace context ``t`` when a span is
active), and the receive loop matches each response to its call by id.
A fatal frame or an EOF fails every call in flight, so a retry layer can
act.

Conf keys, as the reference's: ``ipc.client.connect.timeout`` (20 s),
``ipc.ping.interval`` (10 s: with calls outstanding and nothing
received, a ping probes a half-open connection),
``ipc.client.connection.maxidletime`` (10 s: a connection with no call
outstanding closes itself), ``ipc.client.read.timeout`` (120 s of
silence with calls outstanding fails them; 0 turns it off) and
``ipc.client.rpc-timeout`` (60 s, a call's default timeout).

Only SIMPLE authentication: ``hadoop.security.authentication=sasl`` is
refused with ``NotImplementedError`` (ROADMAP Queue A 9 part 2, with
the DFS client that needs it), and no delegation token rides the
header.
"""

from __future__ import annotations

import logging
import os
import select
import socket
import struct
import threading
import time
from typing import Any, Dict, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.io.wire import pack, unpack
from hadoop_tpu_torch.ipc.errors import (ConnectFailedError, FatalRpcError,
                                         RpcError, RpcTimeoutError,
                                         resolve_exception)
from hadoop_tpu_torch.security.ugi import UserGroupInformation, current_user
from hadoop_tpu_torch.tracing import current_span

log = logging.getLogger(__name__)

Address = Tuple[str, int]

# the reference server's connection header magic and ping call id
MAGIC = "htpu1"
PING_CALL_ID = -1
MAX_CLIENT_FRAME = 128 * 1024 * 1024


class _ConnClosedBeforeSend(RpcError):
    """The cached connection closed (idle close, a race) before the
    request reached the socket: always safe to retry once."""


class _PendingCall:
    __slots__ = ("event", "response", "error")

    def __init__(self):
        self.event = threading.Event()
        self.response: Optional[Dict] = None
        self.error: Optional[BaseException] = None


class _Connection:
    def __init__(self, client: "Client", addr: Address, protocol: str,
                 user: UserGroupInformation):
        self.client = client
        self.addr = addr
        self.protocol = protocol
        self.user = user
        self.sock: Optional[socket.socket] = None
        self.send_lock = threading.Lock()
        self.calls: Dict[int, _PendingCall] = {}  # guarded-by: calls_lock
        self.calls_lock = threading.Lock()
        self.dead = False
        self.last_state_id = -1
        self._connect()
        threading.Thread(target=self._receive_loop, daemon=True,
                         name=f"rpc-recv-{addr[0]}:{addr[1]}").start()

    def _connect(self) -> None:
        conf = self.client.conf
        if conf.get("hadoop.security.authentication",
                    "simple").lower() == "sasl":
            raise NotImplementedError(
                "SASL RPC authentication is not ported to "
                "hadoop_tpu_torch yet (ROADMAP Queue A 9 part 2)")
        timeout = conf.get_time_seconds("ipc.client.connect.timeout", 20.0)
        self.ping_interval = conf.get_time_seconds("ipc.ping.interval",
                                                   10.0)
        self.max_idle_s = conf.get_time_seconds(
            "ipc.client.connection.maxidletime", 10.0)
        self.read_timeout = conf.get_time_seconds(
            "ipc.client.read.timeout", 120.0)
        try:
            self.sock = socket.create_connection(self.addr, timeout=timeout)
        except OSError as e:
            raise ConnectFailedError(
                f"failed to connect to {self.addr}: {e}") from e
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # receives are select()-gated, so this bounds sends; the receive
        # loop enforces read_timeout itself
        self.sock.settimeout(self.read_timeout or None)
        self.last_activity = time.monotonic()
        self.last_inbound = time.monotonic()
        payload = pack({
            "magic": MAGIC,
            "protocol": self.protocol,
            "user": self.user.user_name,
            "real": self.user.real_user.user_name
            if self.user.real_user else None,
            "auth": self.user.auth_method,
        })
        self.sock.sendall(struct.pack(">I", len(payload)) + payload)

    def _receive_loop(self) -> None:
        buf = bytearray()
        # tick fast enough that a small read timeout is honoured promptly
        tick = self.ping_interval if not self.read_timeout else \
            min(self.ping_interval, max(0.05, self.read_timeout / 4.0))
        while not self.dead:
            try:
                ready, _, _ = select.select([self.sock], [], [], tick)
            except (OSError, ValueError):
                self._fail_all(RpcError(f"connection to {self.addr} closed"))
                return
            if not ready:
                # idle: with calls in flight probe liveness, with none
                # close once past the idle limit. The idle decision marks
                # the connection dead under calls_lock, so a racing
                # send_call either sees it dead (and retries on a fresh
                # connection: nothing was sent) or registers first
                close_idle = False
                with self.calls_lock:
                    outstanding = len(self.calls)
                    if outstanding == 0 and time.monotonic() - \
                            self.last_activity > self.max_idle_s:
                        self.dead = True
                        close_idle = True
                if close_idle:
                    self._fail_all(RpcError(
                        f"connection to {self.addr} idle-closed"))
                    return
                if outstanding:
                    if self.read_timeout and time.monotonic() - \
                            self.last_inbound > self.read_timeout:
                        self._fail_all(RpcTimeoutError(
                            f"no response bytes from {self.addr} in "
                            f"{self.read_timeout:.1f}s with "
                            f"{outstanding} call(s) outstanding "
                            f"(ipc.client.read.timeout)"))
                        return
                    try:
                        self.ping()
                    except OSError:
                        self._fail_all(RpcError(
                            f"connection to {self.addr} failed ping probe"))
                        return
                continue
            try:
                chunk = self.sock.recv(256 * 1024)
            except OSError:
                chunk = b""
            if not chunk:
                self._fail_all(RpcError(f"connection to {self.addr} closed"))
                return
            self.last_activity = time.monotonic()
            self.last_inbound = self.last_activity
            buf += chunk
            while len(buf) >= 4:
                (flen,) = struct.unpack_from(">I", buf, 0)
                if flen > MAX_CLIENT_FRAME:
                    self._fail_all(RpcError(
                        f"oversized response frame ({flen} bytes) from "
                        f"{self.addr}"))
                    return
                if len(buf) - 4 < flen:
                    break
                frame = bytes(buf[4:4 + flen])
                del buf[:4 + flen]
                if not self._handle_frame(frame):
                    return

    def _handle_frame(self, frame: bytes) -> bool:
        """One response frame; False when the connection is torn down."""
        try:
            msg = unpack(frame)
        except Exception as e:  # noqa: BLE001 — any decode failure
            # means the stream is out of step: fail the connection
            self._fail_all(RpcError(f"bad response frame: {e}"))
            return False
        if not isinstance(msg, dict):
            self._fail_all(RpcError(
                f"non-record response frame ({type(msg).__name__})"))
            return False
        sid = msg.get("sid", -1)
        if sid is not None and sid > self.last_state_id:
            self.last_state_id = sid
            if sid > self.client.last_state_id:
                self.client.last_state_id = sid
        if msg.get("fatal"):
            self._fail_all(FatalRpcError(msg.get("em", "fatal rpc error")))
            return False
        with self.calls_lock:
            pend = self.calls.pop(msg.get("id"), None)
        if pend is not None:
            pend.response = msg
            pend.event.set()
        return True

    def _fail_all(self, err: BaseException) -> None:
        self.dead = True
        try:
            if self.sock:
                self.sock.close()
        except OSError:
            pass
        with self.calls_lock:
            pending = list(self.calls.values())
            self.calls.clear()
        for p in pending:
            p.error = err
            p.event.set()
        self.client._drop_connection(self)

    def send_call(self, call_id: int, req: Dict) -> _PendingCall:
        pend = _PendingCall()
        with self.calls_lock:
            if self.dead:
                raise _ConnClosedBeforeSend(
                    f"connection to {self.addr} closed before send")
            self.calls[call_id] = pend
            first_outstanding = len(self.calls) == 1
        try:
            payload = pack(req)
        except Exception:
            # an unencodable argument: an orphan pending call would keep
            # the idle close from ever firing
            with self.calls_lock:
                self.calls.pop(call_id, None)
            raise
        self.last_activity = time.monotonic()
        if first_outstanding:
            # the read timeout measures silence after the first call in
            # flight, not the idle gap before it
            self.last_inbound = self.last_activity
        try:
            with self.send_lock:
                self.sock.sendall(struct.pack(">I", len(payload)) + payload)
        except OSError as e:
            with self.calls_lock:
                self.calls.pop(call_id, None)
            self._fail_all(RpcError(f"send to {self.addr} failed: {e}"))
            raise RpcError(f"send to {self.addr} failed: {e}") from e
        return pend

    def ping(self) -> None:
        payload = pack({"id": PING_CALL_ID})
        with self.send_lock:
            self.sock.sendall(struct.pack(">I", len(payload)) + payload)

    def close(self) -> None:
        self._fail_all(RpcError("client closed"))


class Client:
    """A shared RPC client; thread-safe, one a process is typical."""

    def __init__(self, conf: Optional[ConfLike] = None):
        self.conf = conf or Configuration()
        self.client_id = os.urandom(16)
        self.last_state_id = -1
        self._call_id = 0  # guarded-by: _id_lock
        self._id_lock = threading.Lock()
        self._conns: Dict[Tuple[Address, str, str], _Connection] = {}
        self._conns_lock = threading.Lock()
        self.default_timeout = self.conf.get_time_seconds(
            "ipc.client.rpc-timeout", 60.0)

    def _next_call_id(self) -> int:
        with self._id_lock:
            self._call_id += 1
            return self._call_id

    def _get_connection(self, addr: Address, protocol: str,
                        user: UserGroupInformation) -> _Connection:
        key = (addr, protocol, user.user_name)
        with self._conns_lock:
            conn = self._conns.get(key)
            if conn is not None and not conn.dead:
                return conn
        # connect outside the lock; of racing callers the first to
        # register wins. The loser closes outside the lock: close()
        # re-takes it through _drop_connection
        conn = _Connection(self, addr, protocol, user)
        loser = None
        with self._conns_lock:
            existing = self._conns.get(key)
            if existing is not None and not existing.dead:
                loser, conn = conn, existing
            else:
                self._conns[key] = conn
        if loser is not None:
            loser.close()
        return conn

    def _drop_connection(self, conn: _Connection) -> None:
        key = (conn.addr, conn.protocol, conn.user.user_name)
        with self._conns_lock:
            if self._conns.get(key) is conn:
                del self._conns[key]

    def call(self, addr: Address, protocol: str, method: str,
             args: tuple = (), kwargs: Optional[dict] = None,
             timeout: Optional[float] = None, retry_count: int = 0,
             user: Optional[UserGroupInformation] = None) -> Any:
        """One round trip. Raises the remote exception (as its local
        class when one is registered), ``RpcTimeoutError`` or
        ``RpcError``."""
        user = user or current_user()
        span = current_span()
        for attempt in range(3):
            conn = self._get_connection(addr, protocol, user)
            call_id = self._next_call_id()
            req: Dict[str, Any] = {
                "id": call_id, "p": protocol, "m": method, "a": list(args),
                "cid": self.client_id, "rc": retry_count,
                "sid": max(conn.last_state_id, self.last_state_id),
            }
            if kwargs:
                req["kw"] = kwargs
            if span is not None:
                req["t"] = span.context().to_wire()
            try:
                pend = conn.send_call(call_id, req)
                break
            except _ConnClosedBeforeSend:
                if attempt == 2:
                    raise
        timeout = self.default_timeout if timeout is None else timeout
        if not pend.event.wait(timeout):
            with conn.calls_lock:
                conn.calls.pop(call_id, None)
            raise RpcTimeoutError(
                f"RPC {protocol}.{method} to {addr} timed out after "
                f"{timeout}s")
        if pend.error is not None:
            raise pend.error
        resp = pend.response
        if resp.get("ok"):
            return resp.get("val")
        raise resolve_exception(resp.get("ec", "IOError"), resp.get("em", ""))

    def stop(self) -> None:
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()


_default_client: Optional[Client] = None
_default_client_lock = threading.Lock()


def default_client() -> Client:
    global _default_client
    with _default_client_lock:
        if _default_client is None:
            _default_client = Client()
        return _default_client
