"""The RPC server: a threaded reactor that hosts protocol objects.

The port's copy of ``hadoop_tpu/ipc/server.py``, speaking the same wire
as the port's and the reference's clients:

    listener (accept) -> readers (selectors, frame split)
      -> CallQueueManager (QoS, backoff) -> handlers (doAs + dispatch)
        -> responder (inline write, selector for the rest)
    connection manager (closes idle connections)

Frames are u32-length-prefixed wirepack records. A connection's first
frame is its header (``magic`` "htpu1", ``auth``, ``user``, ``real``,
``token`` or ``sasl``); each later one a call (``id``, ``p`` protocol,
``m`` method, ``a``/``kw`` arguments, ``cid``, ``rc`` retry count, ``sid``
the client's state id, ``t`` the caller's trace context). A reply is
``{"id", "ok", "val" | "ec", "em", "retryable", "sid"}``; a fatal reply
(bad magic, refused authentication) has ``id`` -2 and ``fatal`` and
closes the connection after it.

Authentication, as the reference's:

- SIMPLE trusts the claimed user; a ``real`` user different from it is
  impersonation and must pass :class:`~hadoop_tpu_torch.security.
  proxyusers.ProxyUsers` (``hadoop.proxyuser.<real>.*``);
- TOKEN verifies the header's delegation token against the server's
  ``SecretManager``;
- SASL runs the SCRAM handshake of ``security/sasl.py`` (two round trips
  in frames of id -3; the principals from
  ``hadoop.security.server.keytab``, tokens from the ``SecretManager``)
  and, at ``hadoop.rpc.protection`` integrity or privacy, wraps every
  later frame both ways;
- ``hadoop.security.authentication=sasl`` refuses SIMPLE and TOKEN
  headers with a fatal reply.

A handler sees its caller through :func:`current_call` (user, ids,
address, the connection's QoP) and runs as the caller
(``UserGroupInformation.do_as``). A call that carries a trace context
runs inside a ``<server name>.<method>`` span under it. Metrics go to
source ``rpc.<name>`` of the port's metrics system: calls, queue and
processing time, the processing-time histogram (with the caller's trace
as exemplar), authentication failures, open connections, the call
queue's length.

An error crosses the wire as its class's dotted name and message: a
builtin by its bare name, the port's own exceptions by their port names
(the port's client also resolves the reference's framework errors by
their last component; the reference's client, which resolves full names
only, gets a ``RemoteError`` that carries the port's class name).

``ipc.server.reuseport`` binds the listener with ``SO_REUSEPORT``, so
several processes serve one port (``ipc/mpserver.py``, the reference's
multi-process handler mode).
"""

from __future__ import annotations

import contextvars
import errno
import logging
import queue as _queue
import selectors
import socket
import struct
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.io.wire import MAX_FRAME, WireError, pack, unpack
from hadoop_tpu_torch.ipc.callqueue import CallQueueManager
from hadoop_tpu_torch.ipc.client import MAGIC, PING_CALL_ID
from hadoop_tpu_torch.ipc.errors import (FatalRpcError, ServerTooBusyError,
                                         wire_name)
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.security.proxyusers import ProxyUsers
from hadoop_tpu_torch.security.ugi import (AccessControlError, SecretManager,
                                           Token, UserGroupInformation)
from hadoop_tpu_torch.tracing import SpanContext, global_tracer
from hadoop_tpu_torch.util.misc import Daemon, backoff_delay

log = logging.getLogger(__name__)

SASL_CALL_ID = -3
FATAL_CALL_ID = -2
MAX_IDLE_KEY = "ipc.server.connection.maxidletime"
REUSE_PORT_KEY = "ipc.server.reuseport"
_FATAL_NAME = f"{FatalRpcError.__module__}.{FatalRpcError.__qualname__}"


class _NoopSpanCm:
    """The null context of an untraced call (no allocation)."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpanCm()


class CallContext:
    """What a handler knows of its call (:func:`current_call`): the
    caller, the client and call ids, the retry count, the peer address,
    the protocol and method, the client's state id, the priority the
    scheduler gave, and the QoP the connection negotiated (None without
    SASL)."""

    def __init__(self, user: UserGroupInformation, client_id: bytes,
                 call_id: int, retry_count: int, address: str,
                 protocol: str, method: str, client_state_id: int,
                 sasl_qop: Optional[str] = None):
        self.user = user
        self.client_id = client_id
        self.call_id = call_id
        self.retry_count = retry_count
        self.address = address
        self.protocol = protocol
        self.method = method
        self.client_state_id = client_state_id
        self.priority = 0
        self.sasl_qop = sasl_qop


_current_call: contextvars.ContextVar[Optional[CallContext]] = \
    contextvars.ContextVar("htpu_torch_current_call", default=None)


def current_call() -> Optional[CallContext]:
    return _current_call.get()


class _Connection:
    def __init__(self, sock: socket.socket, addr: Tuple[str, int]):
        self.sock = sock
        self.addr = addr
        self.inbuf = bytearray()
        self.header: Optional[Dict] = None
        self.user: Optional[UserGroupInformation] = None
        self.sasl = None            # the SaslServerSession in progress
        self.pending_header: Optional[Dict] = None
        self.cipher = None          # the wrapper once integrity/privacy
        self.out_pending: deque = deque()
        self.out_lock = threading.Lock()
        self.closed = False
        self.last_activity = time.monotonic()

    def caller_key(self) -> str:
        return self.user.user_name if self.user else self.addr[0]


class _Call:
    __slots__ = ("conn", "req", "recv_time", "priority")

    def __init__(self, conn: _Connection, req: Dict):
        self.conn = conn
        self.req = req
        self.recv_time = time.monotonic()
        self.priority = 0


class Server:
    """An RPC server hosting one or more protocol implementations."""

    def __init__(self, conf: Optional[ConfLike] = None,
                 bind: Tuple[str, int] = ("127.0.0.1", 0),
                 num_handlers: int = 4, num_readers: int = 1,
                 queue_capacity: int = 1024, name: str = "rpc",
                 secret_manager: Optional[SecretManager] = None,
                 state_provider: Optional[Callable[[], int]] = None,
                 queue_prefix: str = "ipc"):
        self.conf = conf or Configuration(load_defaults=False)
        self.reuse_port = self.conf.get_bool(REUSE_PORT_KEY, False)
        self.name = name
        self.num_handlers = num_handlers
        self.num_readers = max(1, num_readers)
        self.secret_manager = secret_manager
        self.state_provider = state_provider
        self.auth_mode = self.conf.get(
            "hadoop.security.authentication", "simple").lower()
        self.required_qop = self.conf.get(
            "hadoop.rpc.protection", "authentication").lower()
        self.proxy_users = ProxyUsers(self.conf)
        self._credentials = None
        keytab = self.conf.get("hadoop.security.server.keytab", None)
        if keytab:
            from hadoop_tpu_torch.security.sasl import CredentialStore
            self._credentials = CredentialStore().load_keytab(keytab)
        self._protocols: Dict[str, Any] = {}
        self._pre_calls: Dict[str, Callable] = {}
        self._callq = CallQueueManager(self.conf, queue_capacity,
                                       queue_prefix)
        self._lsock: Optional[socket.socket] = None
        self.port = 0
        self._running = False
        self._stopped = threading.Event()
        self._threads: List[threading.Thread] = []
        self._readers: List["_Reader"] = []
        self._responder: Optional["_Responder"] = None
        self._conns: Dict[int, _Connection] = {}  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()
        # longer than the client's own idle close, so the client closes
        self.max_idle_s = self.conf.get_time_seconds(MAX_IDLE_KEY, 120.0)
        reg = metrics_system().source(f"rpc.{name}")
        self._m_calls = reg.counter("rpc_processing_calls")
        self._m_queue_time = reg.rate("rpc_queue_time")
        self._m_processing = reg.rate("rpc_processing_time")
        self._m_processing_hist = reg.histogram(
            "rpc_processing_seconds", "RPC handler wall time")
        self._m_auth_failures = reg.counter("rpc_authentication_failures")
        self._m_open_conns = reg.gauge("rpc_open_connections")
        reg.register_callback_gauge("rpc_call_queue_length",
                                    self._callq.qsize)
        self._tracer = global_tracer()
        self._bind_addr = bind

    # ----------------------------------------------------------------- admin

    def register_protocol(self, protocol_name: str, impl: Any,
                          pre_call: Optional[Callable] = None) -> None:
        """Serve ``impl``'s public methods as ``protocol_name``;
        ``pre_call(method, ctx)`` runs before each dispatch."""
        self._protocols[protocol_name] = impl
        if pre_call is not None:
            self._pre_calls[protocol_name] = pre_call

    @property
    def address(self) -> Tuple[str, int]:
        return (self._bind_addr[0], self.port)

    def start(self) -> None:
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if self.reuse_port:
            # the kernel hashes connections across every process bound
            # to this port (ipc/mpserver.py)
            self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
        # a restart on a fixed port can meet the last incarnation's
        # lingering sockets: retry the bind briefly
        deadline = time.monotonic() + 10.0
        attempt = 0
        while True:
            try:
                self._lsock.bind(self._bind_addr)
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE or \
                        time.monotonic() > deadline:
                    raise
                time.sleep(backoff_delay(0.1, attempt, max_s=1.0))
                attempt += 1
        self._lsock.listen(256)
        # close() does not wake a blocked accept: poll _running instead
        self._lsock.settimeout(0.5)
        self.port = self._lsock.getsockname()[1]
        self._running = True
        self._stopped.clear()
        self._responder = _Responder(self)
        self._threads.append(Daemon(self._responder.run,
                                    f"{self.name}-responder"))
        for i in range(self.num_readers):
            r = _Reader(self, i)
            self._readers.append(r)
            self._threads.append(Daemon(r.run, f"{self.name}-reader-{i}"))
        self._threads.append(Daemon(self._listen_loop,
                                    f"{self.name}-listener"))
        for i in range(self.num_handlers):
            self._threads.append(Daemon(self._handler_loop,
                                        f"{self.name}-handler-{i}"))
        self._threads.append(Daemon(self._idle_scan_loop,
                                    f"{self.name}-connmgr"))
        for t in self._threads:
            t.start()
        log.info("RPC server %s listening on %s:%d (%d handlers, "
                 "%d readers)", self.name, self._bind_addr[0], self.port,
                 self.num_handlers, self.num_readers)

    def stop(self) -> None:
        self._running = False
        self._stopped.set()
        if self._lsock:
            try:
                self._lsock.close()
            except OSError:
                pass
        # sweep again: the listener may register a connection it just
        # accepted while this runs
        for _ in range(20):
            with self._conns_lock:
                conns = list(self._conns.values())
            if not conns:
                break
            for c in conns:
                self._close_conn(c)
            time.sleep(0.01)
        for r in self._readers:
            r.wake()
        if self._responder:
            self._responder.wake()
        self._callq.stop()

    # -------------------------------------------------------------- listener

    def _listen_loop(self) -> None:
        """Accept, and hand each socket to a reader in turn."""
        i = 0
        while self._running:
            try:
                sock, addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Connection(sock, addr)
            with self._conns_lock:
                self._conns[id(conn)] = conn
            self._m_open_conns.incr()   # before a raced close's decr
            if not self._running:       # stop() raced the accept
                self._close_conn(conn)
                continue
            self._readers[i % len(self._readers)].add_connection(conn)
            i += 1

    # ---------------------------------------------------------------- frames

    def _on_frame(self, conn: _Connection, frame: bytes) -> None:
        conn.last_activity = time.monotonic()
        if conn.cipher is not None:
            try:
                frame = conn.cipher.unwrap(frame)
            except AccessControlError as e:
                log.warning("Undecryptable frame from %s: %s", conn.addr, e)
                self._close_conn(conn)
                return
        try:
            msg = unpack(frame)
        except WireError as e:
            log.warning("Bad frame from %s: %s", conn.addr, e)
            self._close_conn(conn)
            return
        if not isinstance(msg, dict):
            log.warning("Non-record frame (%s) from %s",
                        type(msg).__name__, conn.addr)
            self._close_conn(conn)
            return
        if conn.sasl is not None and not conn.sasl.complete:
            self._sasl_continue(conn, msg)
            return
        if conn.header is None:
            self._process_header(conn, msg)
            return
        if msg.get("id") == PING_CALL_ID:
            return
        call = _Call(conn, msg)
        try:
            self._callq.put(call, conn.caller_key())
        except ServerTooBusyError as e:
            self._send_error(conn, msg.get("id", 0), e, retryable=True)

    def _process_header(self, conn: _Connection, hdr: Dict) -> None:
        """The connection header: the magic, then authentication."""
        if hdr.get("magic") != MAGIC:
            self._send_fatal(conn, f"bad magic {hdr.get('magic')!r}")
            return
        auth = hdr.get("auth", UserGroupInformation.AUTH_SIMPLE)
        if auth == "SASL":
            self._sasl_initiate(conn, hdr)
            return
        if self.auth_mode == "sasl":
            self._m_auth_failures.incr()
            self._send_fatal(
                conn, "SIMPLE authentication is not enabled; this server "
                "requires SASL")
            return
        try:
            if auth == UserGroupInformation.AUTH_TOKEN:
                if self.secret_manager is None:
                    raise AccessControlError(
                        "server does not accept tokens")
                raw_token = hdr.get("token")
                if not isinstance(raw_token, dict):
                    raise AccessControlError("TOKEN auth without a token")
                token = Token.from_wire(raw_token)
                owner = self.secret_manager.verify_token(token)["owner"]
                # the token proves the real identity; a different
                # claimed user rides on it as a proxy user
                real_ugi = UserGroupInformation.create_remote_user(
                    owner, auth=UserGroupInformation.AUTH_TOKEN)
                effective = hdr.get("user") or owner
                if effective != owner:
                    user = UserGroupInformation.create_proxy_user(
                        effective, real_ugi)
                    self.proxy_users.authorize(user, conn.addr[0])
                else:
                    user = real_ugi
            else:
                user = UserGroupInformation.create_remote_user(
                    hdr.get("user") or "anonymous")
                real = hdr.get("real")
                if real and real != user.user_name:
                    real_ugi = UserGroupInformation.create_remote_user(real)
                    user = UserGroupInformation.create_proxy_user(
                        user.user_name, real_ugi)
                    self.proxy_users.authorize(user, conn.addr[0])
        except (AccessControlError, KeyError, TypeError) as e:
            self._m_auth_failures.incr()
            self._send_fatal(conn, f"auth failed: {e}")
            return
        conn.header = hdr
        conn.user = user

    # ------------------------------------------------------------------ sasl

    def _sasl_initiate(self, conn: _Connection, hdr: Dict) -> None:
        """The first SASL leg rides in the connection header."""
        from hadoop_tpu_torch.security.sasl import SaslServerSession
        init = hdr.get("sasl")
        if not isinstance(init, dict):
            self._m_auth_failures.incr()
            self._send_fatal(conn, "SASL auth without an initiate message")
            return
        sess = SaslServerSession(self._credentials, self.secret_manager,
                                 required_qop=self.required_qop)
        try:
            challenge = sess.step(init)
        except AccessControlError as e:
            self._m_auth_failures.incr()
            self._send_fatal(conn, f"auth failed: {e}")
            return
        conn.sasl = sess
        conn.pending_header = hdr
        self._responder.respond(conn, pack({"id": SASL_CALL_ID,
                                            "sasl": challenge}))

    def _sasl_continue(self, conn: _Connection, msg: Dict) -> None:
        """The client's proof; the server's proof back; the connection
        is live."""
        try:
            reply = conn.sasl.step(msg.get("sasl") or {})
        except AccessControlError as e:
            self._m_auth_failures.incr()
            self._send_fatal(conn, f"auth failed: {e}")
            return
        hdr = conn.pending_header or {}
        authed = conn.sasl.user
        real_ugi = UserGroupInformation.create_remote_user(
            authed, auth=UserGroupInformation.AUTH_KERBEROS
            if conn.sasl.token_ident is None
            else UserGroupInformation.AUTH_TOKEN)
        effective = hdr.get("user") or authed
        if effective != authed:
            # impersonation on top of the proven identity passes the ACL
            proxy = UserGroupInformation.create_proxy_user(effective,
                                                           real_ugi)
            try:
                self.proxy_users.authorize(proxy, conn.addr[0])
            except AccessControlError as e:
                self._m_auth_failures.incr()
                self._send_fatal(conn, f"auth failed: {e}")
                return
            conn.user = proxy
        else:
            conn.user = real_ugi
        conn.header = hdr
        # the success frame goes out in the clear (the client builds its
        # wrapper from it); every frame after it is wrapped
        self._responder.respond(conn, pack({"id": SASL_CALL_ID,
                                            "sasl": reply}))
        conn.cipher = conn.sasl.cipher

    # -------------------------------------------------------------- handlers

    def _handler_loop(self) -> None:
        while self._running:
            try:
                call = self._callq.take(timeout=0.2)
            except _queue.Empty:
                continue
            self._handle_one(call)

    def _handle_one(self, call: _Call) -> None:
        conn, req = call.conn, call.req
        self._m_queue_time.add(time.monotonic() - call.recv_time)
        call_id = req.get("id", 0)
        method = req.get("m", "")
        protocol = req.get("p", "")
        ctx = CallContext(
            user=conn.user, client_id=req.get("cid", b""), call_id=call_id,
            retry_count=req.get("rc", 0),
            address=f"{conn.addr[0]}:{conn.addr[1]}",
            protocol=protocol, method=method,
            client_state_id=req.get("sid", -1),
            sasl_qop=(conn.sasl.qop if conn.sasl is not None
                      and conn.sasl.complete else None))
        ctx.priority = call.priority
        span_ctx = SpanContext.from_wire(req.get("t"))
        t0 = time.monotonic()
        token = _current_call.set(ctx)
        try:
            # a call without the caller's trace context makes no span
            with (self._tracer.span(f"{self.name}.{method}",
                                    parent=span_ctx)
                  if span_ctx is not None else _NOOP_SPAN) as sp:
                if sp is not None:
                    sp.add_kv("caller", conn.caller_key())
                impl = self._protocols.get(protocol)
                if impl is None:
                    raise ValueError(f"unknown protocol {protocol!r}")
                fn = getattr(impl, method, None)
                if fn is None or method.startswith("_") or \
                        not callable(fn):
                    raise AttributeError(
                        f"no such RPC method {protocol}.{method}")
                pre = self._pre_calls.get(protocol)
                if pre is not None:
                    pre(method, ctx)
                value = conn.user.do_as(fn, *req.get("a", ()),
                                        **req.get("kw", {}))
            self._send_value(conn, call_id, value)
        except Exception as e:  # noqa: BLE001 — every handler error
            # crosses the wire
            if not isinstance(e, AccessControlError):
                log.debug("RPC handler error %s.%s: %s", protocol, method,
                          e)
            self._send_error(conn, call_id, e)
        finally:
            _current_call.reset(token)
            elapsed = time.monotonic() - t0
            self._m_processing.add(elapsed)
            self._m_processing_hist.add(
                elapsed,
                exemplar_trace=span_ctx.trace_id
                if span_ctx is not None and span_ctx.sampled else None)
            self._m_calls.incr()
            self._callq.add_response_time(conn.caller_key(),
                                          call.priority, elapsed)

    # ------------------------------------------------------------- responses

    def _state_id(self) -> int:
        if self.state_provider is None:
            return -1
        try:
            return self.state_provider()
        except Exception:  # noqa: BLE001 — a failing provider reads -1
            return -1

    def _send_value(self, conn: _Connection, call_id: int,
                    value: Any) -> None:
        try:
            payload = pack({"id": call_id, "ok": True, "val": value,
                            "sid": self._state_id()})
        except WireError as e:
            self._send_error(conn, call_id, e)
            return
        self._responder.respond(conn, payload)

    def _send_error(self, conn: _Connection, call_id: int,
                    e: BaseException, retryable: bool = False) -> None:
        payload = pack({"id": call_id, "ok": False, "ec": wire_name(e),
                        "em": str(e), "retryable": retryable,
                        "sid": self._state_id()})
        self._responder.respond(conn, payload)

    def _send_fatal(self, conn: _Connection, msg: str) -> None:
        payload = pack({"id": FATAL_CALL_ID, "ok": False, "fatal": True,
                        "ec": _FATAL_NAME, "em": msg})
        self._responder.respond(conn, payload, close_after=True)

    # ------------------------------------------------------------ connection

    def _close_conn(self, conn: _Connection) -> None:
        if conn.closed:
            return
        conn.closed = True
        with self._conns_lock:
            self._conns.pop(id(conn), None)
        self._m_open_conns.decr()
        # the responder may hold the socket for a partial write: it
        # forgets it in its own thread
        if self._responder is not None:
            self._responder.forget(conn)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _idle_scan_loop(self) -> None:
        while self._running:
            if self._stopped.wait(min(10.0, self.max_idle_s / 2)):
                return
            cutoff = time.monotonic() - self.max_idle_s
            with self._conns_lock:
                idle = [c for c in self._conns.values()
                        if c.last_activity < cutoff and not c.out_pending]
            for c in idle:
                log.debug("Closing idle connection %s", c.addr)
                self._close_conn(c)


class _Reader:
    """A selector thread: reads bytes and splits them into frames."""

    def __init__(self, server: Server, idx: int):
        self.server = server
        self.sel = selectors.DefaultSelector()
        self._pending: deque = deque()
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self.sel.register(self._waker_r, selectors.EVENT_READ, None)

    def add_connection(self, conn: _Connection) -> None:
        self._pending.append(conn)
        self.wake()

    def wake(self) -> None:
        try:
            self._waker_w.send(b"x")
        except OSError:
            pass

    def run(self) -> None:
        srv = self.server
        while srv._running:
            while self._pending:
                conn = self._pending.popleft()
                try:
                    self.sel.register(conn.sock, selectors.EVENT_READ, conn)
                except (KeyError, ValueError, OSError):
                    srv._close_conn(conn)
            for key, _ in self.sel.select(timeout=0.5):
                if key.data is None:
                    try:
                        self._waker_r.recv(4096)
                    except OSError:
                        pass
                    continue
                conn: _Connection = key.data
                try:
                    data = conn.sock.recv(256 * 1024)
                except (BlockingIOError, InterruptedError):
                    continue
                except OSError:
                    data = b""
                if not data:
                    self._drop(conn)
                    continue
                conn.inbuf += data
                self._drain_frames(conn)
        self.sel.close()

    def _drain_frames(self, conn: _Connection) -> None:
        buf = conn.inbuf
        off = 0
        n = len(buf)
        while n - off >= 4:
            (flen,) = struct.unpack_from(">I", buf, off)
            if flen > MAX_FRAME:
                log.warning("Oversized frame (%d) from %s", flen, conn.addr)
                self._drop(conn)
                return
            if n - off - 4 < flen:
                break
            frame = bytes(buf[off + 4: off + 4 + flen])
            off += 4 + flen
            try:
                self.server._on_frame(conn, frame)
            except Exception:  # noqa: BLE001 — one bad client must not
                # end the reader
                log.exception("Dropping connection %s after frame error",
                              conn.addr)
                self.server._close_conn(conn)
            if conn.closed:
                self._drop(conn, already_closed=True)
                return
        if off:
            del buf[:off]

    def _drop(self, conn: _Connection, already_closed: bool = False) -> None:
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError):
            pass
        if not already_closed:
            self.server._close_conn(conn)


class _Responder:
    """Write-back: a handler writes inline when it can, this thread's
    selector writes the rest."""

    def __init__(self, server: Server):
        self.server = server
        self.sel = selectors.DefaultSelector()
        self._waker_r, self._waker_w = socket.socketpair()
        self._waker_r.setblocking(False)
        self.sel.register(self._waker_r, selectors.EVENT_READ, None)
        self._to_register: deque = deque()
        self._close_after: set = set()
        self._to_forget: deque = deque()

    def respond(self, conn: _Connection, payload: bytes,
                close_after: bool = False) -> None:
        if conn.closed:
            return
        with conn.out_lock:
            # wrap under the lock that orders the sends: the wrappers'
            # counters are sequential
            if conn.cipher is not None:
                payload = conn.cipher.wrap(payload)
            data = struct.pack(">I", len(payload)) + payload
            if not conn.out_pending:
                sent = 0
                try:
                    sent = conn.sock.send(data)
                except (BlockingIOError, InterruptedError):
                    sent = 0
                except OSError:
                    self.server._close_conn(conn)
                    return
                if sent == len(data):
                    if close_after:
                        self._graceful_close(conn)
                    return
                data = data[sent:]
            conn.out_pending.append(data)
        if close_after:
            self._close_after.add(id(conn))
        self._to_register.append(conn)
        self.wake()

    def wake(self) -> None:
        try:
            self._waker_w.send(b"x")
        except OSError:
            pass

    def forget(self, conn: _Connection) -> None:
        """From any thread: drop the selector registration in this
        thread (selectors are not thread-safe)."""
        self._to_forget.append(conn)
        self.wake()

    def run(self) -> None:
        srv = self.server
        while srv._running:
            while self._to_forget:
                conn = self._to_forget.popleft()
                self._close_after.discard(id(conn))
                try:
                    self.sel.unregister(conn.sock)
                except (KeyError, ValueError, OSError):
                    pass
            while self._to_register:
                conn = self._to_register.popleft()
                if conn.closed:
                    self._close_after.discard(id(conn))
                    continue
                try:
                    self.sel.register(conn.sock, selectors.EVENT_WRITE,
                                      conn)
                except KeyError:
                    pass            # already registered
                except (ValueError, OSError):
                    srv._close_conn(conn)
            for key, _ in self.sel.select(timeout=0.5):
                if key.data is None:
                    try:
                        self._waker_r.recv(4096)
                    except OSError:
                        pass
                    continue
                self._flush(key.data)
        self.sel.close()

    def _flush(self, conn: _Connection) -> None:
        done = False
        with conn.out_lock:
            while conn.out_pending:
                data = conn.out_pending[0]
                try:
                    sent = conn.sock.send(data)
                except (BlockingIOError, InterruptedError):
                    break
                except OSError:
                    done = True
                    break
                if sent < len(data):
                    conn.out_pending[0] = data[sent:]
                    break
                conn.out_pending.popleft()
            drained = not conn.out_pending
        if drained or done:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
        if done:
            self._close_after.discard(id(conn))
            self.server._close_conn(conn)
        elif drained and id(conn) in self._close_after:
            self._close_after.discard(id(conn))
            self._graceful_close(conn)

    def _graceful_close(self, conn: _Connection) -> None:
        """Half-close after a fatal frame, so the peer reads it before
        the EOF; the reader's EOF or the idle scan closes the rest."""
        try:
            conn.sock.shutdown(socket.SHUT_WR)
        except OSError:
            self.server._close_conn(conn)
