"""The port's RPC server (``hadoop_tpu_torch.ipc.server``) against the JAX
package's, on one wire.

Every case runs in three directions: the reference's ``ipc.Client``
calling the port's ``Server``, the port's client calling the port's
server, and the port's client calling the reference's server. Values
and exceptions cross, the caller and a proxy user reach the handler
(an impersonation without its ACL is refused), a trace context becomes
the handler span's parent, SASL authenticates with a keytab's SCRAM
secret and with a delegation token at each QoP (the handler sees the
QoP; a SIMPLE client of a SASL server and a wrong secret are refused),
and a full ``FairCallQueue`` under ``DecayRpcScheduler`` with backoff
answers ``ServerTooBusyError``. The schedulers and the queue take the
reference's decisions on the same sequences.
"""

import queue
import random
import threading
import time

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.ipc import Client as JClient
from hadoop_tpu.ipc import Server as JServer
from hadoop_tpu.ipc import callqueue as jcallqueue
from hadoop_tpu.ipc import current_call as jcurrent_call
from hadoop_tpu.ipc import errors as jerrors
from hadoop_tpu.security import ugi as jugi
from hadoop_tpu.testing.minikdc import MiniKdc
from hadoop_tpu.tracing.tracer import global_tracer as jglobal_tracer
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.ipc import Client, Server, current_call
from hadoop_tpu_torch.ipc import callqueue, errors
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.security import ugi
from hadoop_tpu_torch.tracing import global_tracer

DIRECTIONS = ["ref->port", "port->port", "port->ref"]
TOKEN_KIND = "HTPU_TEST_TOKEN"

PKG = {
    "ref": dict(conf=JConfiguration, server=JServer, client=JClient,
                current_call=jcurrent_call, ugi=jugi, errors=jerrors,
                tracer=jglobal_tracer),
    "port": dict(conf=Configuration, server=Server, client=Client,
                 current_call=current_call, ugi=ugi, errors=errors,
                 tracer=global_tracer),
}


class Echo:
    """Served by either package's server; ``cc`` is that package's
    ``current_call``."""

    def __init__(self, cc, started=None, release=None):
        self._cc = cc
        self._started = started
        self._release = release

    def echo(self, x):
        return x

    def whoami(self):
        ctx = self._cc()
        return {"user": ctx.user.user_name,
                "real": ctx.user.real_user.user_name
                if ctx.user.real_user else None,
                "qop": ctx.sasl_qop}

    def fail(self, kind):
        raise {"value": ValueError, "key": KeyError,
               "perm": PermissionError}[kind](f"deliberate {kind}")

    def hold(self):
        self._started.set()
        self._release.wait(10.0)
        return "held"


def _conf(pkg, kv):
    conf = PKG[pkg]["conf"](load_defaults=False)
    for k, v in kv.items():
        conf.set(k, str(v))
    return conf


def _server(pkg, kv=None, secret_manager=None, name="echo", **kw):
    started, release = threading.Event(), threading.Event()
    srv = PKG[pkg]["server"](_conf(pkg, kv or {}), name=name,
                             secret_manager=secret_manager, **kw)
    srv.register_protocol("Echo", Echo(PKG[pkg]["current_call"], started,
                                       release))
    srv.start()
    srv.started, srv.release = started, release
    return srv


def _client(pkg, kv=None, token_kind=None):
    return PKG[pkg]["client"](_conf(pkg, kv or {}), token_kind=token_kind)


def _ends(direction):
    c, s = direction.split("->")
    return c, s


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_values_and_errors_cross(direction):
    cpkg, spkg = _ends(direction)
    srv = _server(spkg)
    cl = _client(cpkg)
    addr = ("127.0.0.1", srv.port)
    try:
        value = {"n": [1, -2, 2 ** 70, 1.5, None, True], "b": b"\x00\xff",
                 "s": "x" * 40, "nested": {"l": [[1], {"k": b"v"}]}}
        assert cl.call(addr, "Echo", "echo", (value,)) == value
        assert cl.call(addr, "Echo", "echo", (), {"x": [3]}) == [3]
        for kind, cls in (("value", ValueError), ("key", KeyError),
                          ("perm", PermissionError)):
            with pytest.raises(cls, match="deliberate"):
                cl.call(addr, "Echo", "fail", (kind,))
        with pytest.raises(AttributeError, match="no such RPC method"):
            cl.call(addr, "Echo", "nosuch")
        with pytest.raises(AttributeError):
            cl.call(addr, "Echo", "_cc")
        with pytest.raises(ValueError, match="unknown protocol"):
            cl.call(addr, "Nope", "echo", (1,))
        assert cl.call(addr, "Echo", "whoami")["qop"] is None
    finally:
        cl.stop()
        srv.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_caller_and_proxy_user_reach_the_handler(direction):
    cpkg, spkg = _ends(direction)
    srv = _server(spkg, {"hadoop.proxyuser.scheduler.users": "bob",
                         "hadoop.proxyuser.scheduler.hosts": "*"})
    cl = _client(cpkg)
    U = PKG[cpkg]["ugi"].UserGroupInformation
    addr = ("127.0.0.1", srv.port)
    try:
        carol = U.create_remote_user("carol")
        assert cl.call(addr, "Echo", "whoami", user=carol)["user"] == \
            "carol"
        bob = U.create_proxy_user("bob", U.create_remote_user("scheduler"))
        assert cl.call(addr, "Echo", "whoami", user=bob) == \
            {"user": "bob", "real": "scheduler", "qop": None}
        # no ACL lets the scheduler act as eve: a fatal refusal (read off
        # the socket: a SIMPLE client could race its call against it)
        reply = _raw_header(srv.port, {"magic": "htpu1", "auth": "SIMPLE",
                                       "user": "eve", "real": "scheduler"})
        assert reply["fatal"] and "not allowed to impersonate" in \
            reply["em"]
    finally:
        cl.stop()
        srv.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_trace_context_becomes_the_handler_span_parent(direction):
    cpkg, spkg = _ends(direction)
    seen = []
    server_tracer = PKG[spkg]["tracer"]()
    receive = seen.append
    server_tracer.add_receiver(receive)
    srv = _server(spkg)
    cl = _client(cpkg)
    try:
        with PKG[cpkg]["tracer"]().span("caller") as sp:
            assert cl.call(("127.0.0.1", srv.port), "Echo", "echo",
                           (7,)) == 7
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline and not any(
                s.name == "echo.echo" for s in seen):
            time.sleep(0.01)
        (span,) = [s for s in seen if s.name == "echo.echo"]
        assert (span.trace_id, span.parent_id) == (sp.trace_id, sp.span_id)
    finally:
        with server_tracer._lock:      # the reference's has no remover
            server_tracer._receivers.remove(receive)
        cl.stop()
        srv.stop()


@pytest.fixture(scope="module")
def keytab(tmp_path_factory):
    d = tmp_path_factory.mktemp("kdc")
    kdc = MiniKdc(str(d / "kdc"))
    kdc.create_principal("alice", b"alice-pw")
    return kdc.create_keytab(str(d / "server.keytab"))


@pytest.mark.parametrize("qop", ["authentication", "integrity", "privacy"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_sasl_scram_at_each_qop(direction, qop, keytab):
    cpkg, spkg = _ends(direction)
    sasl = {"hadoop.security.authentication": "sasl",
            "hadoop.rpc.protection": qop}
    srv = _server(spkg, dict(sasl, **{
        "hadoop.security.server.keytab": keytab}))
    U = PKG[cpkg]["ugi"].UserGroupInformation
    addr = ("127.0.0.1", srv.port)
    alice = U.create_remote_user("alice")
    alice.sasl_password = b"alice-pw"
    cl = _client(cpkg, sasl)
    try:
        assert cl.call(addr, "Echo", "whoami", user=alice) == \
            {"user": "alice", "real": None, "qop": qop}
        big = bytes(range(256)) * 512
        assert cl.call(addr, "Echo", "echo", (big,), user=alice) == big
        # the frames' counters advance together: many calls, one link
        for i in range(20):
            assert cl.call(addr, "Echo", "echo", (i,), user=alice) == i
    finally:
        cl.stop()
    # a wrong secret fails the handshake, which the client reads before
    # it sends a call
    mallory = U.create_remote_user("alice")
    mallory.sasl_password = b"wrong"
    cl = _client(cpkg, sasl)
    try:
        with pytest.raises(PKG[cpkg]["errors"].FatalRpcError,
                           match="auth failed"):
            cl.call(addr, "Echo", "echo", (1,), user=mallory)
    finally:
        cl.stop()
    # a SIMPLE header gets the fatal reply and the close (read off the
    # socket: a client could race its first call against the close)
    try:
        reply = _raw_header(srv.port, {"magic": "htpu1", "auth": "SIMPLE",
                                       "user": "alice"})
        assert reply["fatal"] and "requires SASL" in reply["em"]
    finally:
        srv.stop()


@pytest.mark.parametrize("server", ["port", "ref"])
def test_a_call_after_a_fatal_close_fails_with_its_reason(server, keytab):
    """ROADMAP C 30: a SIMPLE client's connection to a SASL server gets
    the fatal reply and the close, here before its first call is sent.
    The port's client fails that call with the server's reason, as it
    fails a call the close meets in flight, not as a closed connection
    it retries and then reports closed."""
    srv = _server(server, {"hadoop.security.authentication": "sasl",
                           "hadoop.security.server.keytab": keytab})
    addr = ("127.0.0.1", srv.port)
    cl = _client("port")
    try:
        conn = cl._get_connection(addr, "Echo", ugi.current_user())
        deadline = time.monotonic() + 10.0
        while not conn.dead:
            assert time.monotonic() < deadline, "no fatal close"
            time.sleep(0.01)
        with pytest.raises(errors.FatalRpcError, match="requires SASL"):
            conn.send_call(1, {"id": 1, "p": "Echo", "m": "echo", "a": [1]})
        for _ in range(5):
            with pytest.raises(errors.FatalRpcError, match="requires SASL"):
                cl.call(addr, "Echo", "echo", (1,))
    finally:
        cl.stop()
        srv.stop()


def _raw_header(port, header):
    """Send one connection header; the server's reply frame, after which
    the server has closed its side."""
    import socket
    import struct

    from hadoop_tpu_torch.io.wire import pack, read_frame, unpack
    with socket.create_connection(("127.0.0.1", port), 5.0) as s:
        body = pack(header)
        s.sendall(struct.pack(">I", len(body)) + body)
        reply = unpack(read_frame(s))
        assert s.recv(1) == b""
        return reply


@pytest.mark.parametrize("qop", ["integrity", "privacy"])
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_sasl_delegation_token_at_each_qop(direction, qop):
    cpkg, spkg = _ends(direction)
    sasl = {"hadoop.security.authentication": "sasl",
            "hadoop.rpc.protection": qop}
    sm = PKG[spkg]["ugi"].SecretManager(TOKEN_KIND)
    srv = _server(spkg, sasl, secret_manager=sm)
    cugi = PKG[cpkg]["ugi"]
    addr = ("127.0.0.1", srv.port)
    dave = cugi.UserGroupInformation.create_remote_user("dave")
    dave.add_token(cugi.Token.from_wire(sm.create_token("dave").to_wire()))
    cl = _client(cpkg, sasl, token_kind=TOKEN_KIND)
    try:
        assert cl.call(addr, "Echo", "whoami", user=dave) == \
            {"user": "dave", "real": None, "qop": qop}
    finally:
        cl.stop()
    # a token another manager signed does not authenticate
    forged = cugi.UserGroupInformation.create_remote_user("dave")
    other = PKG[spkg]["ugi"].SecretManager(TOKEN_KIND)
    forged.add_token(cugi.Token.from_wire(
        other.create_token("dave").to_wire()))
    cl = _client(cpkg, sasl, token_kind=TOKEN_KIND)
    try:
        with pytest.raises(PKG[cpkg]["errors"].FatalRpcError,
                           match="auth failed"):
            cl.call(addr, "Echo", "whoami", user=forged)
    finally:
        cl.stop()
        srv.stop()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_simple_mode_token_header(direction):
    """A delegation token in the connection header (TOKEN auth without
    SASL): its owner is the caller, and a claimed other user rides on
    it as a proxy user under the ACL."""
    cpkg, spkg = _ends(direction)
    sm = PKG[spkg]["ugi"].SecretManager(TOKEN_KIND)
    srv = _server(spkg, {"hadoop.proxyuser.dave.users": "erin",
                         "hadoop.proxyuser.dave.hosts": "*"},
                  secret_manager=sm)
    cugi = PKG[cpkg]["ugi"]
    tok = cugi.Token.from_wire(sm.create_token("dave").to_wire())
    cl = _client(cpkg, token_kind=TOKEN_KIND)
    addr = ("127.0.0.1", srv.port)
    try:
        for name, want in (("dave", {"user": "dave", "real": None}),
                           ("erin", {"user": "erin", "real": "dave"})):
            u = cugi.UserGroupInformation.create_remote_user(name)
            u.add_token(tok)
            got = cl.call(addr, "Echo", "whoami", user=u)
            assert {k: got[k] for k in want} == want
    finally:
        cl.stop()
        srv.stop()


def _too_busy(cpkg, e):
    """Whether ``e`` is the server's too-busy answer, as ``cpkg``'s
    client raises it: the reference's client resolves full class names
    only, so the port server's comes back as a ``RemoteError``."""
    if isinstance(e, PKG[cpkg]["errors"].ServerTooBusyError):
        return True
    return isinstance(e, PKG[cpkg]["errors"].RemoteError) and \
        e.class_name.rsplit(".", 1)[-1] == "ServerTooBusyError"


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_full_fair_call_queue_answers_server_too_busy(direction):
    """One handler held, a FairCallQueue of 4 (one slot a level) under
    DecayRpcScheduler with backoff: one caller's calls all land on the
    lowest level (its share is 1), so the second waiting call is
    refused with ServerTooBusyError, and the held calls finish."""
    cpkg, spkg = _ends(direction)
    srv = _server(spkg, {"ipc.callqueue.impl": "fair",
                         "ipc.backoff.enable": "true"},
                  num_handlers=1, queue_capacity=4)
    cl = _client(cpkg)
    addr = ("127.0.0.1", srv.port)
    results, errs = [], []

    def call(method):
        try:
            results.append(cl.call(addr, "Echo", method, (), timeout=20.0))
        except Exception as e:  # noqa: BLE001 — collected
            errs.append(e)

    try:
        cl.call(addr, "Echo", "echo", (0,))        # connection up
        first = threading.Thread(target=call, args=("hold",))
        first.start()
        assert srv.started.wait(10.0)
        waiting = threading.Thread(target=call, args=("whoami",))
        waiting.start()
        deadline = time.monotonic() + 10.0
        while srv._callq.qsize() < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        call("whoami")                    # the level's slot is taken
        srv.release.set()
        first.join(10.0)
        waiting.join(10.0)
        assert len(errs) == 1 and _too_busy(cpkg, errs[0]), errs
        assert "held" in results and len(results) == 2
        snap = srv._callq.scheduler.snapshot()
        assert snap["total"] >= 3
    finally:
        srv.release.set()
        cl.stop()
        srv.stop()


def test_server_metrics_count_calls_and_connections():
    srv = _server("port", name="metered")
    cl = _client("port")
    try:
        for i in range(5):
            cl.call(("127.0.0.1", srv.port), "Echo", "echo", (i,))
        reg = metrics_system().source("rpc.metered")
        # a handler counts its call after it has sent the reply (as the
        # reference's does), so the last count may trail the last reply
        deadline = time.monotonic() + 5.0
        while reg.snapshot()["rpc_processing_calls"] < 5 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        snap = reg.snapshot()
        assert snap["rpc_processing_calls"] >= 5
        assert snap["rpc_open_connections"] == 1
        assert snap["rpc_call_queue_length"] == 0
    finally:
        cl.stop()
        srv.stop()


def test_reuseport_is_refused_naming_the_roadmap():
    """``ipc.server.reuseport``: the port refused it, naming ROADMAP
    Queue A 10 part 2, until that item ported the multi-process server.
    Now it binds with ``SO_REUSEPORT`` as the reference's does: a port
    server and a reference server with the key join a port server's
    port, and calls to that port are answered."""
    key = {"ipc.server.reuseport": "true"}
    first = _server("port", key)
    servers = [first]
    cl = _client("port")
    try:
        for pkg in ("port", "ref"):
            servers.append(_server(pkg, key, bind=("127.0.0.1", first.port)))
            assert servers[-1].port == first.port
        for n in range(8):
            assert cl.call(("127.0.0.1", first.port), "Echo", "echo",
                           (n,)) == n
    finally:
        cl.stop()
        for srv in servers:
            srv.stop()


@pytest.mark.parametrize("server", ["port", "ref"])
def test_bad_magic_is_a_fatal_close(server):
    srv = _server(server)
    try:
        reply = _raw_header(srv.port, {"magic": "nope"})
        assert reply["fatal"] and "bad magic" in reply["em"]
    finally:
        srv.stop()


@pytest.mark.parametrize("levels", [2, 4, 6])
def test_decay_scheduler_levels_equal_the_reference(levels):
    """The same caller sequence takes the same levels (no decay tick:
    a period of an hour)."""
    rng = random.Random(levels)
    seq = [rng.choice("aaaaabbbcd") for _ in range(300)]
    got_s = callqueue.DecayRpcScheduler(levels, _conf(
        "port", {"ipc.decay-scheduler.period": "3600s"}))
    want_s = jcallqueue.DecayRpcScheduler(levels, _conf(
        "ref", {"ipc.decay-scheduler.period": "3600s"}))
    try:
        assert [got_s.priority(c) for c in seq] == \
            [want_s.priority(c) for c in seq]
        assert got_s.snapshot() == want_s.snapshot()
        assert got_s.thresholds == want_s.thresholds
    finally:
        got_s.stop()
        want_s.stop()


@pytest.mark.parametrize("levels,capacity", [(2, 8), (4, 16), (3, 5)])
def test_fair_call_queue_takes_in_the_references_order(levels, capacity):
    rng = random.Random(capacity)
    puts = [(i, rng.randrange(levels)) for i in range(capacity * 2)]
    orders = []
    for q in (callqueue.FairCallQueue(levels, capacity),
              jcallqueue.FairCallQueue(levels, capacity)):
        full, order = [], []
        for item, prio in puts:
            try:
                q.put_nowait(item, prio)
            except queue.Full:
                full.append(item)
        while q.qsize():
            order.append(q.get(timeout=1.0))
        orders.append((full, order))
    assert orders[0] == orders[1]


@pytest.mark.parametrize("impl,sched,backoff", [
    ("fifo", None, "false"), ("fair", None, "true"),
    ("fifo", "decay", "true"), ("fair", "default", "false")])
def test_call_queue_manager_builds_the_references_pair(impl, sched, backoff):
    kv = {"ipc.callqueue.impl": impl, "ipc.backoff.enable": backoff}
    if sched:
        kv["ipc.scheduler.impl"] = sched
    got = callqueue.CallQueueManager(_conf("port", kv), 8)
    want = jcallqueue.CallQueueManager(_conf("ref", kv), 8)
    try:
        assert type(got.queue).__name__ == type(want.queue).__name__
        assert type(got.scheduler).__name__ == \
            type(want.scheduler).__name__
        assert got.backoff_enable == want.backoff_enable
    finally:
        got.stop()
        want.stop()
