"""The port's RPC client against the JAX package's ``ipc.Server``.

``get_proxy`` of ``hadoop_tpu_torch.ipc`` calls a small protocol served by
the reference's server: values cross both ways, a remote exception comes
back as its registered class, a builtin or ``RemoteError``, a call times
out, calls share one connection, the caller's user and trace context
reach the handler, and a SASL client authenticates. Idempotent retry is held
on a client that fails on cue.
"""

import socket
import threading
import time

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.ipc import Server
from hadoop_tpu.ipc import current_call
from hadoop_tpu.testing.minikdc import MiniKdc
from hadoop_tpu.tracing.tracer import global_tracer as jglobal_tracer
from hadoop_tpu.util.misc import backoff_delay as jbackoff_delay
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.ipc import (Client, RemoteError, RpcTimeoutError,
                                  get_proxy, idempotent, wait_for_proxy)
from hadoop_tpu_torch.ipc import errors, rpc
from hadoop_tpu_torch.security.ugi import UserGroupInformation
from hadoop_tpu_torch.tracing import global_tracer


class RefError(IOError):
    """Raised by the server; registered in the port under its wire name."""


class PortError(IOError):
    pass


errors.register_exception(PortError, f"{__name__}.RefError")


class Unmapped(Exception):
    pass


class EchoProtocol:
    @idempotent
    def echo(self, x):
        return x

    def whoami(self):
        ctx = current_call()
        return {"user": ctx.user.user_name,
                "real": ctx.user.real_user.user_name
                if ctx.user.real_user else None}

    def fail(self, kind):
        raise {"value": ValueError, "ref": RefError,
               "unmapped": Unmapped}[kind](f"deliberate {kind}")

    @idempotent
    def slow(self, seconds):
        time.sleep(seconds)
        return "done"


@pytest.fixture
def server(tmp_path):
    """SIMPLE authentication, and SASL for a client that asks for it
    (the KDC's keytab for ``alice``)."""
    conf = JConfiguration(load_defaults=False)
    conf.set("hadoop.proxyuser.scheduler.users", "*")
    conf.set("hadoop.proxyuser.scheduler.hosts", "*")
    kdc = MiniKdc(str(tmp_path / "kdc"))
    kdc.create_principal("alice", b"alice-pw")
    conf.set("hadoop.security.server.keytab",
             kdc.create_keytab(str(tmp_path / "server.keytab")))
    srv = Server(conf, num_handlers=3, name="echo")
    srv.register_protocol("EchoProtocol", EchoProtocol())
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture
def client():
    c = Client(Configuration())
    yield c
    c.stop()


def _proxy(server, client, **kw):
    return get_proxy(EchoProtocol, ("127.0.0.1", server.port),
                     client=client, **kw)


def test_values_cross_both_ways(server, client):
    p = _proxy(server, client)
    value = {"n": [1, -2, 2 ** 70, 1.5, None, True], "b": b"\x00\xff",
             "s": "x" * 40}
    assert p.echo(value) == value
    assert p.echo(x=[1, 2]) == [1, 2]


@pytest.mark.parametrize("kind,cls", [("value", ValueError),
                                      ("ref", PortError),
                                      ("unmapped", RemoteError)])
def test_remote_exception_maps_to_its_class(server, client, kind, cls):
    with pytest.raises(cls, match=f"deliberate {kind}") as info:
        _proxy(server, client).fail(kind)
    assert errors.is_remote(info.value)
    if cls is RemoteError:
        assert info.value.class_name == f"{__name__}.Unmapped"


def test_framework_errors_resolve_from_the_reference_names():
    from hadoop_tpu.ipc import errors as jerrors
    for jcls, cls in ((jerrors.StandbyError, errors.StandbyError),
                      (jerrors.RetriableError, errors.RetriableError),
                      (jerrors.ServerTooBusyError,
                       errors.ServerTooBusyError)):
        e = errors.resolve_exception(jerrors.wire_name(jcls("x")), "m")
        assert type(e) is cls and errors.is_remote(e)
    for e in (ValueError("v"), KeyError("k"), errors.RemoteError("a", "b")):
        assert errors.wire_name(e).rsplit(".", 1)[-1] == \
            jerrors.wire_name(e).rsplit(".", 1)[-1]
    assert errors.wire_name(ValueError("v")) == "ValueError"


def test_call_timeout(server, client):
    with pytest.raises(RpcTimeoutError):
        get_proxy("EchoProtocol", ("127.0.0.1", server.port),
                  client=client, timeout=0.2).slow(2.0)


def test_calls_share_one_connection(server, client):
    p = _proxy(server, client)
    # the first call opens the connection (racing first callers may each
    # open one, and all but one close theirs, as in the reference)
    assert p.echo(-1) == -1
    out, errs = [], []

    def worker(i):
        try:
            out.append(p.echo(i))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs and sorted(out) == list(range(16))
    assert len(client._conns) == 1
    assert len(server._conns) == 1


def test_caller_user_and_proxy_user_reach_the_handler(server, client):
    p = _proxy(server, client)
    alice = UserGroupInformation.create_remote_user("alice")
    assert alice.do_as(p.whoami) == {"user": "alice", "real": None}
    real = UserGroupInformation.create_remote_user("scheduler")
    q = _proxy(server, client,
               user=UserGroupInformation.create_proxy_user("enduser", real))
    assert q.whoami() == {"user": "enduser", "real": "scheduler"}


def test_trace_context_becomes_the_server_span_parent(server, client):
    jtracer = jglobal_tracer()
    with global_tracer().span("port.caller") as root:
        assert _proxy(server, client).echo(1) == 1
    deadline = time.monotonic() + 5
    got = []
    while not got and time.monotonic() < deadline:
        got = [s for s in list(jtracer.finished)
               if s.name == "echo.echo" and s.trace_id == root.trace_id]
        time.sleep(0.01)
    assert got and got[0].parent_id == root.span_id


def test_sasl_is_refused_naming_the_roadmap(server):
    """SASL is ported: a client configured for it authenticates to the
    same server with alice's password, the handler sees alice, and a
    wrong password is refused."""
    conf = Configuration()
    conf.set("hadoop.security.authentication", "sasl")
    alice = UserGroupInformation.create_remote_user("alice")
    alice.sasl_password = b"alice-pw"
    c = Client(conf)
    try:
        p = get_proxy(EchoProtocol, ("127.0.0.1", server.port), client=c,
                      user=alice)
        assert p.echo(b"sasl") == b"sasl"
        assert p.whoami() == {"user": "alice", "real": None}
    finally:
        c.stop()
    mallory = UserGroupInformation.create_remote_user("alice")
    mallory.sasl_password = b"wrong"
    c = Client(conf)
    try:
        with pytest.raises(errors.FatalRpcError, match="auth failed"):
            get_proxy(EchoProtocol, ("127.0.0.1", server.port), client=c,
                      user=mallory).echo(1)
    finally:
        c.stop()


def test_wait_for_proxy_returns_once_the_server_answers(server):
    p = wait_for_proxy(EchoProtocol, ("127.0.0.1", server.port),
                       timeout_s=10)
    assert p.echo("up") == "up"


class _FlakyClient:
    """Fails the first ``n`` calls with ``exc``, then echoes."""

    def __init__(self, n, exc):
        self.n, self.exc, self.calls = n, exc, []

    def call(self, addr, protocol, method, args, kwargs, timeout,
             retry_count, user):
        self.calls.append(retry_count)
        if len(self.calls) <= self.n:
            raise self.exc
        return args[0]


@pytest.mark.parametrize("method,exc,fails,retried", [
    ("echo", errors.RpcError("reset"), 2, True),
    ("whoami", errors.RpcError("reset"), 1, False),
    ("whoami", errors.ConnectFailedError("refused"), 2, True),
    ("whoami", errors.ServerTooBusyError("busy"), 1, True),
    ("echo", errors.RpcError("reset"), rpc.MAX_RETRIES + 1, False),
])
def test_idempotent_methods_retry_with_backoff(monkeypatch, method, exc,
                                               fails, retried):
    monkeypatch.setattr(rpc, "RETRY_BASE_S", 0.001)
    flaky = _FlakyClient(fails, exc)
    p = get_proxy(EchoProtocol, ("127.0.0.1", 1), client=flaky)
    if retried:
        assert getattr(p, method)("v") == "v"
        assert flaky.calls == list(range(fails + 1))
    else:
        with pytest.raises(type(exc)):
            getattr(p, method)("v")
        assert len(flaky.calls) == min(fails, rpc.MAX_RETRIES + 1)


def test_backoff_delay_equals_the_reference():
    import random
    for attempt in range(8):
        assert rpc.backoff_delay(0.2, attempt, 5.0, random.Random(attempt)) \
            == jbackoff_delay(0.2, attempt, 5.0, random.Random(attempt))


# ------------------------------------------------------- retry and failover

def _remote(cls, msg="x"):
    e = cls(msg)
    e._rpc_remote = True
    return e


@pytest.mark.parametrize("make", [
    lambda m: m.StandbyError("standby"),
    lambda m: m.ConnectFailedError("refused"),
    lambda m: m.ServerTooBusyError("busy"),
    lambda m: m.RetriableError("later"),
    lambda m: m.RpcError("reset"),
    lambda m: m.RpcTimeoutError("slow"),
    lambda m: ConnectionResetError("reset"),
    lambda m: _remote(FileNotFoundError),
    lambda m: ValueError("other"),
], ids=["standby", "connect", "busy", "retriable", "reset", "timeout",
        "oserror", "remote", "other"])
@pytest.mark.parametrize("idem", [True, False])
@pytest.mark.parametrize("retries,failovers", [(0, 0), (3, 2), (10, 0),
                                               (0, 15)])
def test_failover_policy_decides_as_the_reference(make, idem, retries,
                                                  failovers):
    """The DFS client's NameNode policy takes the reference's decision
    for every kind of failure, idempotent or not, and its limits."""
    from hadoop_tpu.ipc import errors as jerrors
    from hadoop_tpu.ipc import retry as jretry
    from hadoop_tpu_torch.ipc import retry
    got = retry.RetryPolicies.failover_on_network_exception(
        max_failovers=15, max_retries=10, delay_s=0.3).should_retry(
        make(errors), retries, failovers, idem)
    want = jretry.RetryPolicies.failover_on_network_exception(
        max_failovers=15, max_retries=10, delay_s=0.3).should_retry(
        make(jerrors), retries, failovers, idem)
    assert got.action == want.action
    assert (got.delay_s == 0) == (want.delay_s == 0)


def test_retry_handler_fails_over_to_the_live_server(server):
    """A dead first address: the connection never opens, so even a
    method that is not idempotent fails over to the live server, and
    the retry count rides the call."""
    from hadoop_tpu_torch.ipc import retry
    dead = socket.socket()
    dead.bind(("127.0.0.1", 0))
    dead_port = dead.getsockname()[1]
    dead.close()
    c = Client(Configuration())
    try:
        provider = retry.StaticFailoverProxyProvider(
            lambda addr: get_proxy(EchoProtocol, addr, client=c,
                                   max_retries=0),
            [("127.0.0.1", dead_port), ("127.0.0.1", server.port)])
        nn = retry.RetryInvocationHandler(
            provider, retry.RetryPolicies.failover_on_network_exception(
                delay_s=0.01))
        assert nn.whoami()["user"] == UserGroupInformation.get_login_user(
        ).user_name
        assert provider.current_address == ("127.0.0.1", server.port)
        assert nn.echo(5) == 5
    finally:
        c.stop()
