"""The port's ``RegistryClient`` against the JAX package's
``RegistryServer``, ``record_is_stale`` against the reference's, and the
port's ``RegistryServer``: both packages' clients register, renew, list
and expire records on both packages' servers, and the port's server
keeps the reference's storage semantics call for call."""

import time

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.registry import RegistryServer
from hadoop_tpu.registry import registry as jregistry
from hadoop_tpu_torch import registry
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.registry import RegistryClient, ServiceRecord


@pytest.fixture
def reg_srv():
    conf = JConfiguration(load_defaults=False)
    conf.set("registry.sweep.interval", "0.05")
    srv = RegistryServer(conf)
    srv.init(conf)
    srv.start()
    yield srv
    srv.stop()


def _client(srv):
    return RegistryClient(("127.0.0.1", srv.port), Configuration())


def test_register_resolve_list_unregister(reg_srv):
    c = _client(reg_srv)
    try:
        a = ServiceRecord("/services/serving/s/a", {"http": "h:1"},
                          {"role": "decode", registry.HEARTBEAT_ATTR: "1.5"})
        b = ServiceRecord("/services/serving/s/b", {"http": "h:2"},
                          ephemeral=False)
        c.register(a, ttl_s=30, auto_renew=False)
        c.register(b, ttl_s=30, auto_renew=False)
        got = c.resolve(a.path)
        assert got.to_wire() == a.to_wire()
        # the server holds the reference's record, field for field
        assert reg_srv.get(a.path).to_wire() == a.to_wire()
        assert [r.path for r in c.list("/services/serving/s")] == \
            [a.path, b.path]
        assert c.list("/services/serving/other") == []
        c.unregister(a.path)
        assert c.resolve(a.path) is None
        assert [r.path for r in c.list("/services")] == [b.path]
    finally:
        c.close()


def test_auto_renew_keeps_a_record_past_its_ttl(reg_srv):
    c = _client(reg_srv)
    kept = ServiceRecord("/r/kept", {"http": "h:1"})
    lapsed = ServiceRecord("/r/lapsed", {"http": "h:2"})
    try:
        c.register(kept, ttl_s=0.3)
        c.register(lapsed, ttl_s=0.3, auto_renew=False)
        time.sleep(1.0)
        assert c.resolve(kept.path) is not None
        assert c.resolve(lapsed.path) is None
        # a record the server lost is registered again by the renewal
        reg_srv.remove(kept.path)
        deadline = time.monotonic() + 5
        while c.resolve(kept.path) is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert c.resolve(kept.path) is not None
        c.unregister(kept.path)
        time.sleep(0.3)
        assert c.resolve(kept.path) is None
    finally:
        c.close()


def test_a_reference_client_reads_what_the_port_registered(reg_srv):
    c = _client(reg_srv)
    j = jregistry.RegistryClient(("127.0.0.1", reg_srv.port),
                                 JConfiguration(load_defaults=False))
    try:
        rec = ServiceRecord("/x/y", {"http": "h:9"}, {"k": "v"})
        c.register(rec, auto_renew=False)
        assert j.resolve("/x/y").to_wire() == rec.to_wire()
        j.register(jregistry.ServiceRecord("/x/z", {"http": "h:8"}),
                   auto_renew=False)
        assert c.resolve("/x/z").endpoints == {"http": "h:8"}
    finally:
        c.close()
        j.close()


def test_a_dead_registry_raises_a_connect_failure():
    from hadoop_tpu_torch.ipc.errors import ConnectFailedError
    c = RegistryClient(("127.0.0.1", 1), Configuration())
    try:
        with pytest.raises(ConnectFailedError):
            c.resolve("/a")
    finally:
        c.close()


@pytest.mark.parametrize("attrs,ttl,now", [
    ({}, 10.0, 1000.0),
    ({"hb": "995.0"}, 10.0, 1000.0),
    ({"hb": "989.0"}, 10.0, 1000.0),
    ({"hb": "990.0"}, 10.0, 1000.0),
    ({"hb": ""}, 10.0, 1000.0),
    ({"hb": "not-a-stamp"}, 10.0, 1000.0),
    ({"hb": "2000.0"}, 10.0, 1000.0),
    ({"hb": "999.9"}, 0.05, 1000.0),
])
def test_record_is_stale_equals_the_reference(attrs, ttl, now):
    rec = ServiceRecord("/p", {}, dict(attrs))
    jrec = jregistry.ServiceRecord("/p", {}, dict(attrs))
    assert registry.record_is_stale(rec, ttl, now) == \
        jregistry.record_is_stale(jrec, ttl, now)
    fresh = ServiceRecord("/p", {}, {"hb": f"{time.time():.3f}"})
    assert not registry.record_is_stale(fresh, 10.0)


def test_record_ttl_equals_the_reference():
    for keys in ({}, {"serving.registry.ttl": "4s"},
                 {"serving.registry.record.ttl": "750ms",
                  "serving.registry.ttl": "4s"}):
        conf, jconf = Configuration(), JConfiguration(load_defaults=False)
        for k, v in keys.items():
            conf.set(k, v)
            jconf.set(k, v)
        assert registry.record_ttl(conf) == jregistry.record_ttl(jconf)


SERVERS = {"ref": (JConfiguration, RegistryServer),
           "port": (Configuration, registry.RegistryServer)}
CLIENTS = {"ref": (JConfiguration, jregistry.RegistryClient,
                   jregistry.ServiceRecord),
           "port": (Configuration, RegistryClient, ServiceRecord)}


def _start(kind, sweep="0.05"):
    conf_cls, srv_cls = SERVERS[kind]
    conf = conf_cls(load_defaults=False)
    conf.set("registry.sweep.interval", sweep)
    srv = srv_cls(conf)
    srv.init(conf)
    srv.start()
    return srv


def _wait(cond, seconds=5.0):
    deadline = time.monotonic() + seconds
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


@pytest.mark.parametrize("server", ["ref", "port"])
@pytest.mark.parametrize("client", ["ref", "port"])
def test_clients_and_servers_cross(client, server):
    """Register (ephemeral and persistent), resolve, list by prefix,
    renew past a TTL, expire, re-register a lost record, unregister."""
    srv = _start(server)
    conf_cls, cl_cls, rec_cls = CLIENTS[client]
    c = cl_cls(("127.0.0.1", srv.port), conf_cls(load_defaults=False))
    try:
        eph = rec_cls("/services/serving/s/e", {"http": "h:1"},
                      {"role": "prefill", "hb": "12.5"})
        per = rec_cls("/services/serving/s/p", {"http": "h:2"},
                      ephemeral=False)
        other = rec_cls("/services/servingx/t", {"http": "h:3"})
        c.register(eph, ttl_s=0.4, auto_renew=False)
        c.register(per, ttl_s=0.4, auto_renew=False)
        c.register(other, ttl_s=30.0, auto_renew=False)
        assert c.resolve(eph.path).to_wire() == eph.to_wire()
        # a prefix matches whole path components only
        assert [r.path for r in c.list("/services/serving/s/")] == \
            [eph.path, per.path]
        assert [r.path for r in c.list("/services/serving")] == \
            [eph.path, per.path]
        # renewing keeps the ephemeral record past its first TTL
        for _ in range(4):
            time.sleep(0.15)
            assert c._proxy.renew(eph.path, 0.4) is True
        assert c.resolve(eph.path) is not None
        # unrenewed it expires; the persistent one never does
        assert _wait(lambda: c.resolve(eph.path) is None)
        assert c.resolve(per.path) is not None
        assert c._proxy.renew(eph.path, 0.4) is False
        # auto-renew registers a record the server lost again
        c.register(eph, ttl_s=0.5)
        srv.remove(eph.path)
        assert _wait(lambda: c.resolve(eph.path) is not None)
        c.unregister(eph.path)
        assert c._proxy.unregister(eph.path) is False
        assert c.resolve(eph.path) is None
    finally:
        c.close()
        srv.stop()


def _script(srv, rec_cls):
    """One storage script against a server object; its answers."""
    out = []
    a = rec_cls("/a/x", {"http": "h:1"}, {"k": "1"})
    b = rec_cls("/a/y", {"http": "h:2"}, ephemeral=False)
    out.append(srv.put(a, 10.0))
    out.append(srv.put(b, 10.0))
    out.append(srv.renew("/a/x", 10.0))
    out.append(srv.renew("/a/none", 10.0))
    out.append([r.to_wire() for r in srv.list("/a")])
    out.append([r.to_wire() for r in srv.list("/a/x")])
    out.append([r.to_wire() for r in srv.list("/")])
    out.append(srv.get("/a/y").to_wire())
    out.append(srv.get("/b"))
    out.append(srv.remove("/a/x"))
    out.append(srv.remove("/a/x"))
    out.append([r.path for r in srv.list("/a")])
    return out


def test_server_storage_answers_as_the_reference():
    ports = [registry.RegistryServer(Configuration(load_defaults=False)),
             RegistryServer(JConfiguration(load_defaults=False))]
    assert _script(ports[0], ServiceRecord) == \
        _script(ports[1], jregistry.ServiceRecord)


def test_the_sweep_expires_by_deadline_only():
    """The port's sweep, called directly at a given monotonic time: an
    ephemeral record goes once its deadline passed, a renewed one stays,
    a persistent one stays whatever the time."""
    srv = registry.RegistryServer(Configuration(load_defaults=False))
    srv.put(ServiceRecord("/e/old", {}), 1.0)
    srv.put(ServiceRecord("/e/renewed", {}), 1.0)
    srv.put(ServiceRecord("/e/persist", {}, ephemeral=False), 1.0)
    now = time.monotonic()
    assert srv._sweep_once(now) == []
    srv.renew("/e/renewed", 100.0)
    assert srv._sweep_once(now + 5.0) == ["/e/old"]
    assert [r.path for r in srv.list("/e")] == ["/e/persist", "/e/renewed"]
    assert srv._sweep_once(now + 1e9) == ["/e/renewed"]
    assert [r.path for r in srv.list("/e")] == ["/e/persist"]
