"""The port's ``RegistryClient`` against the JAX package's
``RegistryServer``, and ``record_is_stale`` against the reference's."""

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
