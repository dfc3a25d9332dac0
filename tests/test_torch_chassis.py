"""The port's HTTP chassis and span collector against the JAX package's.

Both packages' ``HttpServer`` side by side: the same endpoint set, the
same JSON keys for ``/health``, ``/ws/v1/stacks``, ``/ws/v1/top``,
``/ws/v1/traces`` and ``/ws/v1/traces/slow``, the same ``/conf``
redaction, and ``/ws/v1/conf`` answering as the reference does without
its generated conf registry. The collectors take the same span
sequences: ring bounds and the drop counter, slow-trace promotion of a
whole trace, per-plane thresholds, and trace ids in hex and decimal.
"""

import http.client
import json
import sys
import time

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.http.server import HttpServer as JHttpServer
from hadoop_tpu.obs import top as jtop
from hadoop_tpu.tracing import collector as jcollector
from hadoop_tpu.tracing import tracer as jtracer
from hadoop_tpu_torch import tracing
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.http.server import HttpServer
from hadoop_tpu_torch.obs import top

_REDACTED_KEYS = {"serving.http.auth.secret": "s3cr3t",
                  "db.password": "pw", "kerberos.keytab": "/k",
                  "s3.credential.provider": "x", "plain.key": "v",
                  "tracing.slow.serving.ms": "1000"}


@pytest.fixture(autouse=True)
def _clean_port_globals():
    tracing.span_collector().reset_for_tests()
    top.reset_for_tests()
    yield
    tracing.span_collector().reset_for_tests()
    top.reset_for_tests()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _json(port, path):
    status, body = _get(port, path)
    assert status == 200, (path, status, body[:200])
    return json.loads(body)


@pytest.fixture
def servers():
    """(port server, reference server), each on the same conf keys."""
    conf, jconf = Configuration(), JConfiguration(load_defaults=False)
    for k, v in _REDACTED_KEYS.items():
        conf.set(k, v)
        jconf.set(k, v)
    port = HttpServer(conf, daemon_name="d")
    ref = JHttpServer(jconf, daemon_name="d")
    port.start()
    ref.start()
    yield port, ref
    port.stop()
    ref.stop()


def test_same_endpoint_set(servers):
    port, ref = servers
    assert set(port._handlers) == set(ref._handlers)


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()} if obj else {}
    if isinstance(obj, list):
        return [_keys(obj[0])] if obj else []
    return type(obj).__name__


def test_same_json_keys(servers):
    port, ref = servers
    for mod in (top, jtop):
        mod.register_top_source("serving.s.tenants", lambda: {
            "total": 3.0, "tenants": {"alice": 2.0, "bob": 1.0}})
    with tracing.global_tracer().span("serving.probe"):
        pass
    with jtracer.global_tracer().span("serving.probe"):
        pass
    try:
        for path in ("/health", "/ws/v1/stacks", "/ws/v1/top",
                     "/ws/v1/traces", "/ws/v1/traces/slow"):
            got, want = _json(port.port, path), _json(ref.port, path)
            if path == "/ws/v1/stacks":
                got, want = (dict(d, threads=d["threads"][:1])
                             for d in (got, want))
            assert _keys(got) == _keys(want), path
            if path in ("/health", "/ws/v1/top"):
                assert got == want, path
        status, text = _get(port.port, "/stacks")
        assert status == 200 and b'Thread "' in text
    finally:
        jtop.unregister_top_source("serving.s.tenants")


def test_conf_is_redacted_as_the_reference(servers):
    port, ref = servers
    got = _json(port.port, "/conf")
    want = _json(ref.port, "/conf")
    assert got == {k: want[k] for k in got}
    assert got["serving.http.auth.secret"] == "<redacted>"
    assert got["db.password"] == got["kerberos.keytab"] == \
        got["s3.credential.provider"] == "<redacted>"
    assert got["plain.key"] == "v"


def test_ws_conf_answers_as_the_reference_without_a_registry(servers,
                                                             monkeypatch):
    port, ref = servers
    monkeypatch.setitem(sys.modules, "hadoop_tpu.conf.registry", None)
    status, body = _get(port.port, "/ws/v1/conf")
    jstatus, jbody = _get(ref.port, "/ws/v1/conf")
    assert status == jstatus == 503
    got = json.loads(body)
    assert set(got) == set(json.loads(jbody)) == {"error"}
    assert "ROADMAP Queue A 9" in got["error"]


def test_bad_queries_are_400_as_the_reference(servers):
    port, ref = servers
    for path in ("/ws/v1/traces?trace_id=zzz", "/ws/v1/traces?limit=x",
                 "/ws/v1/top?n=x"):
        assert _get(port.port, path)[0] == _get(ref.port, path)[0] == 400


@pytest.mark.parametrize("form", ["dec", "hex", "0x"])
def test_traces_endpoint_finds_a_trace_by_hex_and_decimal(servers, form):
    port, ref = servers
    for tracer, srv in ((tracing.global_tracer(), port),
                        (jtracer.global_tracer(), ref)):
        with tracer.span("probe.op") as sp:
            pass
        q = {"dec": str(sp.trace_id), "hex": f"{sp.trace_id:016x}",
             "0x": f"0x{sp.trace_id:x}"}[form]
        snap = _json(srv.port, f"/ws/v1/traces?trace_id={q}")
        assert [s["name"] for s in snap["spans"]] == ["probe.op"]
        assert snap["spans"][0]["trace_id"] == sp.trace_id
        assert len(_json(srv.port, "/ws/v1/traces?limit=1")["spans"]) == 1


@pytest.mark.parametrize("raw", ["10", "0x1f", "abc", "  77 ", "zz", ""])
def test_trace_id_readings_equal_the_reference(raw):
    assert tracing.parse_trace_id_candidates(raw) == \
        jtracer.parse_trace_id_candidates(raw)


# ------------------------------------------------------ the two collectors

_PACKAGES = {"port": (tracing.Tracer, tracing.SpanCollector, Configuration),
             "reference": (jtracer.Tracer, jcollector.SpanCollector,
                           lambda: JConfiguration(load_defaults=False))}


def _collector(pkg, keys=None, **kw):
    tracer_cls, collector_cls, conf_cls = _PACKAGES[pkg]
    col = collector_cls(**kw)
    if keys:
        conf = conf_cls()
        for k, v in keys.items():
            conf.set(k, v)
        col.configure(conf)
    tr = tracer_cls()
    tr.add_receiver(col.receive)
    return tr, col


def _ring(pkg):
    tr, col = _collector(pkg, max_spans=8, max_traces=4)
    for i in range(20):
        tr.span(f"op{i}").finish()
    snap = col.snapshot()
    return ([s["name"] for s in snap["spans"]], snap["dropped"],
            snap["max_spans"], [s["name"] for s in
                                col.snapshot(limit=3)["spans"]])


def _promotion(pkg):
    tr, col = _collector(pkg, {"tracing.slow.rpc.ms": "5"})
    with tr.span("namenode.slow_op") as root:
        tr.span("namenode.fast_child").finish()
        time.sleep(0.02)
    with tr.span("namenode.quick"):
        pass
    # a second slow span of the same trace refreshes its one slot
    with tr.span("namenode.again", parent=root.context()):
        time.sleep(0.01)
    slow = col.slow_traces()
    (trace,) = slow["traces"]
    return (slow["promoted"], slow["max_traces"], trace["trigger"],
            trace["trace_id"] == root.trace_id, trace["threshold_ms"],
            sorted(s["name"] for s in trace["spans"]),
            sorted(trace), sorted(trace["spans"][0]))


def _thresholds(pkg):
    keys = {"tracing.slow.xceiver.ms": "123", "tracing.slow.step.ms": "456",
            "tracing.slow.serving.ms": "789", "tracing.slow.rpc.ms": "42",
            "tracing.collector.max-spans": "16",
            "tracing.flight.max-traces": "3"}
    _, col = _collector(pkg, keys)
    names = ("dfs.xceiver.read_block", "trainer.step", "serving.request",
             "namenode.mkdirs", "trainer.ckpt.write", "dfs.client.read",
             "trainer.step_wall")
    got = [col.threshold_ms_for(n) for n in names]
    sizes = (col.max_spans, col.slow_traces()["max_traces"])
    col.reset_for_tests()
    return got, sizes, col.threshold_ms_for("namenode.mkdirs")


def _disabled(pkg):
    tr, col = _collector(pkg, {"tracing.slow.rpc.ms": "0"})
    with tr.span("namenode.op"):
        time.sleep(0.005)
    return col.slow_traces()["promoted"], len(col.snapshot()["spans"])


@pytest.mark.parametrize("case", [_ring, _promotion, _thresholds, _disabled],
                         ids=lambda f: f.__name__.strip("_"))
def test_collector_equals_the_reference(case):
    assert case("port") == case("reference")


def test_span_wire_forms_equal_the_reference():
    ctx = tracing.SpanContext(2 ** 62 + 5, 77, sampled=False)
    jctx = jtracer.SpanContext(2 ** 62 + 5, 77, sampled=False)
    assert ctx.to_wire() == jctx.to_wire()
    assert ctx.to_header() == jctx.to_header()
    back = tracing.SpanContext.from_wire(jctx.to_wire())
    assert (back.trace_id, back.span_id, back.sampled) == \
        (jctx.trace_id, jctx.span_id, jctx.sampled)
    assert tracing.SpanContext.from_wire({"t": 1, "s": 2}).sampled
    tr, jtr = tracing.Tracer(), jtracer.Tracer()
    sp, jsp = tr.span("a"), jtr.span("a")
    for s in (sp, jsp):
        s.annotate("note")
        s.add_kv("k", "v")
        s.finish()
    assert sorted(sp.to_dict()) == sorted(jsp.to_dict())
    assert sp.to_dict()["annotations"] == ["note"]
    assert sp.duration_ms() >= 0
    tr.set_sample_rate(0.0)
    assert not tr.span("root").sampled
