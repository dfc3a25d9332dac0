"""The PyTorch port's serving door against the JAX package's, on the CPU.

The port's ``ServingServer`` and ``ServingReplica`` serve the same
numpy-seeded float32 weights as ``hadoop_tpu``'s door over the tiny
preset. Tokens must equal, exactly, the port's in-process ``generate``,
the reference door's and a full-recompute greedy loop over the JAX
``forward``. The wire contract is held against the reference: auth
cookies and trace headers cross between the packages both ways, the
health key set and the ``/prom`` families are the same, QoS levels
follow the same charges, and a ``hadoop_tpu`` router reaches a port
replica through its registry, in process and from the command line's
``--registry``; the YARN spec is the reference's but for the module.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.security import http_auth as jauth
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving import qos as jqos
from hadoop_tpu.serving.metrics import ServingMetrics as JServingMetrics
from hadoop_tpu.serving.server import ServingServer as JServingServer
from hadoop_tpu.tracing.tracer import SpanContext as JSpanContext
from hadoop_tpu.tracing.tracer import global_tracer as jglobal_tracer
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.parallel.checkpoint import save_checkpoint
from hadoop_tpu_torch.security import http_auth
from hadoop_tpu_torch.serving import qos, service
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.serving.metrics import ServingMetrics
from hadoop_tpu_torch.serving.server import ServingServer
from hadoop_tpu_torch.tracing import global_tracer

REPO = Path(__file__).resolve().parents[1]
SECRET = "s3cr3t"
ENGINE_KW = dict(max_batch=4, block_size=4, max_context=48)
_REF_P = 48
_model = {}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    """(jax cfg, jax params, port cfg, port params, jitted jax forward)."""
    if not _model:
        jcfg = jconfig.get_config("tiny")
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = config.get_config("tiny")
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        fwd = jax.jit(lambda p, t: jdecoder.forward(p, t, jcfg))
        _model.update(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                      fwd=fwd)
    return _model


def _reference_greedy(prompt, max_new):
    """Full JAX forward recompute each step, padded to one length."""
    m = _tiny()
    seq = list(prompt)
    for _ in range(max_new):
        padded = seq + [0] * (_REF_P - len(seq))
        logits = m["fwd"](m["jparams"], jnp.asarray([padded]))
        seq.append(int(jnp.argmax(logits[0, len(seq) - 1])))
    return seq[len(prompt):]


def _conf(cls=Configuration, **keys):
    conf = cls(load_defaults=False)
    for k, v in keys.items():
        conf.set(k.replace("_", "."), v)
    return conf


def _request(port, method, path, payload=None, headers=None, timeout=60):
    """(status, body bytes, headers dict)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read(), dict(resp.getheaders())
    finally:
        conn.close()


def _post(port, path, payload, headers=None, timeout=60):
    status, body, hdrs = _request(port, "POST", path, payload, headers,
                                  timeout)
    return status, (json.loads(body) if body else {}), hdrs


def _health(port):
    status, body, _ = _request(port, "GET", "/v1/health")
    assert status == 200
    return json.loads(body)


def _port_door(conf=None, metrics=True, start=True, **kw):
    m = _tiny()
    eng = DecodeEngine(m["params"], m["cfg"], device="cpu",
                       metrics=ServingMetrics() if metrics else None,
                       **{**ENGINE_KW, **kw})
    srv = ServingServer(eng, conf or _conf(serving_http_auth_secret=SECRET))
    if start:
        eng.start()
    srv.start()
    return eng, srv


@pytest.fixture(scope="module")
def ref_door():
    """The reference door over the JAX engine on the same weights, its
    step compiled once for the whole module."""
    m = _tiny()
    eng = jengine.DecodeEngine(m["jparams"], m["jcfg"],
                               metrics=JServingMetrics(), **ENGINE_KW)
    srv = JServingServer(eng, _conf(JConfiguration,
                                    serving_http_auth_secret=SECRET))
    eng.start()
    srv.start()
    yield eng, srv
    srv.stop()


PROMPTS = [([7, 8, 9], 40), ([42, 43], 8), ([1, 2, 3, 4, 5, 6], 8)]


def _concurrent(port, eng):
    """The long request first; the others join while it decodes."""
    results = {}

    def ask(i):
        prompt, n = PROMPTS[i]
        results[i] = _post(port, "/v1/generate?user.name=alice",
                           {"tokens": prompt, "max_new_tokens": n})

    t0 = threading.Thread(target=ask, args=(0,))
    t0.start()
    deadline = time.monotonic() + 60
    while eng.num_active < 1 and time.monotonic() < deadline:
        time.sleep(0.002)
    rest = [threading.Thread(target=ask, args=(i,)) for i in (1, 2)]
    for t in rest:
        t.start()
    for t in [t0] + rest:
        t.join(timeout=120)
        assert not t.is_alive()
    for i in range(3):
        assert results[i][0] == 200, results[i]
    return [results[i][1]["tokens"] for i in range(3)]


# ------------------------------------------------------------- tokens

def test_concurrent_requests_equal_generate_reference_door_and_greedy(
        ref_door):
    m = _tiny()
    eng, srv = _port_door()
    ttft0 = eng.metrics.ttft.snapshot()["time_to_first_token_count"]
    try:
        got = _concurrent(srv.port, eng)
        assert max(eng.occupancy_log) >= 2, "no mid-decode admission"
        assert eng.metrics.ttft.snapshot()[
            "time_to_first_token_count"] - ttft0 == 3
        assert eng.decode_compiles == 1 and eng.prefill_compiles == 1
    finally:
        srv.stop()
    offline = DecodeEngine(m["params"], m["cfg"], device="cpu",
                           **ENGINE_KW)
    in_process = [offline.generate([p], SamplingParams(max_new_tokens=n))[0]
                  for p, n in PROMPTS]
    ref = _concurrent(ref_door[1].port, ref_door[0])
    assert got == in_process == ref == [_reference_greedy(p, n)
                                        for p, n in PROMPTS]


def test_stream_lines_then_disconnect_finishes_span():
    eng, srv = _port_door()
    tracer = global_tracer()
    try:
        status, body, _ = _request(
            srv.port, "POST", "/v1/generate?user.name=alice",
            {"tokens": [7, 8, 9], "max_new_tokens": 6, "stream": True})
        assert status == 200
        lines = [json.loads(x) for x in body.splitlines() if x]
        assert [x["token"] for x in lines[:-1]] == \
            _reference_greedy([7, 8, 9], 6)
        assert lines[-1] == {"done": True,
                             "request_id": lines[-1]["request_id"],
                             "tokens": [x["token"] for x in lines[:-1]]}

        # a client that reads one token line and hangs up: the server's
        # next write fails and the stream's generator is closed, which
        # finishes its serving.request span; the engine goes on
        trace = JSpanContext(0x5EED, 0x1, True)
        sock = socket.create_connection(("127.0.0.1", srv.port), 10)
        payload = json.dumps({"tokens": [5, 6, 7], "max_new_tokens": 40,
                              "stream": True}).encode()
        sock.sendall(b"POST /v1/generate?user.name=alice HTTP/1.1\r\n"
                     b"Host: x\r\nX-Htpu-Trace: " +
                     trace.to_header().encode() +
                     b"\r\nContent-Length: " + str(len(payload)).encode() +
                     b"\r\n\r\n" + payload)
        got = b""
        while b'{"token"' not in got:
            got += sock.recv(4096)
        sock.close()
        deadline = time.monotonic() + 30
        span = None
        while span is None and time.monotonic() < deadline:
            span = next((s for s in list(tracer.finished)
                         if s.name == "serving.request"
                         and s.trace_id == 0x5EED), None)
            time.sleep(0.01)
        assert span is not None and span.end is not None
        assert span.parent_id == 0x1
        status, out, _ = _post(srv.port, "/v1/generate?user.name=alice",
                               {"tokens": [1, 2], "max_new_tokens": 3})
        assert status == 200 and out["tokens"] == _reference_greedy([1, 2],
                                                                   3)
    finally:
        srv.stop()


def test_chassis_closes_a_stream_whose_client_hangs_up():
    from hadoop_tpu_torch.http.server import HttpServer
    closed = threading.Event()

    def forever(query, body):
        def gen():
            try:
                while True:
                    yield b"x" * 65536
            finally:
                closed.set()
        return 200, gen()

    srv = HttpServer(Configuration())
    srv.add_handler("/s", forever)
    srv.start()
    try:
        sock = socket.create_connection(("127.0.0.1", srv.port), 10)
        sock.sendall(b"GET /s HTTP/1.1\r\nHost: x\r\n\r\n")
        sock.recv(1024)
        sock.close()
        assert closed.wait(30)
    finally:
        srv.stop()


# --------------------------------------------------------------- auth

def test_401_without_credential_and_cookies_cross_both_ways():
    eng, srv = _port_door()
    try:
        status, body, _ = _post(srv.port, "/v1/generate", {"tokens": [1]})
        assert status == 401 and "AuthenticationException" in str(body)
        # a cookie the reference filter signs opens the port's door
        ref_cookie = jauth.AuthFilter(SECRET.encode()).authenticate(
            {"user.name": "bob"})[1]
        status, out, hdrs = _post(
            srv.port, "/v1/generate", {"tokens": [1, 2],
                                       "max_new_tokens": 2},
            headers={"Cookie": f"hadoop.auth={ref_cookie}"})
        assert status == 200 and "Set-Cookie" not in hdrs
        # the cookie the port's door issues passes the reference filter
        status, _, hdrs = _post(srv.port, "/v1/generate?user.name=carol",
                                {"tokens": [1, 2], "max_new_tokens": 2})
        assert status == 200
        issued = hdrs["Set-Cookie"].split(";")[0].split("=", 1)[1]
        assert jauth.AuthFilter(SECRET.encode()).authenticate(
            {"__cookie__": f"hadoop.auth={issued}"}) == ("carol", None)
    finally:
        srv.stop()
    # the same token signs to the same bytes in both packages
    tok = (jauth.AuthenticationToken("dave", 1.9e9),
           http_auth.AuthenticationToken("dave", 1.9e9))
    assert tok[0].sign(b"k") == tok[1].sign(b"k")
    # tampered, wrong-secret and expired cookies are refused by both
    good = tok[1].sign(b"k")
    b64, _, mac = good.partition(".")
    bad = [b64 + "." + mac[:-1] + ("0" if mac[-1] != "0" else "1"),
           b64[:-2] + "AA." + mac,
           http_auth.AuthenticationToken("dave", 1.9e9).sign(b"other"),
           http_auth.AuthenticationToken("dave", time.time() - 1).sign(
               b"k")]
    for signed in bad:
        assert http_auth.AuthenticationToken.verify(signed, b"k") is None
        assert jauth.AuthenticationToken.verify(signed, b"k") is None
    assert http_auth.AuthenticationToken.verify(good, b"k").user == "dave"


# ------------------------------------------------- timeouts and drain

def test_generate_timeout_returns_408_and_bad_timeout_400():
    eng, srv = _port_door(conf=Configuration(load_defaults=False),
                          start=False)      # no scheduler: it parks
    try:
        status, body, _ = _post(srv.port, "/v1/generate",
                                {"tokens": [1, 2], "max_new_tokens": 4,
                                 "timeout": 0.2})
        assert status == 408 and "RequestTimedOutException" in str(body)
        status, body, _ = _post(srv.port, "/v1/generate",
                                {"tokens": [1, 2], "timeout": "abc"})
        assert status == 400 and "IllegalArgument" in str(body)
    finally:
        srv.stop()


@pytest.mark.parametrize("how", ["drain", "admin_endpoint"])
def test_drain_then_503_draining_and_complete(how):
    eng, srv = _port_door()
    try:
        held = eng.submit([3, 4, 5], SamplingParams(max_new_tokens=20))
        if how == "drain":
            srv.drain(timeout=30)
        else:
            answers = []

            def knock():
                answers.append(_post(srv.port,
                                     "/v1/admin/drain?user.name=ops", {}))

            knockers = [threading.Thread(target=knock) for _ in range(6)]
            for t in knockers:
                t.start()
            for t in knockers:
                t.join(timeout=30)
            assert all(s == 202 and b["draining"] for s, b, _ in answers)
            # racing POSTs start exactly one drain
            assert sorted(b["already_draining"] for _, b, _ in answers) \
                == [False] + [True] * 5
            deadline = time.monotonic() + 30
            while not _health(srv.port)["drain_complete"] and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
            status, body, _ = _post(srv.port,
                                    "/v1/admin/drain?user.name=ops", {})
            assert status == 202 and body["already_draining"] is True
        # in-flight work was finished, not failed
        assert held.wait(0) == _reference_greedy([3, 4, 5], 20)
        status, body, _ = _post(srv.port, "/v1/generate?user.name=alice",
                                {"tokens": [1]})
        assert status == 503 and "RetriableException" in str(body)
        health = _health(srv.port)
        assert health["status"] == "draining"
        assert health["drain_complete"] is True
    finally:
        srv.stop()


# ---------------------------------------------------------------- QoS

def test_qos_levels_and_shed_decisions_equal_the_reference():
    keys = dict(serving_qos_decay_period="3600s",
                serving_qos_shed_queue_depth="4",
                serving_qos_queue_max="10")

    class _Eng:
        queue_depth = 0

    gates, engs = [], []
    for cls, mod in ((Configuration, qos), (JConfiguration, jqos)):
        eng = _Eng()
        engs.append(eng)
        gates.append(mod.QoSGate(_conf(cls, **keys), eng))
    charges = [("heavy", 900), ("light", 100), ("mid", 300), ("heavy", 50),
               ("light", 7), ("new", 1), ("mid", 2000)]
    depths = [0, 5, 5, 9, 10, 3, 5]
    try:
        for (tenant, cost), depth in zip(charges, depths):
            for gate, eng in zip(gates, engs):
                eng.queue_depth = depth
            got = [g.admit(tenant, cost) for g in gates]
            assert got[0] == got[1], (tenant, got)
            for t in ("heavy", "light", "mid", "new", "anonymous"):
                assert gates[0].sched.level_of(t) == \
                    gates[1].sched.level_of(t)
                assert gates[0].sched.share_of(t) == \
                    gates[1].sched.share_of(t)
        assert gates[0].stats() == gates[1].stats()
        assert gates[0].sched.snapshot() == gates[1].sched.snapshot()
    finally:
        for g in gates:
            g.stop()

    # the fair queue pops in the reference's order
    class _Req:
        def __init__(self, tenant):
            self.tenant = tenant

    queues = [qos.FairAdmissionQueue(gates[0].sched),
              jqos.FairAdmissionQueue(gates[1].sched)]
    seqs = []
    for q in queues:
        reqs = [_Req(t) for t, _ in charges]
        for r in reqs[1:]:
            q.append(r)
        q.appendleft(reqs[0])          # a preempted request's lane
        seq = []
        while len(q):
            head = q[0]
            assert q.popleft() is head
            seq.append(reqs.index(head))
        seqs.append(seq)
    assert seqs[0] == seqs[1]


def test_door_sheds_over_share_tenant_with_retry_after():
    conf = _conf(serving_qos_decay_period="3600s",
                 serving_qos_shed_queue_depth="2",
                 serving_qos_thresholds="0.5,0.7,0.9")
    m = _tiny()
    eng = DecodeEngine(m["params"], m["cfg"], device="cpu", max_batch=2,
                       block_size=4, max_context=32)
    gate = qos.QoSGate(conf, eng)
    srv = ServingServer(eng, conf, qos=gate)
    srv.start()           # no scheduler: admitted requests park
    try:
        threads = [threading.Thread(target=_post, args=(
            srv.port, f"/v1/generate?user.name={user}",
            {"tokens": [1, 2], "max_new_tokens": 4, "timeout": 0.8}))
            for user in ("light", "heavy", "heavy", "heavy")]
        threads[0].start()
        while gate.sched.num_tenants < 1:
            time.sleep(0.005)
        for t in threads[1:]:
            t.start()
        deadline = time.monotonic() + 10
        while (eng.queue_depth < 2 or gate.sched.num_tenants < 2) and \
                time.monotonic() < deadline:
            time.sleep(0.005)
        status, body, hdrs = _post(srv.port, "/v1/generate?user.name=heavy",
                                   {"tokens": [1, 2], "max_new_tokens": 4,
                                    "timeout": 5})
        assert status == 429 and "ServerTooBusy" in str(body)
        assert float(hdrs["Retry-After"]) > 0
        status, body, _ = _post(srv.port, "/v1/generate?user.name=light",
                                {"tokens": [1, 2], "max_new_tokens": 4,
                                 "timeout": 0.2})
        assert status == 408, body       # admitted under overload
        for t in threads:
            t.join(timeout=30)
        stats = gate.stats()
        assert stats["sheds_by_tenant"].get("heavy", 0) >= 1
        assert "light" not in stats["sheds_by_tenant"]
        assert _health(srv.port)["qos"] == stats
    finally:
        srv.stop()


# ------------------------------------------------ health, prom, traces

def _keys(d, depth=2):
    """The key tree of a JSON object down to ``depth`` levels."""
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def test_health_has_the_reference_key_set(ref_door):
    eng, srv = _port_door()
    try:
        got = _health(srv.port)
    finally:
        srv.stop()
    want = _health(ref_door[1].port)
    # hbm.device is None for a process that has no CUDA device, a dict
    # on the card: compare it apart
    assert got["hbm"].pop("device") is None
    want["hbm"].pop("device")
    assert _keys(got) == _keys(want)
    for key in ("slots", "kv_blocks_total", "status", "drain_complete",
                "longctx"):
        assert got[key] == want[key], key
    for key in ("parity", "dtype", "weight_bytes", "lanes", "max_context",
                "kv_capacity_tokens", "lanes_x_context"):
        assert got["weights"][key] == want["weights"][key], key


def _families(text, source):
    """{(sample name, labels without source)} of ``source``'s lines."""
    out = set()
    for line in text.splitlines():
        if line.startswith("#") or f'source="{source}"' not in line:
            continue
        sample = line.split(" # ")[0].rsplit(" ", 1)[0]
        name, _, labels = sample.partition("{")
        labels = tuple(sorted(
            p for p in labels.rstrip("}").split(",")
            if p and not p.startswith("source=")))
        out.add((name, labels))
    return out


def test_prom_has_the_reference_families_and_labels(ref_door):
    eng, srv = _port_door()
    try:
        _concurrent(srv.port, eng)
        _health(srv.port)
        status, text, _ = _request(srv.port, "GET", "/prom")
        assert status == 200
        status, jmx, _ = _request(srv.port, "GET", "/jmx?qry=serving")
        assert status == 200
    finally:
        srv.stop()
    # the reference's metrics system is reset before each test
    # (tests/conftest.py): give its engine this test's registry
    ref_door[0].metrics = JServingMetrics()
    _concurrent(ref_door[1].port, ref_door[0])
    _health(ref_door[1].port)
    _, want, _ = _request(ref_door[1].port, "GET", "/prom")
    text, want = text.decode(), want.decode()
    for source in ("serving.engine", "hbm"):
        got = _families(text, source)
        assert got and got == _families(want, source), source
    assert "htpu_build_info{" in text
    beans = json.loads(jmx)["beans"]
    assert [b["name"] for b in beans] == ["serving.engine"]
    assert beans[0]["tokens_out"] > 0


def test_trace_header_joins_request_admit_and_first_token():
    eng, srv = _port_door()
    root = jglobal_tracer().span("router.generate")
    try:
        status, _, _ = _post(
            srv.port, "/v1/generate?user.name=alice",
            {"tokens": [9, 8, 7], "max_new_tokens": 3},
            headers={"X-Htpu-Trace": root.context().to_header()})
        assert status == 200
    finally:
        root.finish()
        srv.stop()
    spans = {s.name: s for s in list(global_tracer().finished)
             if s.trace_id == root.trace_id}
    assert {"serving.request", "serving.admit",
            "serving.first_token"} <= set(spans)
    request = spans["serving.request"]
    assert request.parent_id == root.span_id
    assert spans["serving.admit"].parent_id == request.span_id
    assert spans["serving.first_token"].parent_id == request.span_id


# ------------------------------------------------ replica and command

def test_replica_in_reference_registry_routed_then_drained(tmp_path):
    from hadoop_tpu.fs import LocalFileSystem as JLocalFileSystem
    from hadoop_tpu.parallel.checkpoint import save_checkpoint as jsave
    from hadoop_tpu.registry import RegistryClient, RegistryServer
    from hadoop_tpu.serving.router import ServingRouter
    m = _tiny()
    jsave(JLocalFileSystem(), f"{tmp_path}/ckpt", 2,
          {"params": m["jparams"], "opt": {}})
    conf = _conf(JConfiguration, serving_kv_block_size="4",
                 serving_max_context="48")
    reg_srv = RegistryServer(conf)
    reg_srv.init(conf)
    reg_srv.start()
    try:
        reg = RegistryClient(("127.0.0.1", reg_srv.port), conf)
        replica = service.ServingReplica(
            conf, name="door", checkpoint=f"file://{tmp_path}/ckpt",
            preset="tiny", registry=reg, instance="i0", device="cpu")
        assert replica.step == 2
        replica.start()
        router = ServingRouter(("127.0.0.1", reg_srv.port), "door", conf)
        out = router.generate({"tokens": [1, 2], "max_new_tokens": 3})
        assert out["tokens"] == _reference_greedy([1, 2], 3)
        (rec,) = router.replicas(refresh=True)
        assert rec.attributes["weight_dtype"] == "float32"
        replica.drain_and_stop(timeout=15)
        assert replica.drained.is_set()
        assert router.replicas(refresh=True) == []
        router.close()
    finally:
        reg_srv.stop()


def test_command_line_serves_health_and_exits_0_on_sigterm(tmp_path):
    save_checkpoint(LocalFileSystem(), f"{tmp_path}/ckpt", 4,
                    {"params": _tiny()["params"]})
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "hadoop_tpu_torch.serving.service",
         "--checkpoint", f"{tmp_path}/ckpt", "--preset", "tiny",
         "--device", "cpu", "-D", "serving.kv.block.size=4",
         "-D", "serving.max.context=48"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            assert line, "the replica exited before serving"
            if " up on :" in line:
                port = int(line.split(" up on :")[1].split()[0])
        health = _health(port)
        assert health["status"] == "serving"
        assert health["weights"]["dtype"] == "float32"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def _replica_port(proc):
    """The port a replica process logs once it is up."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stderr.readline()
        assert line, "the replica exited before serving"
        if " up on :" in line:
            return int(line.split(" up on :")[1].split()[0])
    raise AssertionError("the replica did not come up")


def test_command_line_registry_routes_traces_then_unregisters(tmp_path):
    """``--registry`` opens the port's RPC client on the reference's
    registry: the record carries the attributes a router reads, the
    reference's router serves through the replica, the replica's chassis
    shows the request's span and the door's tenants, and SIGTERM drains
    and unregisters."""
    from hadoop_tpu.registry import RegistryServer, record_is_stale
    from hadoop_tpu.serving.router import ServingRouter
    save_checkpoint(LocalFileSystem(), f"{tmp_path}/ckpt", 4,
                    {"params": _tiny()["params"]})
    jconf = _conf(JConfiguration)
    reg_srv = RegistryServer(jconf)
    reg_srv.init(jconf)
    reg_srv.start()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "hadoop_tpu_torch.serving.service",
         "--name", "door", "--checkpoint", f"{tmp_path}/ckpt",
         "--preset", "tiny", "--registry", f"127.0.0.1:{reg_srv.port}",
         "--device", "cpu", "-D", "serving.kv.block.size=4",
         "-D", "serving.max.context=48", "-D", "serving.kv.host.bytes=4096"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    router = None
    try:
        port = _replica_port(proc)
        (rec,) = reg_srv.list("/services/serving/door")
        assert rec.endpoints == {"http": f"127.0.0.1:{port}"}
        assert {k: rec.attributes[k] for k in ("role", "kv_host_bytes",
                                               "kv_dfs", "state")} == \
            {"role": "mixed", "kv_host_bytes": "4096", "kv_dfs": "0",
             "state": "serving"}
        assert not record_is_stale(rec, 10.0)
        router = ServingRouter(("127.0.0.1", reg_srv.port), "door", jconf)
        out = router.generate({"tokens": [1, 2], "max_new_tokens": 3},
                              user="alice")
        assert out["tokens"] == _reference_greedy([1, 2], 3)
        status, body, _ = _request(port, "GET", "/ws/v1/traces")
        spans = json.loads(body)["spans"]
        assert status == 200 and any(sp["name"] == "serving.request"
                                     for sp in spans)
        status, body, _ = _request(port, "GET", "/ws/v1/top")
        tenants = json.loads(body)["sources"]["serving.door.tenants"]
        assert status == 200 and tenants["window"][0]["key"] == "alice"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert reg_srv.list("/services/serving/door") == []
    finally:
        if router is not None:
            router.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
        reg_srv.stop()


def test_service_spec_is_the_references_but_the_module():
    """The reference's ``ServiceSpec.from_json`` reads the port's spec,
    which equals the reference's but for the module it launches."""
    from hadoop_tpu.serving.service import serving_service_spec as jspec
    from hadoop_tpu.yarn.records import Resource as JResource
    from hadoop_tpu.yarn.services import ServiceSpec as JServiceSpec
    from hadoop_tpu_torch.yarn import Resource
    for kw, res in (({}, None),
                    ({"registry_addr": "127.0.0.1:7777", "replicas": 3,
                      "extra_args": ["--role", "decode", "-D",
                                     "serving.parity=relaxed"]},
                     (2048, 4, 1))):
        got = service.serving_service_spec(
            "llm", checkpoint="/models/llm", preset="tiny",
            resource=Resource(*res) if res else None, **kw)
        want = jspec("llm", checkpoint="/models/llm", preset="tiny",
                     resource=JResource(*res) if res else None, **kw)
        read = JServiceSpec.from_json(got.to_json())
        assert json.loads(read.to_json()) == json.loads(
            want.to_json().replace("hadoop_tpu.serving.service",
                                   "hadoop_tpu_torch.serving.service"))
        (comp,) = read.components
        assert comp.restart_policy == "ALWAYS"
        assert comp.launch_command[1:3] == [
            "-m", "hadoop_tpu_torch.serving.service"]
        # the port's command line takes every flag the spec passes
        flags = [a for a in comp.launch_command[3:] if a.startswith("--")]
        assert set(flags) <= {"--replica", "--name", "--checkpoint",
                              "--preset", "--host", "--registry", "--role"}


# ----------------------------------------------------------- refusals

@pytest.mark.parametrize("key,value,item", [
    ("checkpoint", "htpu://nn:8020/models/x", "A 9"),
])
def test_unported_features_are_refused(tmp_path, key, value, item):
    """What the replica still refuses names its ROADMAP item, in process
    and on the command line (exit 2): a DFS checkpoint URI without an
    ``fs=`` (the port has no DFS client). ``serving.longctx.enabled`` is
    ported (``test_longctx_key_*`` below)."""
    conf = Configuration()
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue {item}"):
        service.ServingReplica(conf, name="x", preset="tiny",
                               checkpoint=value, device="cpu")
    argv = ["--checkpoint", value, "--device", "cpu"]
    assert service.replica_main(argv, Configuration()) == 2


class _Registry:
    """A ``RegistryLike`` that keeps the records in a dict."""

    def __init__(self):
        self.records = {}

    def register(self, record, ttl_s=10.0, auto_renew=False):
        self.records[record.path] = record

    def unregister(self, path):
        self.records.pop(path, None)

    def close(self):
        pass


def _save_tiny(tmp_path):
    save_checkpoint(LocalFileSystem(), f"{tmp_path}/ckpt", 1,
                    {"params": _tiny()["params"]})
    return f"{tmp_path}/ckpt"


def _greedy_int8(prompt, max_new):
    """A repeated single-device forward of the port over the relaxed
    replica's int8 plane, dequantized (what its matmuls multiply)."""
    from hadoop_tpu_torch.models import decoder
    from hadoop_tpu_torch.serving import weightplane
    m = _tiny()
    q, _ = weightplane.quantize_params(
        m["params"], m["cfg"],
        weightplane.WeightPlaneConfig(tier="relaxed"))
    params = weightplane.dequantize_params(q, m["cfg"])
    seq = list(prompt)
    for _ in range(max_new):
        logits = decoder.forward(params, [seq], m["cfg"], device="cpu")
        seq.append(int(torch.argmax(logits[0, -1])))
    return seq[len(prompt):]


def _longctx_conf(relaxed: bool):
    conf = Configuration()
    conf.set("serving.longctx.enabled", "true")
    conf.set("serving.longctx.min.tokens", "40")
    conf.set("serving.longctx.chips", "2")
    conf.set("serving.kv.host.bytes", str(1 << 22))
    conf.set("serving.kv.block.size", "4")
    conf.set("serving.max.context", "48")
    if relaxed:
        conf.set("serving.parity", "relaxed")
    return conf


def test_longctx_key_attaches_the_plane(tmp_path):
    """``serving.longctx.enabled`` under ``serving.parity=relaxed``: the
    replica attaches the long-context plane, /v1/health carries its
    stats, the registry record advertises it, and a long prompt decodes
    to a repeated single-device forward's tokens over the replica's int8
    plane."""
    ckpt = _save_tiny(tmp_path)
    rep = service.ServingReplica(_longctx_conf(True), name="lc",
                                 checkpoint=ckpt, preset="tiny",
                                 registry=_Registry(), device="cpu")
    rep.start()
    try:
        health = _health(rep.server.port)
        assert health["longctx"]["enabled"] is True
        assert health["longctx"]["chips"] == 2
        assert rep.record.attributes["longctx"] == "1"
        assert rep.record.attributes["longctx_max_tokens"] == \
            str(health["longctx"]["max_tokens"])
        prompt = np.random.default_rng(5).integers(0, 256, 60).tolist()
        toks = rep.engine.submit(prompt, SamplingParams(
            max_new_tokens=4)).wait(120)
        assert toks == _greedy_int8(prompt, 4)
        assert rep.engine.longctx_stats()["requests"] == 1
    finally:
        rep.drain_and_stop(timeout=30)


def test_longctx_key_requires_relaxed_parity(tmp_path):
    """Without ``serving.parity=relaxed`` the key raises the reference's
    ValueError: the CP softmax reassociation is not bitwise."""
    ckpt = _save_tiny(tmp_path)
    with pytest.raises(ValueError, match="relaxed"):
        service.ServingReplica(_longctx_conf(False), name="lc",
                               checkpoint=ckpt, preset="tiny",
                               device="cpu")


@pytest.mark.parametrize("key,value,check", [
    ("serving.speculate.k", "2", lambda r: r.engine.spec_k == 2),
    ("serving.kv.host.bytes", "1048576",
     lambda r: r.engine.kvstore.host is not None
     and r.kv_host_bytes == 1048576),
    ("serving.kv.dfs.enable", "true",
     lambda r: r.engine.kvstore.dfs_enabled and r.role == "mixed"),
    ("serving.role", "prefill",
     lambda r: r.engine.kvstore.dfs_enabled and r.role == "prefill"),
    ("serving.role", "decode",
     lambda r: r.engine.kvstore.dfs_enabled and r.role == "decode"),
])
def test_tier_and_speculation_keys_reach_the_engine(tmp_path, key, value,
                                                    check):
    """The keys of ROADMAP Queue A 3, once refused, now configure the
    engine as the reference's replica does (an explicit role turns the DFS
    tier on, on the checkpoint's filesystem)."""
    save_checkpoint(LocalFileSystem(), f"{tmp_path}/ckpt", 1,
                    {"params": _tiny()["params"]})
    conf = _conf(serving_kv_block_size="4", serving_max_context="48",
                 serving_kv_dfs_dir=f"{tmp_path}/kv")
    conf.set(key, value)
    replica = service.ServingReplica(conf, name="x", preset="tiny",
                                     checkpoint=f"{tmp_path}/ckpt",
                                     device="cpu")
    try:
        assert check(replica)
    finally:
        replica.server.stop()


@pytest.mark.parametrize("preset,keys,check", [
    ("tiny", {"serving.parity": "relaxed"},
     lambda r: r.engine.weight_plane()["parity"] == "relaxed"
     and r.engine.weight_plane()["dtype"] == "int8"
     and r.quantize_seconds >= 0.0),
    ("tiny", {"serving.parity": "relaxed", "serving.weights.group": "32",
              "serving.weights.embed": "true",
              "serving.weights.head": "true"},
     lambda r: r.engine._q_embed and r.engine._q_head
     and r.engine.params["layers"]["wq"]["q"].shape[-1] == 32),
    ("tiny", {"serving.kv.hbm.bytes": "3000000", "serving.max.lanes": "2"},
     lambda r: r.engine.hbm_bytes == 3_000_000 and r.engine.max_batch == 2),
    ("tiny-moe", {"serving.moe.capacity.factor": "2.0",
                  "serving.moe.a2a.codec": "none",
                  "serving.moe.shards": "1"},
     lambda r: r.engine.weight_plane()["experts"] == 4
     and r.engine._moe_cfg.capacity_factor == 2.0
     and r.engine.weight_plane()["a2a_codec"] == "none"
     and r.engine.expert_shards == 1),
], ids=["relaxed", "relaxed-group-embed-head", "hbm-bytes", "moe"])
def test_weight_plane_and_moe_keys_reach_the_engine(tmp_path, preset, keys,
                                                    check):
    """The keys of ROADMAP Queue A 4 and 5, once refused, now configure
    the replica as the reference's does."""
    jcfg = jconfig.get_config(preset)
    cfg = config.get_config(preset)
    jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
    save_checkpoint(LocalFileSystem(), f"{tmp_path}/ckpt", 1, {
        "params": params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                           jparams),
                                    cfg, device="cpu")})
    conf = _conf(serving_kv_block_size="4", serving_max_context="48")
    for key, value in keys.items():
        conf.set(key, value)
    replica = service.ServingReplica(conf, name="x", preset=preset,
                                     checkpoint=f"{tmp_path}/ckpt",
                                     device="cpu")
    try:
        assert check(replica)
    finally:
        replica.server.stop()


def test_relaxed_replica_equals_the_reference_replica(tmp_path):
    """serving.parity=relaxed (int8 group 16, embed and head quantized):
    the port's replica and the reference's on one checkpoint serve the
    same greedy tokens, /v1/health carries the same weight plane, and the
    registry record the reference's weight keys."""
    from hadoop_tpu.fs import LocalFileSystem as JLocalFileSystem
    from hadoop_tpu.parallel.checkpoint import save_checkpoint as jsave
    from hadoop_tpu.registry import RegistryClient, RegistryServer
    from hadoop_tpu.serving.service import ServingReplica as JReplica
    m = _tiny()
    jsave(JLocalFileSystem(), f"{tmp_path}/ckpt", 2,
          {"params": m["jparams"], "opt": {}})
    keys = dict(serving_kv_block_size="4", serving_max_context="48",
                serving_parity="relaxed", serving_weights_group="16",
                serving_weights_embed="true", serving_weights_head="true",
                serving_qos_enabled="false")
    jconf = _conf(JConfiguration, **keys)
    reg_srv = RegistryServer(jconf)
    reg_srv.init(jconf)
    reg_srv.start()
    ref = JReplica(jconf, name="ref", checkpoint=f"file://{tmp_path}/ckpt",
                   preset="tiny", instance="r0")
    reg = RegistryClient(("127.0.0.1", reg_srv.port), jconf)
    port = service.ServingReplica(
        _conf(**keys), name="int8", checkpoint=f"file://{tmp_path}/ckpt",
        preset="tiny", registry=reg, instance="p0", device="cpu")
    ref.start()
    port.start()
    try:
        tokens = {}
        for name, r in (("ref", ref), ("port", port)):
            tokens[name] = [_post(r.server.port, "/v1/generate",
                                  {"tokens": p, "max_new_tokens": n})[1][
                                      "tokens"] for p, n in PROMPTS]
        assert tokens["port"] == tokens["ref"]
        got = _health(port.server.port)["weights"]
        want = _health(ref.server.port)["weights"]
        assert got.pop("quantize_seconds") >= 0.0
        want.pop("quantize_seconds")
        assert got == want and got["dtype"] == "int8"
        (rec,) = reg_srv.list("/services/serving/int8")
        assert rec.attributes["weight_dtype"] == "int8"
        assert int(rec.attributes["weight_bytes"]) == got["weight_bytes"]
        assert float(rec.attributes["quantize_seconds"]) == \
            port.quantize_seconds
    finally:
        port.drain_and_stop(timeout=15)
        ref.drain_and_stop(timeout=15)
        reg_srv.stop()


def test_prefill_role_without_the_dfs_tier_is_refused(tmp_path):
    save_checkpoint(LocalFileSystem(), f"{tmp_path}/ckpt", 1,
                    {"params": _tiny()["params"]})
    conf = _conf(serving_role="prefill", serving_kv_dfs_enable="false")
    with pytest.raises(ValueError, match="DFS KV tier"):
        service.ServingReplica(conf, name="x", preset="tiny",
                               checkpoint=f"{tmp_path}/ckpt", device="cpu")


@pytest.mark.parametrize("argv", [
    ["--checkpoint", "htpu://nn:8020/models/x", "--device", "cpu"],
    ["--checkpoint", "/m", "--bogus", "1"],
])
def test_command_line_exits_2_for_what_it_cannot_do(argv, capsys):
    assert service.replica_main(argv, Configuration()) == 2
    err = capsys.readouterr().err
    assert "ROADMAP Queue A 9" in err or "unknown serve option" in err


def test_no_cuda_and_no_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        service.ServingReplica(Configuration(), name="x", preset="tiny",
                               checkpoint=f"{tmp_path}/none")
