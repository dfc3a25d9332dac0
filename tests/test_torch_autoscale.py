"""The port's autoscaler (``hadoop_tpu_torch/serving/autoscale``) and the
YARN client half it flexes through (``yarn.py``) against the JAX
package's: the same prom parsing and quantiles on the same text, the
same ``ScaleDecision`` sequence from both controllers on the same
scripted snapshots and clock, a scale-in that drains a port replica
through its door, the port's ``ServiceClient`` on a reference
``MiniYARNCluster``, ``autoscaler_service_spec`` through the
reference's ``ServiceSpec.from_json``, and the command line.
"""

import http.client
import json
import math
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.serving import autoscale as jautoscale
from hadoop_tpu.serving.autoscale import controller as jcontroller
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.serving import autoscale, service
from hadoop_tpu_torch.serving.autoscale import controller
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.serving.server import ServingServer

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- signal math

PROM_TEXTS = {
    "reference": """# HELP htpu_x_total things
# TYPE htpu_x_total counter
htpu_x_total{source="a"} 5
htpu_h_bucket{source="a",le="0.01"} 50
htpu_h_bucket{source="a",le="0.1"} 99
htpu_h_bucket{source="a",le="+Inf"} 100
htpu_h_count{source="a"} 100
htpu_gauge 2.5
garbage line that must not crash the parser
""",
    "exemplars": """htpu_time_to_first_token_seconds_bucket{le="0.05"} 3 # {trace_id="ab"} 0.04 1700000000.0
htpu_time_to_first_token_seconds_bucket{le="0.5"} 9 # {trace_id="cd"} 0.3
htpu_time_to_first_token_seconds_bucket{le="+Inf"} 10
htpu_time_to_first_token_seconds_count 10
htpu_qos_shed_total{source="serving.x",tenant_class="gold"} 4
htpu_qos_shed_total{source="serving.y"} 1
bad{unclosed 3
""",
    "empty_window": """htpu_time_to_first_token_seconds_bucket{le="0.1"} 0
htpu_time_to_first_token_seconds_bucket{le="+Inf"} 0
""",
}


def _buckets(fams, name):
    return {math.inf if lab["le"] == "+Inf" else float(lab["le"]): v
            for lab, v in fams.get(name, [])}


@pytest.mark.parametrize("text", sorted(PROM_TEXTS))
def test_parse_prom_and_histogram_p99_equal_the_references(text):
    got = autoscale.parse_prom(PROM_TEXTS[text])
    assert got == jautoscale.parse_prom(PROM_TEXTS[text])
    for name in [n for n in got if n.endswith("_bucket")]:
        b = _buckets(got, name)
        for q in (0.25, 0.5, 0.9, 0.99, 0.995, 1.0):
            assert autoscale.histogram_p99(b, q) == \
                jautoscale.histogram_p99(b, q)
    assert autoscale.histogram_p99({}) is None


def _sample(mod, path="/services/serving/s/r0", role="mixed", ok=True,
            queue=0, active=0, slots=4, backlog=0, cached=0,
            load_seconds=0.0, draining=False):
    return mod.ReplicaSample(path=path, host="127.0.0.1", port=1, role=role,
                             ok=ok, queue_depth=queue, active=active,
                             slots=slots, prefill_backlog=backlog,
                             cached_blocks=cached, load_seconds=load_seconds,
                             draining=draining)


def _snap(mod, samples, **kw):
    return mod.FleetSnapshot(at=kw.pop("at", 0.0),
                             samples=[_sample(mod, **s) for s in samples],
                             **kw)


def test_snapshot_math_equals_the_references():
    rows = [dict(path="/s/d0", active=4, queue=3, load_seconds=2.0),
            dict(path="/s/d1", active=0, ok=False),
            dict(path="/s/d2", active=1, draining=True),
            dict(path="/s/p0", role="prefill", backlog=100),
            dict(path="/s/p1", role="prefill", backlog=50, active=2)]
    snaps = [_snap(m, rows) for m in (autoscale, jautoscale)]
    for role in ("decode", "prefill"):
        assert [s.path for s in snaps[0].pool(role)] == \
            [s.path for s in snaps[1].pool(role)]
        for fn in ("utilization", "mean_queue_depth",
                   "mean_prefill_backlog", "max_load_seconds"):
            assert getattr(snaps[0], fn)(role) == \
                getattr(snaps[1], fn)(role), fn


# ----------------------------------------------------------------- policy

class _Clock:
    """A scripted ``time`` module for both controllers' cooldowns."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return self.now

    def sleep(self, s):
        self.now += s


BASE = {"serving.autoscale.breach.polls": "2",
        "serving.autoscale.idle.polls": "2",
        "serving.autoscale.cooldown": "0s",
        "serving.autoscale.ttft.p99.slo": "1s"}

HOT = ([dict(queue=9)], dict(ttft_p99_s=5.0, ttft_samples=10))
CALM = ([dict()], {})
QUIET3 = ([dict(path="/s/r0", active=1, cached=50),
           dict(path="/s/r1", active=0, cached=40),
           dict(path="/s/r2", active=0, cached=3)], {})

# name -> (conf overrides, [(seconds to advance, role, rows, snapshot kw)])
SCENARIOS = {
    "breaches_then_cooldown": (
        {"serving.autoscale.cooldown": "60s"},
        [(1, "decode") + HOT] * 4 + [(61, "decode") + HOT] * 3),
    "breach_resets_on_quiet": (
        {}, [(1, "decode") + HOT, (1, "decode") + CALM,
             (1, "decode") + HOT, (1, "decode") + HOT]),
    "shed_grows": (
        {"serving.autoscale.breach.polls": "1"},
        [(1, "decode", [dict()], dict(shed_delta=3))]),
    "cold_start_lead": (
        {"serving.autoscale.breach.polls": "1",
         "serving.autoscale.util.high": "0.85"},
        [(1, "decode", [dict(path=f"/s/r{i}", active=3, load_seconds=0.1)
                        for i in range(2)], {}),
         (1, "decode", [dict(path=f"/s/r{i}", active=3, load_seconds=30.0)
                        for i in range(2)], {})]),
    "scale_in_victim": (
        {}, [(1, "decode") + QUIET3] * 3),
    "never_below_min": (
        {"serving.autoscale.min": "1", "serving.autoscale.idle.polls": "1"},
        [(1, "decode") + CALM] * 2),
    "min_floor_restored": (
        {"serving.autoscale.min": "2", "serving.autoscale.cooldown": "5s"},
        [(1, "decode") + CALM] * 3 + [(6, "decode") + CALM]),
    "only_min_healthy": (
        {"serving.autoscale.idle.polls": "1"},
        [(1, "decode", [dict(path="/s/ok"), dict(path="/s/wedged",
                                                  ok=False)], {})]),
    "prefill_pool": (
        {"serving.autoscale.breach.polls": "1",
         "serving.autoscale.backlog.high": "64"},
        [(1, role, [dict(path="/s/d0"),
                    dict(path="/s/p0", role="prefill", backlog=500)], {})
         for role in ("prefill", "decode")]
        + [(1, "prefill", [dict(backlog=500)], {})]),
    "ttft_quiet_fraction": (
        {"serving.autoscale.idle.polls": "1"},
        [(1, "decode", [dict(path="/s/a"), dict(path="/s/b")],
          dict(ttft_p99_s=0.6)),
         (1, "decode", [dict(path="/s/a"), dict(path="/s/b")],
          dict(ttft_p99_s=0.2))]),
    "grow_capped_at_max": (
        {"serving.autoscale.breach.polls": "1", "serving.autoscale.max": "2"},
        [(1, "decode", [dict(path=f"/s/r{i}", queue=9) for i in range(n)],
          {}) for n in (1, 2, 2)]),
}


def _decisions(mod, cmod, clock, monkeypatch, overrides, steps, conf_cls):
    monkeypatch.setattr(cmod, "time", clock)
    conf = conf_cls(load_defaults=False)
    for k, v in {**BASE, **overrides}.items():
        conf.set(k, v)
    # a dead registry address: these replays drive _decide directly
    scaler = cmod.Autoscaler(conf, ("127.0.0.1", 1), "svc")
    out = []
    try:
        for advance, role, rows, kw in steps:
            clock.now += advance
            d = scaler._decide(role, _snap(mod, rows, at=clock.now, **kw))
            out.append(None if d is None else (
                d.at, d.role, d.action, d.current, d.target, d.reason,
                d.victim))
    finally:
        scaler.stop()
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_controllers_make_the_same_decisions(scenario, monkeypatch):
    """Both controllers, fed the same snapshots on the same clock, give
    the same ``ScaleDecision`` sequence, reasons and victims included."""
    overrides, steps = SCENARIOS[scenario]
    got = _decisions(autoscale, controller, _Clock(), monkeypatch,
                     overrides, steps, Configuration)
    want = _decisions(jautoscale, jcontroller, _Clock(), monkeypatch,
                      overrides, steps, JConfiguration)
    assert got == want
    assert any(d is not None for d in got) or scenario in (
        "never_below_min", "only_min_healthy")


# ---------------------------------------------- scale-in through a door

@pytest.fixture(scope="module")
def tiny():
    jcfg = jconfig.get_config("tiny")
    jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = config.get_config("tiny")
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             cfg, device="cpu"), cfg


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode())
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_scale_in_drains_a_port_replica_through_its_door(tiny):
    """poll() on the reference's registry server: a shrink decision on
    the cache-cheapest port door, ``POST /v1/admin/drain`` to it, its
    health watched until drained, then the actuator's retire; the other
    replica keeps serving and a pending drain holds the pool."""
    from hadoop_tpu.registry import RegistryServer
    from hadoop_tpu_torch.registry import (HEARTBEAT_ATTR, RegistryClient,
                                           ServiceRecord, replica_path)
    params, cfg = tiny
    jconf = JConfiguration(load_defaults=False)
    reg_srv = RegistryServer(jconf)
    reg_srv.init(jconf)
    reg_srv.start()
    servers, engines, retired = [], [], []

    class _Act(autoscale.FleetActuator):
        def scale_out(self, role, target):
            raise AssertionError("a quiet fleet never grows")

        def retire(self, sample, target):
            retired.append((sample.path, target))

    rc = scaler = None
    try:
        for _ in range(2):
            eng = DecodeEngine(params, cfg, device="cpu", max_batch=2,
                               block_size=4, max_context=32)
            srv = ServingServer(eng, Configuration())
            eng.start()
            srv.start()
            engines.append(eng)
            servers.append(srv)
        reg_addr = ("127.0.0.1", reg_srv.port)
        rc = RegistryClient(reg_addr, Configuration())
        for i, srv in enumerate(servers):
            rc.register(ServiceRecord(
                replica_path("shrinkme", f"r{i}"),
                {"http": f"127.0.0.1:{srv.port}"},
                {"state": "serving", HEARTBEAT_ATTR: f"{time.time():.3f}"}),
                ttl_s=3600.0, auto_renew=False)
        # a prefix on r0: the victim (fewest cached blocks) is r1
        engines[0].generate([[5, 9, 2, 7, 1, 8, 3, 6, 1]],
                            SamplingParams(max_new_tokens=2))
        conf = Configuration()
        for k, v in (("serving.autoscale.idle.polls", "1"),
                     ("serving.autoscale.cooldown", "0s"),
                     ("serving.autoscale.drain.timeout", "30s"),
                     ("serving.registry.record.ttl", "3600s")):
            conf.set(k, v)
        scaler = autoscale.Autoscaler(conf, reg_addr, "shrinkme",
                                      actuator=_Act())
        decisions = scaler.poll()
        assert [d.action for d in decisions] == ["shrink"]
        assert decisions[0].victim == replica_path("shrinkme", "r1")
        assert scaler.last_snapshot.samples[0].slots > 0
        deadline = time.monotonic() + 30
        while not retired and time.monotonic() < deadline:
            time.sleep(0.05)
        assert retired == [(replica_path("shrinkme", "r1"), 1)]
        assert _post(servers[1].port, "/v1/generate",
                     {"tokens": [1]})[0] == 503
        assert _post(servers[0].port, "/v1/generate",
                     {"tokens": [1, 2], "max_new_tokens": 2})[0] == 200
        assert scaler.poll() == []
        st = scaler.status()
        assert st["pools"]["decode"]["live"] == 1
        assert st["decisions"][-1]["victim"] == replica_path("shrinkme",
                                                             "r1")
    finally:
        if scaler is not None:
            scaler.stop()
        if rc is not None:
            rc.close()
        for srv in servers:
            srv.stop()
        for eng in engines:
            eng.stop()
        reg_srv.stop()


# ------------------------------------------------------ YARN client half

def _wait(fn, timeout=40.0, interval=0.25):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(interval)
    raise AssertionError("condition not reached")


def test_service_client_flexes_a_live_yarn_service():
    """The reference's ``ServiceClient`` submits a one-component service
    to a ``MiniYARNCluster``; the port's ``ServiceClient`` reads the same
    status, flexes it up and down, and the port's ``YarnServiceActuator``
    flexes it as the controller would."""
    from hadoop_tpu.testing.minicluster import MiniYARNCluster
    from hadoop_tpu.yarn.services import Component as JComponent
    from hadoop_tpu.yarn.services import ServiceClient as JServiceClient
    from hadoop_tpu.yarn.services import ServiceSpec as JServiceSpec
    from hadoop_tpu_torch.yarn import AppState, ApplicationId, ServiceClient
    with MiniYARNCluster(num_nodes=1) as c:
        jsc = JServiceClient(c.rm_addr, JConfiguration(other=c.conf))
        app = jsc.submit(JServiceSpec("fleet", [
            JComponent("replica", 1, ["bash", "-c", "sleep 300"])]))
        app_id = ApplicationId.parse(str(app))
        assert str(app_id) == str(app)
        conf = Configuration()
        for k, v in c.conf.to_dict().items():
            conf.set(k, v)
        sc = ServiceClient(c.rm_addr, conf)
        act = None
        try:
            report = sc.yc.application_report(app_id)
            assert report.to_wire()["id"] == app.to_wire()
            assert report.state not in AppState.TERMINAL
            _wait(lambda: sc.status(app_id)["components"]["replica"]
                  ["running"] == 1)
            st = sc.status(app_id)
            assert st == jsc.status(app) or \
                st["components"] == jsc.status(app)["components"]
            assert sc.flex(app_id, "replica", 2)
            _wait(lambda: jsc.status(app)["components"]["replica"]
                  ["running"] == 2)
            act = controller.YarnServiceActuator(c.rm_addr, app_id,
                                                 conf=conf)
            act.retire(_sample(autoscale, role="decode"), 1)
            _wait(lambda: sc.status(app_id)["components"]["replica"]
                  ["running"] == 1)
            assert not sc.flex(app_id, "nope", 2)
        finally:
            if act is not None:
                act.client.close()
            sc.close()
            jsc.stop(app)
            jsc.close()


@pytest.mark.parametrize("kw", [
    {},
    {"resource": (512, 2, 0), "extra_args": ["--rm", "127.0.0.1:8032",
                                             "--app", "application_1_0002",
                                             "-D", "serving.autoscale.max=4"]},
], ids=["default", "flex"])
def test_autoscaler_spec_is_the_references_but_the_module(kw):
    from hadoop_tpu.serving.service import autoscaler_service_spec as jspec
    from hadoop_tpu.yarn.records import Resource as JResource
    from hadoop_tpu.yarn.services import ServiceSpec as JServiceSpec
    from hadoop_tpu_torch.yarn import Resource
    res = kw.get("resource")
    extra = kw.get("extra_args")
    got = service.autoscaler_service_spec(
        "llm-as", registry_addr="127.0.0.1:7777", service="llm",
        resource=Resource(*res) if res else None, extra_args=extra)
    want = jspec("llm-as", registry_addr="127.0.0.1:7777", service="llm",
                 resource=JResource(*res) if res else None, extra_args=extra)
    read = JServiceSpec.from_json(got.to_json())
    assert json.loads(read.to_json()) == json.loads(
        want.to_json().replace("hadoop_tpu.serving.autoscale",
                               "hadoop_tpu_torch.serving.autoscale"))
    (comp,) = read.components
    assert comp.name == "autoscaler" and comp.number_of_containers == 1
    assert comp.restart_policy == "ALWAYS"
    assert (comp.resource.memory_mb, comp.resource.vcores) == \
        ((512, 2) if res else (256, 1))
    assert comp.launch_command[1:3] == [
        "-m", "hadoop_tpu_torch.serving.autoscale"]


# ------------------------------------------------------ the command line

@pytest.mark.parametrize("argv", [
    [],
    ["--service", "x"],
    ["--registry", "127.0.0.1:1", "--bogus", "1"],
    ["--registry", "127.0.0.1:1", "--rm", "127.0.0.1:2", "--app", "bad"],
    ["--registry", "nohostport"],
    ["--registry", "127.0.0.1:1", "--http-port", "x"],
], ids=["none", "no-registry", "unknown", "bad-app", "bad-registry",
        "bad-port"])
def test_command_line_exits_2_on_usage_errors(argv, capsys):
    from hadoop_tpu_torch.serving.autoscale.__main__ import autoscaler_main
    assert autoscaler_main(argv, Configuration()) == 2
    assert capsys.readouterr().err


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_command_line_serves_its_status_and_stops_on_sigterm():
    """``python -m hadoop_tpu_torch.serving.autoscale`` against the
    reference's registry server: ``/ws/v1/autoscaler`` answers with the
    ``-D`` keys applied, the chassis answers beside it, SIGTERM exits
    0."""
    from hadoop_tpu.registry import RegistryServer
    jconf = JConfiguration(load_defaults=False)
    reg_srv = RegistryServer(jconf)
    reg_srv.init(jconf)
    reg_srv.start()
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "hadoop_tpu_torch.serving.autoscale",
         "--registry", f"127.0.0.1:{reg_srv.port}", "--service", "llm",
         "--http-port", str(port), "-D", "serving.autoscale.interval=0.2s",
         "-D", "serving.autoscale.max=5"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stderr=subprocess.PIPE, text=True)
    try:
        def status():
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("GET", "/ws/v1/autoscaler")
                resp = conn.getresponse()
                body = resp.read()
                conn.close()
                return json.loads(body) if resp.status == 200 else None
            except OSError:
                return None
        st = _wait(status, timeout=60.0)
        assert st["service"] == "llm" and st["interval_s"] == 0.2
        assert st["pools"]["decode"]["max"] == 5
        assert st["pools"]["decode"]["live"] == 0
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        conn.request("GET", "/health")
        assert json.loads(conn.getresponse().read())["daemon"] == \
            "autoscaler"
        conn.close()
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        err = proc.stderr.read()
        proc.stderr.close()
        reg_srv.stop()
    assert rc == 0, err
