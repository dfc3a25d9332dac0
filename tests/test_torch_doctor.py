"""The port's fleet doctor (``hadoop_tpu_torch.obs.{detect,assemble,
doctor,slo}``) against the JAX package's.

- ``median``, ``mad_outliers``, ``SlowNodeDetector``, ``RollingStat``,
  ``assemble_tree``, ``parse_endpoint_list`` and ``FleetTraceStore`` give
  the reference's output on the reference's own cases
  (``tests/test_obs.py``) and on seeded random ones.
- Both doctors poll one set of scripted endpoints: a NameNode roster,
  four DataNodes' ``/ws/v1/peers``, four replicas' ``/prom`` (decode
  step, TTFT and the class-labeled SLO families) and three trainer ranks'
  ``/ws/v1/trainer`` found through the port's registry, and a static
  daemon that is no trainer; poll for poll their ``/ws/v1/fleet/doctor``
  reports (timestamps aside), ``/ws/v1/fleet/slo`` and assembled traces
  are equal, with a slow DataNode, replica and rank flagged.
- The port's doctor pushes a slow DataNode to the reference's
  ``MiniDFSCluster`` NameNode, whose placement then avoids it.
- The port's autoscaler prefers the victim the port's doctor flagged;
  the elastic controller, polling the port's doctor over HTTP
  (``doctor_http_poll``), evicts the rank it flags.
- ROADMAP C 18: with JAX absent the port's doctor polls replicas and its
  router imports, where the reference's replica poll and router raise
  ``ImportError``.
"""

import json
import random
import subprocess
import sys
import textwrap

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.obs import assemble as jassemble
from hadoop_tpu.obs import detect as jdetect
from hadoop_tpu.obs import doctor as jdoctor
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.http import http_get
from hadoop_tpu_torch.http.server import HttpServer
from hadoop_tpu_torch.obs import assemble, detect, doctor
from hadoop_tpu_torch.registry import (RegistryClient, RegistryServer,
                                       ServiceRecord)

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


# ------------------------------------------------------- detection math

def test_median_and_mad_outliers_on_the_references_cases():
    for xs in ([3.0, 1.0, 2.0], [1.0, 2.0, 3.0, 4.0], [], [5.0]):
        assert detect.median(xs) == jdetect.median(xs)
    cases = [
        ({"a": 0.010, "b": 0.012, "c": 0.011, "d": 0.150}, {}),
        ({"a": 0.01, "b": 9.9}, dict(min_peers=3)),
        ({f"n{i}": 0.0010 + i * 1e-6 for i in range(5)},
         dict(abs_floor=0.002)),
        ({"a": 1.000, "b": 1.000, "c": 1.000, "d": 1.100}, dict(ratio=1.5)),
    ]
    for values, kw in cases:
        assert detect.mad_outliers(values, **kw) == \
            jdetect.mad_outliers(values, **kw)
    assert list(detect.mad_outliers(cases[0][0])) == ["d"]


@pytest.mark.parametrize("seed", range(6))
def test_mad_outliers_on_random_fleets(seed):
    rng = random.Random(seed)
    for _ in range(40):
        n = rng.randrange(1, 9)
        values = {f"n{i}": rng.lognormvariate(-4, 1.2) for i in range(n)}
        kw = dict(min_peers=rng.choice([1, 3]), mad_k=rng.choice([1.0, 3.0]),
                  ratio=rng.choice([1.0, 1.5]),
                  abs_floor=rng.choice([0.0, 0.01]))
        assert detect.mad_outliers(values, **kw) == \
            jdetect.mad_outliers(values, **kw)


def test_detector_hysteresis_equals_the_reference():
    slow = {"a": 0.01, "b": 0.011, "c": 0.012, "sick": 0.2}
    clean = {"a": 0.01, "b": 0.011, "c": 0.012, "sick": 0.011}
    got = detect.SlowNodeDetector(history=5, min_windows=3, min_peers=3)
    want = jdetect.SlowNodeDetector(history=5, min_windows=3, min_peers=3)
    for window in [slow] * 3 + [clean] * 5 + [slow, clean, slow, slow]:
        assert got.observe(window) == want.observe(window)
        assert got.report() == want.report()
    got.reset()
    want.reset()
    assert got.report() == want.report() == {}


def test_rolling_stat_equals_the_reference():
    got, want = detect.RollingStat(window=4), jdetect.RollingStat(window=4)
    assert got.summary() is want.summary() is None
    for v in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 0.5):
        got.record(v)
        want.record(v)
        assert got.summary() == want.summary()


# ------------------------------------------------------- tree assembly

def _span(tid, sid, parent, start, end, name, daemon="d"):
    return {"trace_id": tid, "span_id": sid, "parent_id": parent,
            "start": start, "end": end, "name": name, "daemon": daemon}


def test_assemble_tree_equals_the_reference():
    spans = [_span(7, 1, None, 0.0, 1.0, "root", "client"),
             _span(7, 2, 1, 0.1, 0.9, "nn.op", "nn"),
             _span(7, 3, 2, 0.2, 0.8, "dn.read", "dn"),
             _span(7, 4, 99, 0.3, 0.4, "orphan", "gone"),
             _span(7, 5, 1, 0.05, None, "open", "nn")]
    got = assemble.assemble_tree(7, [dict(s) for s in spans])
    assert got == jassemble.assemble_tree(7, [dict(s) for s in spans])
    assert got["roots"] == 2 and got["critical_path"][0]["daemon"] == "dn"


@pytest.mark.parametrize("seed", range(4))
def test_assemble_tree_on_random_forests(seed):
    rng = random.Random(seed)
    spans = []
    for sid in range(1, 40):
        parent = rng.choice([None, 999] + list(range(1, sid)))
        start = rng.random()
        end = None if rng.random() < 0.1 else start + rng.random()
        spans.append(_span(3, sid, parent, start, end, f"s{sid}",
                           rng.choice("abc")))
    assert assemble.assemble_tree(3, [dict(s) for s in spans]) == \
        jassemble.assemble_tree(3, [dict(s) for s in spans])


def test_parse_endpoint_list_equals_the_reference():
    for raw in ("nn=1.2.3.4:80, :9090 ,dn=x:1", "", "a=h:1", "h:2,,"):
        assert assemble.parse_endpoint_list(raw) == \
            jassemble.parse_endpoint_list(raw)


def _fake_trace_server(spans, slow=()):
    srv = HttpServer(Configuration(load_defaults=False), daemon_name="f")
    srv.add_handler("/ws/v1/traces",
                    lambda q, b: (200, {"spans": list(spans)}))
    srv.add_handler("/ws/v1/traces/slow",
                    lambda q, b: (200, {"traces": list(slow)}))
    srv.start()
    return srv


def _strip_times(obj):
    """``obj`` without its wall-clock fields."""
    if isinstance(obj, dict):
        return {k: _strip_times(v) for k, v in obj.items()
                if k not in ("generated_at", "last_scrape", "last_seen")}
    if isinstance(obj, list):
        return [_strip_times(v) for v in obj]
    return obj


def test_trace_store_equals_the_reference_under_churn():
    """Merge, a daemon dying mid-scrape (its spans kept, its row marked),
    discovery dropping it (its row gone), LRU bounds and the targeted
    fetch of a flight-recorder trace, store for store."""
    a = _fake_trace_server([_span(5, 1, None, 0.0, 1.0, "client.op")] +
                           [_span(t, t * 10, None, 0.0, 1.0, f"op{t}")
                            for t in (20, 21, 22, 23)])
    b = _fake_trace_server(
        [_span(5, 2, 1, 0.2, 0.8, "dn.op")],
        slow=[{"trace_id": 11, "spans": [
            _span(11, 1, None, 0.0, 2.0, "slow.root")]}])
    stores = []
    for conf_cls, mod in ((Configuration, assemble), (JConfiguration,
                                                      jassemble)):
        conf = conf_cls(load_defaults=False)
        conf.set("obs.doctor.max-traces", "4")
        stores.append((mod, mod.FleetTraceStore(conf)))
    try:
        steps = []
        for mod, store in stores:
            ea = mod.Endpoint("a", "127.0.0.1", a.port, "daemon")
            eb = mod.Endpoint("b", "127.0.0.1", b.port, "datanode")
            out = []
            store.scrape([ea, eb])
            out.append((store.trace_ids(), store.assemble(5),
                        _strip_times(store.status())))
            out.append(store.assemble(11))
            steps.append(out)
        assert steps[0] == steps[1]
        b.stop()
        for mod, store in stores:
            ea = mod.Endpoint("a", "127.0.0.1", a.port, "daemon")
            eb = mod.Endpoint("b", "127.0.0.1", b.port, "datanode")
            store.scrape([ea, eb])
        st = [_strip_times(s.status()) for _, s in stores]
        assert [s[f"127.0.0.1:{b.port}"]["ok"] for s in st] == [False, False]
        for s in st:
            for row in s.values():
                row.pop("error")         # the OS's text for the refusal
        assert st[0] == st[1]
        for mod, store in stores:
            store.scrape([mod.Endpoint("a", "127.0.0.1", a.port)])
        assert [_strip_times(s.status()) for _, s in stores][0] == \
            [_strip_times(s.status()) for _, s in stores][1]
        assert stores[0][1].assemble(5) == stores[1][1].assemble(5)
        assert stores[0][1].trace_ids() == stores[1][1].trace_ids()
    finally:
        a.stop()


# ------------------------------------------- both doctors, one script

_DNS = ["dn-a", "dn-b", "dn-c", "dn-d"]
_REPLICAS = ["r0", "r1", "r2", "r3"]
_RANKS = ["rank-0", "rank-1", "rank-2"]


class _Fleet:
    """Scripted daemons: each answers from ``self.state`` (set per
    poll), so both doctors scrape the same bodies."""

    def __init__(self, reg_client):
        self.state = {"poll": 0}
        self.servers = {}
        self.nn = self._server("nn", {
            "/ws/v1/datanodes": lambda q, b: (200, {"datanodes": [
                {"uuid": u, "host": "127.0.0.1", "state": "live",
                 "info_port": self.servers[u].port} for u in _DNS] + [
                {"uuid": "dn-dead", "host": "127.0.0.1", "state": "dead",
                 "info_port": 1}]})})
        for u in _DNS:
            self._server(u, {"/ws/v1/peers": self._peers(u)})
        for r in _REPLICAS:
            srv = self._server(r, {"/prom": self._prom(r)})
            reg_client.register(ServiceRecord(
                f"/services/serving/svc/{r}",
                {"http": f"127.0.0.1:{srv.port}"}, {"state": "serving"}),
                ttl_s=600, auto_renew=False)
        for k in _RANKS:
            srv = self._server(k, {"/ws/v1/trainer": self._trainer(k)})
            reg_client.register(ServiceRecord(
                f"/trainer-jobs/job/{k}", {"http": f"127.0.0.1:{srv.port}"},
                {}), ttl_s=600, auto_renew=False)
        self.static = self._server("static", {})

    def _server(self, name, handlers):
        srv = HttpServer(Configuration(load_defaults=False),
                         daemon_name=name)
        trace = 1000 + len(self.servers)
        srv.add_handler("/ws/v1/traces", lambda q, b, t=trace, n=name: (
            200, {"spans": [_span(t, 1, None, 0.0, 1.0, f"{n}.root"),
                            _span(77, t, 1, 0.1, 0.2, f"{n}.child")]}))
        srv.add_handler("/ws/v1/traces/slow",
                        lambda q, b: (200, {"traces": []}))
        for path, fn in handlers.items():
            srv.add_handler(path, fn)
        srv.start()
        self.servers[name] = srv
        return srv

    def _peers(self, uuid):
        def fn(q, b):
            p = self.state["poll"]
            peers = {}
            for other in _DNS:
                if other != uuid:
                    mean = 0.250 if other == "dn-c" else 0.005 + 0.001 * p
                    peers[other] = {"n": 8, "mean": mean, "median": mean}
            own = {"n": 4, "mean": 0.002 * (1 + _DNS.index(uuid))}
            return 200, {"node": uuid, "peers": peers,
                         "self": {"read": own, "write": None}}
        return fn

    def _prom(self, name):
        def fn(q, b):
            p = self.state["poll"] + 1
            slow = name == "r2"
            step = (0.2 if slow else 0.01) * 10 * p
            lines = [
                f"htpu_decode_step_seconds_sum {step}",
                f"htpu_decode_step_seconds_count {10 * p}",
                f"htpu_time_to_first_token_seconds_sum {0.05 * p}",
                f"htpu_time_to_first_token_seconds_count {p}"]
            for cls in ("p0", "p1"):
                ok = 20 * p
                failed = (30 * p) if (cls == "p1" and name == "r1") else 0
                for le, frac in (("0.1", 0.5), ("0.5", 0.9), ("+Inf", 1.0)):
                    lines.append(f'htpu_slo_ttft_seconds_bucket{{class='
                                 f'"{cls}",le="{le}"}} {ok * frac}')
                lines.append(f'htpu_slo_ttft_seconds_count{{class="{cls}"}}'
                             f' {ok}')
                for le, frac in (("0.02", 0.7), ("+Inf", 1.0)):
                    lines.append(f'htpu_slo_token_seconds_bucket{{class='
                                 f'"{cls}",le="{le}"}} {ok * 10 * frac}')
                lines.append(f'htpu_slo_token_seconds_count{{class='
                             f'"{cls}"}} {ok * 10}')
                for outcome, v in (("ok", ok), ("shed", p),
                                   ("failed", failed)):
                    lines.append(f'htpu_slo_requests_total{{class="{cls}",'
                                 f'outcome="{outcome}"}} {v}')
            return 200, "\n".join(lines) + "\n"
        return fn

    def _trainer(self, rank):
        def fn(q, b):
            p = self.state["poll"] + 1
            wall = 2.0 if rank == "rank-1" else 0.5
            return 200, {"rank": _RANKS.index(rank), "job": "job",
                         "steps": 4 * p,
                         "step_wall": {"sum": wall * 4 * p, "count": 4 * p}}
        return fn

    def stop(self):
        for srv in self.servers.values():
            srv.stop()


def _doctor_conf(conf_cls, fleet, reg_port):
    conf = conf_cls(load_defaults=False)
    for k, v in {"obs.doctor.namenode.http":
                 f"127.0.0.1:{fleet.nn.port}",
                 "obs.doctor.registry": f"127.0.0.1:{reg_port}",
                 "obs.doctor.endpoints":
                     f"static=127.0.0.1:{fleet.static.port}",
                 "obs.doctor.push.namenode": "false",
                 "obs.doctor.interval": "3600",
                 "obs.doctor.slow.floor.ms": "1",
                 "obs.slo.window.fast": "2",
                 "obs.slo.burn.min-windows": "2"}.items():
        conf.set(k, v)
    return conf


@pytest.fixture
def registry_server():
    conf = Configuration(load_defaults=False)
    srv = RegistryServer(conf)
    srv.init(conf)
    srv.start()
    client = RegistryClient(("127.0.0.1", srv.port), conf)
    yield srv, client
    client.close()
    srv.stop()


def _get(port, path):
    return json.loads(http_get("127.0.0.1", port, path, 10.0))


def test_both_doctors_report_alike_on_one_scripted_fleet(registry_server):
    srv, client = registry_server
    fleet = _Fleet(client)
    docs = []
    try:
        for conf_cls, mod in ((Configuration, doctor),
                              (JConfiguration, jdoctor)):
            conf = _doctor_conf(conf_cls, fleet, srv.port)
            d = mod.FleetDoctor(conf)
            d.init(conf)
            d.start()
            docs.append(d)
        for poll in range(4):
            fleet.state["poll"] = poll
            reports = [_strip_times(d.poll_once()) for d in docs]
            assert reports[0] == reports[1], poll
        rep = reports[0]
        assert list(rep["datanodes"]["flagged"]) == ["dn-c"]
        assert list(rep["replicas"]["flagged"]) == \
            ["/services/serving/svc/r2"]
        assert list(rep["trainers"]["flagged"]) == ["/trainer-jobs/job/rank-1"]
        assert len(rep["trainers"]["ranks"]) == 3
        assert rep["slo"]["classes"]["p1"]["burning"] is True
        assert rep["slo"]["classes"]["p0"]["burning"] is False
        # the doors: the report, the scoreboard, the traces
        for path in ("/ws/v1/fleet/doctor", "/ws/v1/fleet/slo",
                     "/ws/v1/fleet/traces", "/ws/v1/fleet/traces/77",
                     f"/ws/v1/fleet/traces/{77:016x}"):
            got, want = (_strip_times(_get(d.port, path)) for d in docs)
            assert got == want, path
        tree = _get(docs[0].port, "/ws/v1/fleet/traces/77")
        assert tree["num_spans"] == len(fleet.servers)
        for d in docs:
            for bad, status in (("zzz!", "400"), ("123456789", "404")):
                with pytest.raises(IOError, match=status):
                    http_get("127.0.0.1", d.port,
                             f"/ws/v1/fleet/traces/{bad}", 10.0)
        assert docs[0].sick_replicas() == docs[1].sick_replicas() == \
            ["/services/serving/svc/r2"]
    finally:
        for d in docs:
            d.stop()
        fleet.stop()


def test_port_doctor_pushes_a_slow_datanode_to_the_reference_namenode(
        tmp_path):
    """The reference's acceptance path (``tests/test_obs.py``) with the
    port's doctor: injected pipeline latencies on two reporters flag the
    third DataNode within three polls, and the NameNode's placement then
    avoids it."""
    from hadoop_tpu.testing.minicluster import MiniDFSCluster, fast_conf
    conf = fast_conf()
    conf.set("dfs.replication", "2")
    conf.set("dfs.client.read.shortcircuit", "false")
    with MiniDFSCluster(num_datanodes=3, conf=conf,
                        base_dir=str(tmp_path)) as cluster:
        cluster.wait_active()
        dconf = Configuration(load_defaults=False)
        dconf.set("obs.doctor.namenode.http",
                  f"127.0.0.1:{cluster.namenode.http.port}")
        dconf.set("dfs.namenode.rpc-address",
                  f"127.0.0.1:{cluster.namenode.port}")
        dconf.set("obs.doctor.slow.floor.ms", "50")
        dconf.set("obs.doctor.interval", "3600")
        doc = doctor.FleetDoctor(dconf)
        doc.init(dconf)
        doc.start()
        try:
            uuids = [dn.uuid for dn in cluster.datanodes]
            sick = uuids[2]
            for reporter in (0, 1):
                tracker = cluster.datanodes[reporter].xceiver.peer_tracker
                other = uuids[1 - reporter]
                for _ in range(16):
                    tracker.record(sick, 0.250)
                    tracker.record(other, 0.005)
            for _ in range(3):
                report = doc.poll_once()
            assert list(report["datanodes"]["flagged"]) == [sick]
            dm = cluster.namenode.fsn.bm.dn_manager
            assert sick in dm.slow_node_uuids()
            for _ in range(8):
                assert sick not in [t.uuid for t in
                                    dm.choose_targets(2, set())]
            js = _get(doc.port, "/ws/v1/fleet/doctor")
            assert list(js["datanodes"]["flagged"]) == [sick]
        finally:
            doc.stop()


def test_port_autoscaler_prefers_the_victim_the_port_doctor_flagged(
        registry_server):
    from hadoop_tpu_torch.serving.autoscale.controller import Autoscaler
    from hadoop_tpu_torch.serving.autoscale.signals import ReplicaSample
    srv, client = registry_server
    fleet = _Fleet(client)
    doc = scaler = None
    try:
        conf = _doctor_conf(Configuration, fleet, srv.port)
        doc = doctor.FleetDoctor(conf)
        doc.init(conf)
        doc.start()
        for poll in range(3):
            fleet.state["poll"] = poll
            doc.poll_once()
        sconf = Configuration(load_defaults=False)
        sconf.set("serving.autoscale.doctor", f"127.0.0.1:{doc.port}")
        scaler = Autoscaler(sconf, ("127.0.0.1", srv.port), "svc")
        scaler._refresh_sick()
        assert scaler._sick == {"/services/serving/svc/r2"}
        busy_sick = ReplicaSample(path="/services/serving/svc/r2", host="h",
                                  port=1, ok=True, active=3, queue_depth=2,
                                  cached_blocks=9)
        idle = ReplicaSample(path="/services/serving/svc/r0", host="h",
                             port=2, ok=True)
        assert scaler._pick_victim([idle, busy_sick]) is busy_sick
        assert scaler._slo_burn["p1"]["burning"] is True
    finally:
        if scaler is not None:
            scaler.reg.close()
        if doc is not None:
            doc.stop()
        fleet.stop()


class _FakeTrainer:
    def __init__(self, plan, batch):
        self.plan, self.batch, self.step = plan, batch, 0
        self.saves, self.applied = [], []

    def save(self, wait=None):
        self.saves.append(wait)

    def apply_plan(self, plan):
        self.applied.append(plan)
        self.plan = plan
        return True


def test_elastic_controller_evicts_the_rank_the_port_doctor_flagged(
        registry_server):
    """``doctor_http_poll`` reads the port's doctor's ``trainers``
    section; with the evict threshold at 3 flagged polls the controller
    decides to evict the slow rank. The roster is keyed by endpoint
    (host:port) and the flagged ranks by registry path, in both doctors
    (ROADMAP C 19): the healthy count then includes the flagged rank, so
    the shrunken plan keeps dp 3."""
    from hadoop_tpu_torch.parallel import elastic
    from hadoop_tpu_torch.parallel.elastic.controller import (
        ElasticController, doctor_http_poll)
    from hadoop_tpu_torch.parallel.mesh import MeshPlan
    srv, client = registry_server
    fleet = _Fleet(client)
    doc = None
    try:
        conf = _doctor_conf(Configuration, fleet, srv.port)
        doc = doctor.FleetDoctor(conf)
        doc.init(conf)
        doc.start()
        trainer = _FakeTrainer(MeshPlan(dp=3), batch=6)
        ctl = ElasticController(
            trainer, elastic.ElasticConfig(
                enabled=True, poll_steps=1, min_dp=1, demote_windows=2,
                evict_windows=3, dead_windows=2, cooldown_polls=0),
            poll_fn=doctor_http_poll("127.0.0.1", doc.port))
        decided = []
        for poll in range(6):
            fleet.state["poll"] = poll
            doc.poll_once()
            decided.append(ctl.on_step(poll + 1))
            if decided[-1]:
                break
        assert decided[-1] is True
        (ev,) = [e for e in ctl.events if e["decision"] == "evict"]
        assert ev["ranks"] == ["/trainer-jobs/job/rank-1"]
        assert ev["healthy"] == 3 and ev["plan_to"]["dp"] == 3
        assert [e["decision"] for e in ctl.events][:1] == ["demote"]
    finally:
        if doc is not None:
            doc.stop()
        fleet.stop()


_NO_JAX = textwrap.dedent("""
    import json, sys
    sys.modules["jax"] = None
    sys.modules["jaxlib"] = None
    from hadoop_tpu_torch.conf import Configuration
    from hadoop_tpu_torch.http.server import HttpServer
    from hadoop_tpu_torch.obs.doctor import FleetDoctor
    from hadoop_tpu_torch.registry import (RegistryClient, RegistryServer,
                                           ServiceRecord)
    import hadoop_tpu_torch.serving.router
    out = {}
    conf = Configuration(load_defaults=False)
    reg = RegistryServer(conf); reg.init(conf); reg.start()
    door = HttpServer(conf)
    door.add_handler("/prom", lambda q, b: (200,
        "htpu_decode_step_seconds_sum 1.0\\n"
        "htpu_decode_step_seconds_count 10\\n"
        'htpu_slo_requests_total{class="p0",outcome="ok"} 5\\n'
        'htpu_slo_ttft_seconds_bucket{class="p0",le="+Inf"} 5\\n'
        'htpu_slo_ttft_seconds_count{class="p0"} 5\\n'))
    door.start()
    rc = RegistryClient(("127.0.0.1", reg.port), conf)
    rc.register(ServiceRecord("/services/serving/s/a",
                {"http": f"127.0.0.1:{door.port}"}), 60, auto_renew=False)
    dconf = Configuration(load_defaults=False)
    dconf.set("obs.doctor.registry", f"127.0.0.1:{reg.port}")
    dconf.set("obs.doctor.interval", "3600")
    doc = FleetDoctor(dconf); doc.init(dconf)
    rep = doc.poll_once()
    out["port_slo_windows"] = rep["slo"]["windows_seen"]
    out["port_endpoints_ok"] = sorted(
        v["ok"] for v in rep["endpoints"].values())
    try:
        import hadoop_tpu.serving.router
        out["ref_router"] = "imported"
    except ImportError as e:
        out["ref_router"] = "ImportError"
    from hadoop_tpu.conf import Configuration as JConf
    from hadoop_tpu.obs.doctor import FleetDoctor as JDoctor
    jconf = JConf(load_defaults=False)
    jconf.set("obs.doctor.registry", f"127.0.0.1:{reg.port}")
    jconf.set("obs.doctor.interval", "3600")
    jdoc = JDoctor(jconf); jdoc.init(jconf)
    try:
        jdoc.poll_once()
        out["ref_poll"] = "ok"
    except ImportError:
        out["ref_poll"] = "ImportError"
    doc.stop(); jdoc.stop(); rc.close(); reg.stop(); door.stop()
    print(json.dumps(out))
""")


def test_without_jax_the_port_polls_replicas_and_the_reference_cannot():
    """ROADMAP C 18: a GPU host has no JAX. There the port's doctor
    scrapes a replica and scores its SLO families, and the port's router
    imports; the reference's doctor fails its first replica poll and its
    router does not import."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"port_slo_windows": 1, "port_endpoints_ok": [True],
                   "ref_router": "ImportError", "ref_poll": "ImportError"}


def test_doctor_main_refuses_an_unknown_option(capsys):
    assert doctor.doctor_main(["--bogus", "1"],
                              Configuration(load_defaults=False)) == 2
    assert "unknown doctor option" in capsys.readouterr().err
