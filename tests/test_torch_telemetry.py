"""The port's trainer telemetry against the JAX package's.

``TrainerStepMetrics`` and ``TrainerTelemetry`` of both packages record
the same steps: ``/ws/v1/trainer`` has the same shape and the same
cumulative sums, ``/prom`` the same families and ``rank`` labels (the
bounded set, ``"other"`` past rank 15, a re-ranked process dropping its
stale series), a port rank registered in the reference's
``RegistryServer`` is discovered and scraped by the reference's fleet
doctor, and the elastic block rides the endpoint, or its error form.
"""

import http.client
import json
import re
import time

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.metrics import metrics_system as jmetrics_system
from hadoop_tpu.metrics.prom import render_prom as jrender_prom
from hadoop_tpu.obs import comm as jcomm
from hadoop_tpu.obs import hbm as jhbm
from hadoop_tpu.obs import trainer as jtrainer
from hadoop_tpu.registry import HEARTBEAT_ATTR, RegistryServer
from hadoop_tpu.registry import ServiceRecord as JServiceRecord
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.metrics import metrics_system, render_prom
from hadoop_tpu_torch.obs import comm, hbm, trainer


def _reset_port_globals():
    metrics_system().reset_for_tests()
    comm.comm_runtime().reset_for_tests()
    hbm.hbm_ledger().unregister("t.params")


@pytest.fixture(autouse=True)
def _clean_port_globals():
    """The conftest resets the reference's process state per test; the
    port's is reset here, before (earlier files in this worker trained)
    and after."""
    _reset_port_globals()
    yield
    _reset_port_globals()


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
    assert status == 200, (path, status)
    return json.loads(body)


_STEPS = [(0.2, 0.01), (0.35, 0.0), (0.125, 0.25)]


def _record(m, ckpt=True):
    for wall, wait in _STEPS:
        m.steps.incr()
        m.step_wall.add(wall)
        m.step_wall_hist.add(wall)
        m.data_wait.add(wait)
        m.data_wait_hist.add(wait)
    if ckpt:
        m.ckpt_snapshot.add(0.01)
        m.ckpt_write.add(0.5)
        m.ckpt_write.add(0.25)
        m.ckpt_fence.add(0.0)


def _doors(rank=1, job="j", elastic=(None, None)):
    m, jm = trainer.TrainerStepMetrics(rank=rank), \
        jtrainer.TrainerStepMetrics(rank=rank)
    _record(m)
    _record(jm)
    with comm.comm_runtime().step("trainer.step"):
        comm.record_comm("bucket.psum", 11, 44)
    with jcomm.comm_runtime().step("trainer.step"):
        jcomm.record_comm("bucket.psum", 11, 44)
    hbm.hbm_ledger().register("t.params", "params", lambda: 4096)
    jhbm.hbm_ledger().register("t.params", "params", lambda: 4096)
    tt = trainer.TrainerTelemetry(Configuration(), rank=rank, job=job,
                                  metrics=m, elastic=elastic[0])
    jt = jtrainer.TrainerTelemetry(JConfiguration(load_defaults=False),
                                   rank=rank, job=job, metrics=jm,
                                   elastic=elastic[1])
    return tt, jt


def test_trainer_endpoint_equals_the_reference():
    tt, jt = _doors()
    try:
        got = _json(tt.port, "/ws/v1/trainer")
        want = _json(jt.port, "/ws/v1/trainer")
        assert set(got) == set(want)
        for key in ("rank", "job", "steps", "step_wall", "data_wait",
                    "ckpt"):
            assert got[key] == want[key], key
        assert got["steps"] == 3 and got["step_wall"]["count"] == 3
        assert got["ckpt"]["write"] == {"num_ops": 2, "avg_time": 0.375}
        assert got["comm"] == want["comm"]
        assert got["comm"]["sites"]["bucket.psum"]["payload_bytes"] == 11
        assert set(got["hbm"]) == set(want["hbm"])
        assert want["hbm"]["components"] == {"params": 4096}
        # the port's ledger may hold providers of earlier files' engines
        comps = hbm.hbm_ledger().report()["components"]
        assert got["hbm"]["components"] == comps
        hbm.hbm_ledger().unregister("t.params")
        assert comps["params"] - hbm.hbm_ledger().report()[
            "components"].get("params", 0) == 4096
        # the sums are cumulative: more steps add to them
        _record(tt.metrics, ckpt=False)
        again = _json(tt.port, "/ws/v1/trainer")
        assert again["steps"] == 6 and again["step_wall"]["sum"] == \
            pytest.approx(2 * got["step_wall"]["sum"])
        # the chassis rides along
        assert _json(tt.port, "/health") == {"status": "alive",
                                             "daemon": "trainer-rank1"}
        assert _json(tt.port, "/ws/v1/stacks")["num_threads"] >= 1
        assert _get(tt.port, "/ws/v1/traces")[0] == 200
    finally:
        tt.close()
        jt.close()


def test_anatomy_delta_windows_the_cumulative_sums():
    m = trainer.TrainerStepMetrics(rank=0)
    _record(m)
    before = m.anatomy()
    _record(m, ckpt=False)
    m.ckpt_write.add(1.0)
    d = trainer.anatomy_delta(before, m.anatomy())
    assert d["steps"] == 3 and d["step_wall"]["count"] == 3
    assert d["step_wall"]["sum"] == pytest.approx(sum(w for w, _ in _STEPS))
    assert d["ckpt"]["write"] == {"num_ops": 1,
                                  "avg_time": pytest.approx(1.0)}
    assert d["ckpt"]["snapshot"] == {"num_ops": 0, "avg_time": 0.0}


def _families(text):
    """{family: sorted label sets} of the trainer's /prom series."""
    out = {}
    for line in text.splitlines():
        m = re.match(r"(htpu_trainer_\w+|htpu_(steps|step_wall|data_wait|"
                     r"ckpt_\w+)\w*)\{([^}]*)\}", line)
        if m:
            labels = frozenset(kv for kv in m.group(3).split(",")
                               if not kv.startswith("le="))
            out.setdefault(m.group(1), set()).add(labels)
    return {k: sorted(sorted(s) for s in v) for k, v in out.items()}


@pytest.mark.parametrize("ranks", [(3,), (3, 5), (15,), (16,), (99, 2)])
def test_prom_families_and_rank_labels_equal_the_reference(ranks):
    for rank in ranks:
        m, jm = trainer.TrainerStepMetrics(rank=rank), \
            jtrainer.TrainerStepMetrics(rank=rank)
        for x in (m, jm):
            x.step_wall_hist.add(0.05)
            x.data_wait_hist.add(0.01)
            x.steps.incr()
    text = render_prom(metrics_system())
    jtext = jrender_prom(jmetrics_system())
    got = _families(text)
    assert got == _families(jtext)
    want = trainer.rank_label(ranks[-1])
    assert want == jtrainer.rank_label(ranks[-1])
    assert re.search(r'htpu_trainer_step_wall_seconds_count\{[^}]*rank="'
                     + want + '"', text)
    assert re.search(r'htpu_trainer_data_wait_seconds_count\{[^}]*rank="'
                     + want + '"', text)
    # a re-ranked process keeps no series under the old label
    assert len(got["htpu_trainer_step_wall_seconds_count"]) == 1


def test_doctor_discovers_and_scrapes_a_port_rank():
    from hadoop_tpu.obs.doctor import FleetDoctor
    conf = JConfiguration(load_defaults=False)
    reg_srv = RegistryServer(conf)
    reg_srv.init(conf)
    reg_srv.start()
    tt = doctor = None
    try:
        tconf = Configuration()
        tconf.set("obs.trainer.registry", f"127.0.0.1:{reg_srv.port}")
        tconf.set("serving.registry.record.ttl", "0.6")
        m = trainer.TrainerStepMetrics(rank=0)
        tt = trainer.TrainerTelemetry(tconf, rank=0, job="jobx", metrics=m)
        rec = reg_srv.get("/trainer-jobs/jobx/rank-0")
        assert rec.endpoints == {"http": f"127.0.0.1:{tt.port}"}
        assert {k: rec.attributes[k] for k in ("kind", "rank", "job")} == \
            {"kind": "trainer", "rank": "0", "job": "jobx"}
        assert HEARTBEAT_ATTR in rec.attributes
        # a corpse record: registered long ago, its stamp stale
        reg_srv.put(JServiceRecord(
            "/trainer-jobs/jobx/rank-9", endpoints={"http": "127.0.0.1:1"},
            attributes={HEARTBEAT_ATTR: f"{time.time() - 3600:.3f}"}),
            ttl_s=7200)
        dconf = JConfiguration(load_defaults=False)
        dconf.set("obs.doctor.registry", f"127.0.0.1:{reg_srv.port}")
        doctor = FleetDoctor(dconf)
        doctor.init(dconf)
        doctor.start()
        trainers = {e.name for e in doctor.discover() if e.kind == "trainer"}
        assert trainers == {"/trainer-jobs/jobx/rank-0"}
        _record(m)
        report = doctor.poll_once()
        (row,) = [v for v in report["trainers"]["ranks"].values()
                  if v["endpoint"]["name"] == "/trainer-jobs/jobx/rank-0"]
        assert row["ok"] and row["rank"] == 0 and row["job"] == "jobx"
        assert row["steps"] == 3 and row["step_wall"]["count"] == 3
        # the heartbeat refreshes the stamp and stamps the steps
        deadline = time.monotonic() + 5
        while reg_srv.get("/trainer-jobs/jobx/rank-0").attributes.get(
                "steps") != "3" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert reg_srv.get("/trainer-jobs/jobx/rank-0").attributes[
            "steps"] == "3"
        tt.close()
        tt = None
        assert reg_srv.get("/trainer-jobs/jobx/rank-0") is None
    finally:
        if doctor is not None:
            doctor.stop()
        if tt is not None:
            tt.close()
        reg_srv.stop()


def test_a_dead_registry_does_not_kill_the_rank():
    conf = JConfiguration(load_defaults=False)
    reg_srv = RegistryServer(conf)
    reg_srv.init(conf)
    reg_srv.start()
    tconf = Configuration()
    tconf.set("obs.trainer.registry", f"127.0.0.1:{reg_srv.port}")
    tconf.set("serving.registry.record.ttl", "0.6")
    tt = trainer.TrainerTelemetry(tconf, rank=2, job="j")
    reg_srv.stop()
    time.sleep(0.5)             # heartbeats fail against the dead registry
    try:
        assert _json(tt.port, "/ws/v1/trainer")["rank"] == 2
    finally:
        tt.close()              # the unregister fails quietly
    # a registry that is down when the door opens fails the open, and
    # the door does not stay bound
    bad = Configuration()
    bad.set("obs.trainer.registry", "127.0.0.1:1")
    with pytest.raises(OSError):
        trainer.TrainerTelemetry(bad, rank=0, job="j")


def _raising():
    raise RuntimeError("mid-reshard")


@pytest.mark.parametrize("fn,want", [
    (lambda: {"evicted_ranks": [2], "plan": {"dp": 3}},
     {"evicted_ranks": [2], "plan": {"dp": 3}}),
    (_raising, {"error": "RuntimeError: mid-reshard"}),
])
def test_elastic_block_and_its_error_form(fn, want):
    tt, jt = _doors(rank=0, elastic=(fn, fn))
    try:
        got = _json(tt.port, "/ws/v1/trainer")
        assert got["elastic"] == want == _json(jt.port,
                                               "/ws/v1/trainer")["elastic"]
    finally:
        tt.close()
        jt.close()
