"""The port's elastic plane (``hadoop_tpu_torch/parallel/elastic/``, the
``Trainer``'s ``elastic``/``doctor_poll``/``apply_plan``) against the JAX
package's, on the CPU.

- ``pick_shrunken_plan`` over a grid of plans (ep among them), healthy
  counts, batches and ``min_dp``: the same plan, or None, as the
  reference;
- ``ElasticConfig``'s validation and ``elastic_from_conf``: the same
  configs and the same errors;
- the reference's controller cases (tests/test_elastic.py's
  ``FakeTrainer`` and ``doctor_report``), run through both controllers
  on the same scripted feeds: the same decisions, saves, plans applied,
  counters and events (timing fields aside);
- end to end: a ZeRO-1 dp4 checkpoint the reference wrote (``tiny``,
  float32, ``max_seq`` 32, batch 12) restored by both packages' elastic
  trainers, which take the same scripted doctor feed
  (``dist_plans.scripted_doctor``: rank 2 flagged, then dead). Both
  demote, evict at the same step to dp3 over the other ranks, restore
  the protective snapshot and re-run the lost steps, with equal events;
  each step's loss within ``TOL`` of the reference's (the mesh curve
  tolerance, tests/test_torch_trainer_mesh.py). A second run, plain
  AdamW (the reference's ZeRO-1 step does not build on a mesh of one),
  evicts three times, to a mesh of one rank, on the same losses. The port runs
  as one gloo world of four for the file, with PyTorch's barrier after
  each new group on, so a shrunken mesh's groups are made by its members
  alone; the evicted ranks' processes run no step after their eviction
  and make no group, and the world ends (no rank hangs).
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.fs.filesystem import LocalFileSystem as JLocalFileSystem
from hadoop_tpu.metrics import metrics_system as jmetrics_system
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel import elastic as jelastic
from hadoop_tpu.parallel.elastic import controller as jcontroller
from hadoop_tpu.parallel.trainer import Trainer as JTrainer
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.parallel import MeshPlan, elastic, spmd
from hadoop_tpu_torch.parallel.elastic import controller
from hadoop_tpu_torch.tools import dist_plans

BATCH, LR, WORLD = 12, 1e-2, 4
OVER = {"max_seq": 32}
TOL = 2e-4                  # tests/test_torch_trainer_mesh.py
START, STEPS, INTERVAL = 2, 5, 3
# the evict run: rank 2 flagged from step 3 (demote at the second poll,
# step 4), dead from step 5 (evict at step 5: restore the step-4
# snapshot, re-run 5..7 at dp3; a restart would lose back to step 3)
EVICT = dict(enabled=True, poll_steps=1, min_dp=1, demote_windows=2,
             evict_windows=4, dead_windows=1, cooldown_polls=2)
FEED = {"n": WORLD, "flag": [[2, 3]], "dead": [[2, 5]]}
# the shrink run: ranks 2, 3 and 1 die after steps 3, 4 and 5 (a save
# every step): dp4 → dp3 → dp2 → dp1
SHRINK = dict(enabled=True, poll_steps=1, min_dp=1, demote_windows=1,
              evict_windows=2, dead_windows=1, cooldown_polls=0)
SHRINK_FEED = {"n": WORLD, "dead": [[2, 3], [3, 4], [1, 5]]}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------- shrink planning

PLANS = [dict(dp=4), dict(dp=8), dict(dp=6), dict(dp=4, ep=2),
         dict(dp=2, ep=2), dict(dp=4, tp=2), dict(dp=3, pp=2)]


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "_".join(
    f"{k}{v}" for k, v in p.items()))
def test_pick_shrunken_plan_is_the_references(plan):
    for healthy in range(0, 9):
        for batch in (1, 4, 6, 8, 12, 16, 24):
            for min_dp in (1, 2, 3):
                want = jcontroller.pick_shrunken_plan(
                    JMeshPlan(**plan), healthy, batch, min_dp)
                got = controller.pick_shrunken_plan(
                    MeshPlan(**plan), healthy, batch, min_dp)
                assert (got is None) == (want is None), (healthy, batch,
                                                         min_dp)
                if want is not None:
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want)


# ---------------------------------------------------------------- config

CONFIGS = [dict(), dict(enabled=True, poll_steps=5, min_dp=2),
           dict(demote_windows=3, evict_windows=3),
           dict(poll_steps=0), dict(min_dp=0), dict(dead_windows=0),
           dict(demote_windows=0), dict(cooldown_polls=-1),
           dict(demote_windows=1, evict_windows=2, cooldown_polls=0)]


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_elastic_config_validation_is_the_references(kw):
    try:
        want = dataclasses.asdict(jelastic.ElasticConfig(**kw))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            elastic.ElasticConfig(**kw)
        assert str(got.value) == str(e)
        return
    assert dataclasses.asdict(elastic.ElasticConfig(**kw)) == want


@pytest.mark.parametrize("keys", [
    {}, {"elastic.enabled": "true", "elastic.poll.steps": "5",
         "elastic.min-dp": "2", "elastic.evict.windows": "7"},
    {"elastic.enabled": "true", "elastic.demote.windows": "1",
     "elastic.dead.windows": "3", "elastic.cooldown.polls": "0"}],
    ids=["defaults", "reference_case", "windows"])
def test_elastic_from_conf_is_the_references(keys):
    confs = []
    for make in (JConfiguration, Configuration):
        c = make(load_defaults=False)
        for k, v in keys.items():
            c.set(k, v)
        confs.append(c)
    want = jelastic.elastic_from_conf(confs[0])
    got = elastic.elastic_from_conf(confs[1])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert elastic.elastic_from_conf(None) == elastic.DEFAULT_ELASTIC
    assert elastic.ELASTIC_KEY == jelastic.ELASTIC_KEY


# ------------------------------------------------------------ controller

class FakeTrainer:
    """The controller's trainer contract (tests/test_elastic.py's)."""

    def __init__(self, plan, batch=12, restore_step=30):
        self.plan = plan
        self.batch = batch
        self.step = 40
        self.restore_step = restore_step
        self.saves = []
        self.applied = []

    def save(self, wait=None):
        self.saves.append((self.step, wait))

    def apply_plan(self, plan):
        self.applied.append(dataclasses.asdict(plan))
        self.plan = plan
        self.step = self.restore_step
        return True


def doctor_report(flagged=(), dead=(), n=4):
    ranks = {f"rank-{r}": {"ok": f"rank-{r}" not in dead, "rank": r}
             for r in range(n)}
    return {"trainers": {
        "flagged": {name: {"signals": ["trainer.step_wall"]}
                    for name in flagged},
        "ranks": ranks}}


def _boom():
    raise OSError("doctor unreachable")


# (steps polled, resume after these steps, reports, config, plan kwargs,
# batch): the reference's cases
SCENARIOS = {
    "demote_once_per_streak": (
        [1, 2, 3, 4, 5, 6], (), ["f1"] * 3 + ["clear"] + ["f1"] * 2,
        {}, dict(dp=4), 12),
    "dead_rank_evicts_and_reshards": (
        [1, 2, 3, 4, 5], (2,), ["d2"] * 6,
        dict(dead_windows=1, cooldown_polls=0), dict(dp=4), 12),
    "flagged_streak_evicts_at_threshold": (
        [1, 2, 3, 4], (4,), ["f0"] * 5,
        dict(demote_windows=2, evict_windows=4), dict(dp=4), 12),
    "cooldown_hysteresis_after_resume": (
        [1, 2, 3, 4], (1, 4), ["d3"] + ["d31"] * 4,
        dict(dead_windows=1, cooldown_polls=2), dict(dp=4), 12),
    "evict_infeasible_raises": (
        [1], (), ["d1of2"], dict(dead_windows=1, min_dp=2), dict(dp=2), 12),
    "batch_divisibility": (
        [1], (1,), ["d2"], dict(dead_windows=1), dict(dp=4), 8),
    "ep_plan": ([1], (1,), ["d2"], dict(dead_windows=1),
                dict(dp=4, ep=2), 8),
    "poll_failure_is_not_fatal": ([1, 2], (), "boom", {}, dict(dp=4), 12),
}
REPORTS = {"f1": doctor_report(flagged=["rank-1"]),
           "f0": doctor_report(flagged=["rank-0"]),
           "clear": doctor_report(),
           "d2": doctor_report(dead=["rank-2"]),
           "d3": doctor_report(dead=["rank-3"]),
           "d31": doctor_report(dead=["rank-3", "rank-1"]),
           "d1of2": doctor_report(dead=["rank-1"], n=2)}


def _run_scenario(pkg, cfg_cls, plan_cls, metrics, scenario):
    steps, resume_after, reports, cfg_kw, plan_kw, batch = scenario
    tr = FakeTrainer(plan_cls(**plan_kw), batch=batch)
    kw = dict(enabled=True, poll_steps=1, min_dp=1, demote_windows=2,
              evict_windows=10, dead_windows=2, cooldown_polls=0)
    kw.update(cfg_kw)
    if reports == "boom":
        poll = _boom
    else:
        feed = [REPORTS[r] for r in reports]

        def poll():
            return feed.pop(0)
    reg = metrics().source("elastic")
    names = ("polls", "demotes", "evictions", "resumes", "lost_steps")
    before = {n: reg.counter(n).value() for n in names}
    ctl = pkg.ElasticController(tr, cfg_cls(**kw), poll_fn=poll)
    trace = []
    for step in steps:
        try:
            trace.append(("on_step", step, ctl.on_step(step), ctl.pending))
        except RuntimeError as e:
            trace.append(("raised", step, str(e)))
            break
        if step in resume_after:
            trace.append(("resume", ctl.resume(), ctl.pending))
    report = ctl.report()
    report["events"] = dist_plans.elastic_events(report["events"])
    return {"trace": trace, "saves": tr.saves, "applied": tr.applied,
            "events": dist_plans.elastic_events(ctl.events),
            "report": report,
            "counters": {n: reg.counter(n).value() - before[n]
                         for n in names}}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_decisions_are_the_references(name):
    want = _run_scenario(jcontroller, jelastic.ElasticConfig, JMeshPlan,
                         jmetrics_system, SCENARIOS[name])
    got = _run_scenario(controller, elastic.ElasticConfig, MeshPlan,
                        metrics_system, SCENARIOS[name])
    assert got == want
    if name == "dead_rank_evicts_and_reshards":
        # the evicted rank's process rank, which a mesh leaves out
        assert want["applied"] == [dataclasses.asdict(JMeshPlan(dp=3))]


def test_controller_requires_poll_fn():
    for pkg, cfg, plan in ((jcontroller, jelastic.ElasticConfig, JMeshPlan),
                           (controller, elastic.ElasticConfig, MeshPlan)):
        with pytest.raises(ValueError, match="poll_fn"):
            pkg.ElasticController(FakeTrainer(plan(dp=4)), cfg(enabled=True),
                                  poll_fn=None)


def test_controller_keeps_the_evicted_process_ranks():
    """The port's addition: the roster rows' ``rank`` of each rank it
    evicted (what the trainer leaves out of the shrunken mesh)."""
    tr = FakeTrainer(MeshPlan(dp=4))
    reports = [doctor_report(dead=["rank-2"]),
               doctor_report(dead=["rank-2", "rank-1"])]
    ctl = controller.ElasticController(
        tr, elastic.ElasticConfig(enabled=True, poll_steps=1,
                                  dead_windows=1, cooldown_polls=0),
        poll_fn=lambda: reports.pop(0))
    assert ctl.on_step(1) and ctl.resume()
    assert ctl.evicted_process_ranks == {2}
    assert ctl.on_step(2) and ctl.resume()
    assert ctl.evicted_process_ranks == {1, 2}


def test_doctor_http_poll_reads_the_doctor_as_the_reference():
    """Both packages' ``doctor_http_poll`` read ``/ws/v1/fleet/doctor``
    from a local HTTP server to the same report; a non-200 raises
    ``IOError`` in both (the controller then skips the poll)."""
    import http.server
    import json
    import threading

    report = doctor_report(flagged=["rank-1"], dead=["rank-3"])

    class Doctor(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            ok = self.path == "/ws/v1/fleet/doctor"
            body = json.dumps(report).encode() if ok else b"no"
            self.send_response(200 if ok else 404)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = http.server.HTTPServer(("127.0.0.1", 0), Doctor)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        assert controller.doctor_http_poll("127.0.0.1", port)() == \
            jcontroller.doctor_http_poll("127.0.0.1", port)() == report
        from hadoop_tpu_torch.http import http_get
        with pytest.raises(IOError, match="404"):
            http_get("127.0.0.1", port, "/elsewhere", 5.0)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=10)
    assert not thread.is_alive()


# ------------------------------------------------------------ end to end

def _jtrainer(root, plan, ckpt, zero1=True, **kw):
    return JTrainer(jconfig.get_config("tiny", **OVER), JMeshPlan(**plan),
                    JLocalFileSystem(), f"{root}/toks.bin", f"{root}/{ckpt}",
                    batch=BATCH, lr=LR, zero1=zero1, **kw)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The token file and the reference's ZeRO-1 dp4 checkpoint at step
    ``START``, copied for each elastic run of each package."""
    path = tmp_path_factory.mktemp("elastic")
    toks = np.random.default_rng(0).integers(0, 256, 60_000,
                                             dtype=np.uint16)
    JLocalFileSystem().write_all(f"{path}/toks.bin", toks.tobytes())
    t = _jtrainer(path, {"dp": 4}, "src", ckpt_interval=0)
    t.train(START)
    t.save()
    t.close()
    for run in ("ref_evict", "port_evict", "ref_shrink", "port_shrink"):
        shutil.copytree(f"{path}/src", f"{path}/{run}")
    return str(path)


def _reference_run(root, run, cfg_kw, feed, interval, zero1):
    box = []
    t = _jtrainer(root, {"dp": 4}, run, zero1, ckpt_interval=interval,
                  elastic=jelastic.ElasticConfig(**cfg_kw),
                  doctor_poll=dist_plans.scripted_doctor(lambda: box[0].step,
                                                         feed))
    box.append(t)
    assert t.try_restore() and t.step == START
    t.train(STEPS)
    t.wait_for_checkpoint()
    out = {"events": dist_plans.elastic_events(t.elastic.events),
           "loss_by_step": dict(t.loss_by_step), "step": t.step,
           "plan": dataclasses.asdict(t.plan)}
    t.close()
    return out


@pytest.fixture(scope="module")
def reference(root):
    return {"evict": _reference_run(root, "ref_evict", EVICT, FEED,
                                    INTERVAL, True),
            "shrink": _reference_run(root, "ref_shrink", SHRINK,
                                     SHRINK_FEED, 1, False)}


@pytest.fixture(scope="module")
def world(root, reference):
    """Every rank's records of the port's two elastic runs, by name."""
    ops = []
    for name, cfg_kw, feed, interval, zero1 in (
            ("evict", EVICT, FEED, INTERVAL, True),
            ("shrink", SHRINK, SHRINK_FEED, 1, False)):
        ops += [{"op": "make", "name": name, "plan": {"dp": 4},
                 "ckpt": f"{root}/port_{name}", "feed": feed,
                 "kw": {"zero1": zero1, "ckpt_interval": interval,
                        "elastic": cfg_kw}},
                {"op": "restore", "name": name},
                {"op": "train", "name": name, "steps": STEPS},
                {"op": "crash", "name": name}]
    job = {"preset": "tiny", "overrides": OVER, "data": f"{root}/toks.bin",
           "device": "cpu", "seed": 0, "telemetry": True,
           "trainer": {"batch": BATCH, "lr": LR}, "ops": ops}
    # PyTorch's barrier after each new group, over its members: a mesh
    # over part of the world waits for none of the processes that left
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TORCH_DIST_INIT_BARRIER", "1")
        recs = spmd.launch(dist_plans.trainer_ops, WORLD, backend="gloo",
                           args=([job],), timeout=300)
    out = {}
    for rank, per_rank in enumerate(recs):
        for rec in per_rank[0]:
            if rec["op"] in ("train", "restore"):
                out.setdefault((rec["op"], rec["name"]), []).append(rec)
    return out


def _losses(by_step):
    return [by_step[s] for s in range(START + 1, START + STEPS + 1)]


@pytest.mark.parametrize("name,evicted", [("evict", [2]),
                                          ("shrink", [2, 3, 1])])
def test_port_evicts_and_reshards_as_the_reference(reference, world, name,
                                                   evicted):
    want = reference[name]
    assert all(r["restored"] and r["step"] == START
               for r in world[("restore", name)])
    runs = world[("train", name)]
    survivors = [r for r in range(WORLD) if r not in evicted]
    for rank in survivors:
        rec = runs[rank]
        assert rec["events"] == want["events"]
        assert rec["plan"] == want["plan"] and not rec["left_mesh"]
        assert rec["step"] == want["step"] == START + STEPS
        np.testing.assert_allclose(_losses(rec["loss_by_step"]),
                                   _losses(want["loss_by_step"]), rtol=TOL)
        assert rec["losses"] == runs[survivors[0]]["losses"]
    decisions = [e["decision"] for e in want["events"]]
    if name == "evict":
        assert decisions == ["demote", "evict", "resume"]
        resume = want["events"][-1]
        assert resume["restored"] and resume["lost_steps"] == 1
        # fewer lost steps than a restart from the last interval save
        evict_at = want["events"][1]["step"]
        assert resume["lost_steps"] < evict_at - \
            (evict_at // INTERVAL) * INTERVAL
        assert want["plan"]["dp"] == 3
    else:
        assert decisions == ["evict", "resume"] * 3
        assert want["plan"]["dp"] == 1
    # an evicted process leaves the mesh at its eviction and runs no more
    # steps: its last step is the evict decision's
    evict_steps = [e["step"] for e in want["events"]
                   if e["decision"] == "evict"]
    for rank, at in zip(evicted, evict_steps):
        rec = runs[rank]
        assert rec["left_mesh"] and rec["step"] == at
        assert rec["events"][-1]["decision"] == "leave"
        assert len(rec["launches"]) == at - START
    if name == "evict":       # steps 3-5 at dp4, then 5-7 again at dp3
        assert all(runs[r]["step_dp"] == [4] * 3 + [3] * 3
                   for r in survivors)


@pytest.mark.parametrize("name,evicted", [("evict", [2]),
                                          ("shrink", [2, 3, 1])])
def test_each_rank_door_serves_its_ledger_and_elastic_block(world, name,
                                                            evicted):
    """Every rank's own ``/ws/v1/trainer`` after the run: the comm block
    is that rank's ledger report, the step counts are the run's, and the
    elastic block carries the controller's evict and resume decisions
    and the shrunken plan."""
    for rank, rec in enumerate(world[("train", name)]):
        door = rec["door"]
        assert door["comm"] == rec["comm_report"]
        assert door["steps"] >= rec["anatomy"]["steps"] == \
            len(rec["launches"])
        block = door["elastic"]
        # an evicted process's controller stops at its own eviction
        upto = evicted[:evicted.index(rank) + 1] if rank in evicted \
            else evicted
        assert block["evicted_ranks"] == sorted(f"rank-{r}" for r in upto)
        decisions = [e["decision"] for e in block["events"]]
        assert [d for d in decisions if d != "leave"] == \
            [e["decision"] for e in rec["events"] if e["decision"] != "leave"]
        if rank not in evicted:
            assert block["plan"] == rec["plan"]
            assert "evict" in decisions and "resume" in decisions
