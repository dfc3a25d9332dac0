"""Per-rank trainer telemetry: the step anatomy on the metrics system, and
a rank's door with its fleet registration.

The port's copy of ``hadoop_tpu/obs/trainer.py``:

- :class:`TrainerStepMetrics`, the step anatomy under the metrics source
  ``trainer``: ``steps`` (a counter), ``data_wait``, ``step_wall``,
  ``ckpt_snapshot``, ``ckpt_write`` and ``ckpt_fence`` (rates), and the
  ``step_wall_seconds`` / ``data_wait_seconds`` histograms, which
  ``/prom`` publishes as ``htpu_trainer_step_wall_seconds`` /
  ``htpu_trainer_data_wait_seconds`` with a ``rank`` label drawn from a
  bounded set (ranks 0-15, then ``"other"``). The source is the
  process's, as the reference's: trainers made one after another in one
  process add to the same counts, and :func:`anatomy_delta` gives one
  window of them.
- :class:`TrainerTelemetry`, a rank's door on the port's chassis
  (``/prom``, ``/jmx``, ``/health``, ``/conf``, ``/ws/v1/stacks``,
  ``/ws/v1/traces``, ...) plus ``/ws/v1/trainer``: the step anatomy as
  cumulative sums (the fleet doctor windows them by diffing), the job,
  the runtime comm ledger, the HBM ledger and, from an optional
  callable, the elastic controller's block. With ``obs.trainer.registry``
  set it registers the rank under ``obs.trainer.service`` with a
  heartbeat stamp, so a fleet doctor (the port's ``obs/doctor.py`` or
  the reference's) discovers it as it discovers replicas.

``Trainer`` does not open a door itself: a caller opens one beside it
and hands it ``trainer.step_metrics``. Conf keys: ``obs.trainer.port``
(0 = ephemeral), ``obs.trainer.service`` (``/trainer-jobs``),
``obs.trainer.registry`` (HOST:PORT) and ``obs.comm.timing``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.http.server import HttpServer
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.obs.comm import comm_runtime
from hadoop_tpu_torch.obs.hbm import hbm_ledger
from hadoop_tpu_torch.registry import (HEARTBEAT_ATTR, RegistryClient,
                                       ServiceRecord, record_ttl)

log = logging.getLogger(__name__)

PORT_KEY = "obs.trainer.port"
SERVICE_KEY = "obs.trainer.service"
REGISTRY_KEY = "obs.trainer.registry"
DEFAULT_SERVICE = "/trainer-jobs"

# ranks 0..15 get a series of their own, the rest share "other": the
# doctor tells ranks apart by endpoint, the label serves fleet-level
# aggregation, where 17 series a family is a budget
MAX_RANK_LABEL = 16


def rank_label(rank: int) -> str:
    return str(rank) if 0 <= rank < MAX_RANK_LABEL else "other"


class TrainerStepMetrics:
    """The step-anatomy metric set, rank-labelled on ``/prom``."""

    SOURCE = "trainer"

    def __init__(self, rank: int = 0):
        self.rank = int(rank)
        reg = metrics_system().source(self.SOURCE)
        self.registry = reg
        self.steps = reg.counter("steps", "completed train steps")
        self.data_wait = reg.rate(
            "data_wait", "time blocked on the prefetch queue")
        self.step_wall = reg.rate(
            "step_wall", "dispatch-to-dispatch step wall time")
        self.ckpt_snapshot = reg.rate(
            "ckpt_snapshot", "blocking device->host snapshot of a save")
        self.ckpt_write = reg.rate(
            "ckpt_write", "background write of a save")
        self.ckpt_fence = reg.rate(
            "ckpt_fence", "time a save/restore stalled on the writer")
        want = rank_label(self.rank)
        # a re-ranked process (an elastic restart) must not publish under
        # the old rank's label: making a metric returns the existing one
        # whatever its labels, so drop a stale-ranked one first
        for m in reg.metrics():
            if m.name in ("step_wall_seconds", "data_wait_seconds") \
                    and getattr(m, "prom_labels", {}).get("rank") != want:
                reg.remove(m.name)
        self.step_wall_hist = None
        self.data_wait_hist = None
        # label values come from this literal tuple: the bounded set
        for r in ("0", "1", "2", "3", "4", "5", "6", "7", "8", "9",
                  "10", "11", "12", "13", "14", "15", "other"):
            if r != want:
                continue
            self.step_wall_hist = reg.histogram(
                "step_wall_seconds",
                "dispatch-to-dispatch step wall time",
                prom_name="trainer_step_wall_seconds",
                prom_labels={"rank": r})
            self.data_wait_hist = reg.histogram(
                "data_wait_seconds",
                "time blocked on the prefetch queue",
                prom_name="trainer_data_wait_seconds",
                prom_labels={"rank": r})

    def anatomy(self) -> Dict:
        """Cumulative step anatomy in ``/ws/v1/trainer``'s JSON shape."""
        snap = self.registry.snapshot()

        def hist(n):
            return {"sum": float(snap.get(f"{n}_sum", 0.0) or 0.0),
                    "count": int(snap.get(f"{n}_count", 0) or 0)}

        def rate(n):
            return {"num_ops": int(snap.get(f"{n}_num_ops", 0) or 0),
                    "avg_time": float(snap.get(f"{n}_avg_time", 0.0)
                                      or 0.0)}

        return {"rank": self.rank,
                "steps": int(snap.get("steps", 0) or 0),
                "step_wall": hist("step_wall_seconds"),
                "data_wait": hist("data_wait_seconds"),
                "ckpt": {"snapshot": rate("ckpt_snapshot"),
                         "write": rate("ckpt_write"),
                         "fence": rate("ckpt_fence")}}


def anatomy_delta(before: Dict, after: Dict) -> Dict:
    """The anatomy of the window between two ``anatomy()`` reads of one
    process, as the doctor windows a rank (a rate's ``avg_time`` is the
    mean of the window's operations)."""
    def hist(a, b):
        return {"sum": a["sum"] - b["sum"], "count": a["count"] - b["count"]}

    def rate(a, b):
        n = a["num_ops"] - b["num_ops"]
        total = a["avg_time"] * a["num_ops"] - b["avg_time"] * b["num_ops"]
        return {"num_ops": n, "avg_time": total / n if n else 0.0}

    return {"rank": after["rank"],
            "steps": after["steps"] - before["steps"],
            "step_wall": hist(after["step_wall"], before["step_wall"]),
            "data_wait": hist(after["data_wait"], before["data_wait"]),
            "ckpt": {k: rate(after["ckpt"][k], before["ckpt"][k])
                     for k in after["ckpt"]}}


class TrainerTelemetry:
    """One rank's door and fleet registration."""

    def __init__(self, conf: Optional[ConfLike] = None, *,
                 rank: int = 0, job: str = "train",
                 metrics: Optional[TrainerStepMetrics] = None,
                 advertise_host: str = "127.0.0.1",
                 elastic: Optional[Callable[[], Dict]] = None):
        self.conf = conf or Configuration()
        self.rank = int(rank)
        self.job = job
        # a no-arg callable returning the elastic controller's report():
        # its decisions ride /ws/v1/trainer beside the step anatomy
        self._elastic = elastic
        comm_runtime().configure(self.conf)
        self.metrics = metrics or TrainerStepMetrics(rank=self.rank)
        self.http = HttpServer(
            self.conf, bind=("127.0.0.1", self.conf.get_int(PORT_KEY, 0)),
            daemon_name=f"trainer-rank{self.rank}")
        self.http.add_handler("/ws/v1/trainer", self._h_trainer)
        self.http.start()
        self._stopped = threading.Event()
        self._reg: Optional[RegistryClient] = None
        self._record: Optional[ServiceRecord] = None
        reg_addr = self.conf.get(REGISTRY_KEY, "")
        if reg_addr:
            try:
                self._register(reg_addr, advertise_host)
            except BaseException:
                self.http.stop()
                raise
        log.info("trainer rank %d telemetry on :%d", self.rank,
                 self.http.port)

    @property
    def port(self) -> int:
        return self.http.port

    def record_path(self) -> str:
        service = self.conf.get(SERVICE_KEY, DEFAULT_SERVICE)
        return f"{service}/{self.job}/rank-{self.rank}"

    def _register(self, reg_addr: str, advertise_host: str) -> None:
        """Publish this rank in the trainer-job roster, heartbeat-stamped
        like a replica's record, so the doctor skips a dead rank by
        ``record_is_stale`` instead of timing out on it every poll."""
        host, _, port = reg_addr.rpartition(":")
        self._reg = RegistryClient((host or "127.0.0.1", int(port)),
                                   self.conf)
        self._record_ttl = record_ttl(self.conf)
        self._record = ServiceRecord(
            self.record_path(),
            endpoints={"http": f"{advertise_host}:{self.http.port}"},
            attributes={"kind": "trainer", "rank": str(self.rank),
                        "job": self.job,
                        HEARTBEAT_ATTR: f"{time.time():.3f}"})
        self._reg.register(self._record, ttl_s=self._record_ttl,
                           auto_renew=False)
        threading.Thread(target=self._heartbeat_loop, daemon=True,
                         name=f"trainer-heartbeat-{self.rank}").start()

    def _heartbeat_loop(self) -> None:
        period = max(0.2, self._record_ttl / 3.0)
        while not self._stopped.wait(period):
            self._record.attributes.update({
                HEARTBEAT_ATTR: f"{time.time():.3f}",
                "steps": str(self.metrics.anatomy()["steps"])})
            try:
                self._reg.register(self._record, ttl_s=self._record_ttl,
                                   auto_renew=False)
            except Exception as e:  # noqa: BLE001 — a dead registry
                # must not kill the rank; the next beat retries
                log.debug("trainer heartbeat failed: %s", e)

    def _h_trainer(self, query, body):
        out = dict(self.metrics.anatomy())
        out["job"] = self.job
        out["comm"] = comm_runtime().report()
        out["hbm"] = hbm_ledger().report()
        if self._elastic is not None:
            try:
                out["elastic"] = self._elastic()
            except Exception as e:  # noqa: BLE001 — a controller in the
                # middle of a reshard must not take the door down
                out["elastic"] = {"error": f"{type(e).__name__}: {e}"}
        return 200, out

    def close(self) -> None:
        self._stopped.set()
        if self._reg is not None:
            try:
                self._reg.unregister(self._record.path)
            except Exception as e:  # noqa: BLE001 — best effort: the
                # stale heartbeat and the registry's sweep evict the
                # record when the registry cannot be reached now
                log.debug("trainer unregister failed: %s", e)
            self._reg.close()
        self.http.stop()
