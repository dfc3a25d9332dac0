"""The SLO control loop: scrape → decide → act.

The port's copy of ``hadoop_tpu/serving/autoscale/controller.py``, on
the port's metrics system, registry client, backoff and YARN
``ServiceClient`` (``yarn.py``). Its decisions are the reference's on
the same snapshots and clock.

Closes the last open serving-plane loop: the registry knows the
members, ``/prom`` knows whether users are feeling it (TTFT p99,
backlog, QoS sheds), YARN can flex a component count at runtime — this
controller is the piece that reads the first two and drives the third.

Decision rules (all conf-keyed, ``serving.autoscale.*``):

- **Grow before saturation, not at it.** A breach is TTFT p99 over the
  SLO, mean queue depth over ``queue.high``, any QoS shed in the
  window, or utilization over a **cold-start-adjusted** high-water
  mark: the measured checkpoint-pull latency each replica publishes
  (``load_seconds``) is divided by the planning ``horizon`` and
  subtracted from ``util.high`` — a fleet whose replicas take 5 minutes
  to come up starts growing proportionally earlier, because capacity
  ordered at saturation arrives after the queue has already melted.

- **Hysteresis + cooldown, never flap.** Growth needs ``breach.polls``
  consecutive breaching polls; shrink needs ``idle.polls`` consecutive
  quiet polls (TTFT under ``scalein.ttft.frac`` of the SLO, near-empty
  queues, utilization under ``util.low``, zero sheds); every action
  arms a ``cooldown`` during which the pool holds.

- **Role-aware.** The ``prefill`` pool (strict ``role=prefill``
  replicas) is sized independently off prefill backlog; everything
  else is the ``decode`` pool, sized off the latency SLOs. A fleet
  without prefill replicas is just a decode pool.

- **Drain-aware scale-in.** The victim (least loaded, then least cache
  resident — retiring the replica whose loss costs the fleet's
  hit-rate least) is told to retire through ``POST /v1/admin/drain``:
  it leaves the registry, force-persists its resident prefixes into
  the DFS tier, finishes every in-flight generation, and exits; only
  then does the actuator release its capacity. Shrinking the fleet
  never torches the cache and never fails a request.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike
from hadoop_tpu_torch.http import http_get
from hadoop_tpu_torch.ipc.rpc import backoff_delay
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.registry import (REGISTRY_PREFIX, RegistryClient,
                                       record_is_stale, record_ttl)
from hadoop_tpu_torch.serving.autoscale.signals import (FleetScraper,
                                                        FleetSnapshot,
                                                        ReplicaSample)

log = logging.getLogger(__name__)

INTERVAL_KEY = "serving.autoscale.interval"
TTFT_SLO_KEY = "serving.autoscale.ttft.p99.slo"
QUEUE_HIGH_KEY = "serving.autoscale.queue.high"
UTIL_HIGH_KEY = "serving.autoscale.util.high"
UTIL_LOW_KEY = "serving.autoscale.util.low"
HORIZON_KEY = "serving.autoscale.horizon"
LEAD_MAX_KEY = "serving.autoscale.lead.max"
BREACH_POLLS_KEY = "serving.autoscale.breach.polls"
IDLE_POLLS_KEY = "serving.autoscale.idle.polls"
COOLDOWN_KEY = "serving.autoscale.cooldown"
MIN_KEY = "serving.autoscale.min"
MAX_KEY = "serving.autoscale.max"
PREFILL_MIN_KEY = "serving.autoscale.prefill.min"
PREFILL_MAX_KEY = "serving.autoscale.prefill.max"
BACKLOG_HIGH_KEY = "serving.autoscale.backlog.high"
DRAIN_TIMEOUT_KEY = "serving.autoscale.drain.timeout"
SCALEIN_TTFT_FRAC_KEY = "serving.autoscale.scalein.ttft.frac"
# fleet doctor door (host:port): sick replicas become preferred
# scale-in victims — retiring the statistical outlier heals the fleet
DOCTOR_KEY = "serving.autoscale.doctor"
# guarded grow signal off the doctor's SLO scoreboard: when enabled, a
# tenant class burning its error budget (multi-window verdict at
# /ws/v1/fleet/slo) breaches like a shed. Default OFF — the scoreboard
# observes a fleet for free; acting on it is an operator's call.
SLO_BURN_KEY = "serving.autoscale.slo.burn"

METRICS_SOURCE = "serving.autoscale"


@dataclass
class ScaleDecision:
    at: float
    role: str
    action: str            # "grow" | "shrink" | "hold"
    current: int
    target: int
    reason: str
    victim: Optional[str] = None


class FleetActuator:
    """What the controller drives. ``scale_out`` must eventually make
    ``target`` members of ``role`` register; ``retire`` releases the
    drained victim's capacity (kill the container / flex the count).
    ``drains_via_platform=True`` actuators (YARN: the NM's SIGTERM IS
    the drain — the replica's signal handler runs the same persist +
    finish path) skip the controller's HTTP drain."""

    drains_via_platform = False

    def scale_out(self, role: str, target: int) -> None:
        raise NotImplementedError

    def retire(self, sample: ReplicaSample, target: int) -> None:
        raise NotImplementedError


class AdviseOnlyActuator(FleetActuator):
    """Observe mode: decisions are logged and recorded, nothing moves.
    The standalone controller runs this when no flex target is
    configured — dashboards still get the would-have-done trail."""

    def scale_out(self, role: str, target: int) -> None:
        log.info("autoscale (advise): would grow %s pool to %d",
                 role, target)

    def retire(self, sample: ReplicaSample, target: int) -> None:
        log.info("autoscale (advise): would retire %s (pool -> %d)",
                 sample.path, target)


class YarnServiceActuator(FleetActuator):
    """Flex the replica component of a YARN long-running service. The
    service AM stops the newest surplus container on flex-down and its
    SIGTERM runs the replica's own drain path (registry flip → persist
    → finish in-flight → exit), so the platform drain is the same
    protocol — minus the controller's victim choice, which YARN does
    not expose."""

    drains_via_platform = True

    def __init__(self, rm_addr: Tuple[str, int], app_id,
                 component: str = "replica",
                 conf: Optional[ConfLike] = None,
                 prefill_component: Optional[str] = None):
        from hadoop_tpu_torch.yarn import ServiceClient
        self.client = ServiceClient(rm_addr, conf)
        self.app_id = app_id
        self.components = {"decode": component,
                           "prefill": prefill_component or
                           f"{component}-prefill"}

    def scale_out(self, role: str, target: int) -> None:
        self.client.flex(self.app_id, self.components[role], target)

    def retire(self, sample: ReplicaSample, target: int) -> None:
        self.client.flex(self.app_id, self.components[sample.role
                         if sample.role == "prefill" else "decode"],
                         target)


class _PoolState:
    def __init__(self):
        self.breach = 0
        self.idle = 0
        self.last_action = 0.0      # monotonic; 0 = never


class Autoscaler:
    """One control loop over one serving service's fleet."""

    def __init__(self, conf: ConfLike,
                 registry_addr: Tuple[str, int], service: str,
                 actuator: Optional[FleetActuator] = None):
        self.conf = conf
        self.service = service
        self.actuator = actuator or AdviseOnlyActuator()
        self.reg = RegistryClient(registry_addr, conf)
        self.scraper = FleetScraper(conf)
        self.interval = conf.get_time_seconds(INTERVAL_KEY, 10.0)
        self.ttft_slo = conf.get_time_seconds(TTFT_SLO_KEY, 2.0)
        self.queue_high = conf.get_float(QUEUE_HIGH_KEY, 2.0)
        self.util_high = conf.get_float(UTIL_HIGH_KEY, 0.85)
        self.util_low = conf.get_float(UTIL_LOW_KEY, 0.3)
        self.horizon = conf.get_time_seconds(HORIZON_KEY, 60.0)
        self.lead_max = conf.get_float(LEAD_MAX_KEY, 0.3)
        self.breach_polls = max(1, conf.get_int(BREACH_POLLS_KEY, 2))
        self.idle_polls = max(1, conf.get_int(IDLE_POLLS_KEY, 5))
        self.cooldown = conf.get_time_seconds(COOLDOWN_KEY, 30.0)
        self.bounds = {
            "decode": (max(1, conf.get_int(MIN_KEY, 1)),
                       conf.get_int(MAX_KEY, 8)),
            "prefill": (conf.get_int(PREFILL_MIN_KEY, 0),
                        conf.get_int(PREFILL_MAX_KEY, 4)),
        }
        self.backlog_high = conf.get_float(BACKLOG_HIGH_KEY, 512.0)
        self.drain_timeout = conf.get_time_seconds(DRAIN_TIMEOUT_KEY,
                                                   120.0)
        self.scalein_ttft_frac = conf.get_float(SCALEIN_TTFT_FRAC_KEY,
                                                0.5)
        self.record_ttl = record_ttl(conf)
        self._doctor_addr: Optional[Tuple[str, int]] = None
        doctor = conf.get(DOCTOR_KEY, "")
        if doctor:
            host, _, port = doctor.rpartition(":")
            self._doctor_addr = (host or "127.0.0.1", int(port))
        self._sick: set = set()     # doctor-flagged replica paths
        self.slo_burn_enabled = conf.get_bool(SLO_BURN_KEY, False)
        # last per-class burn verdict off the doctor report's "slo"
        # section (kept on doctor outage, like _sick)
        self._slo_burn: Dict[str, dict] = {}
        self._pools: Dict[str, _PoolState] = {
            "decode": _PoolState(), "prefill": _PoolState()}
        self._draining: set = set()     # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: List[ScaleDecision] = []
        self.last_snapshot: Optional[FleetSnapshot] = None
        reg = metrics_system().source(METRICS_SOURCE)
        self.m_scale_out = reg.counter(
            "autoscale_scale_out", "pool growth actions issued")
        self.m_scale_in = reg.counter(
            "autoscale_scale_in", "drain-and-retire actions completed")
        self.m_drain_failures = reg.counter(
            "autoscale_drain_failures",
            "victims that did not finish draining inside the timeout")
        self.m_decode_replicas = reg.gauge(
            "autoscale_decode_replicas", "live decode-pool replicas")
        self.m_prefill_replicas = reg.gauge(
            "autoscale_prefill_replicas", "live prefill-pool replicas")
        self.m_ttft_p99 = reg.gauge(
            "autoscale_ttft_p99_seconds",
            "fleet TTFT p99 over the last poll window")

    # --------------------------------------------------------- one poll

    def poll(self) -> List[ScaleDecision]:
        """One scrape-decide-act cycle (the loop calls this; tests call
        it directly for deterministic stepping)."""
        try:
            recs = [r for r in self.reg.list(
                        f"{REGISTRY_PREFIX}/{self.service}")
                    if "http" in r.endpoints
                    and not record_is_stale(r, self.record_ttl)]
        except (OSError, IOError) as e:
            log.warning("autoscale: registry list failed: %s", e)
            return []
        snap = self.scraper.scrape(recs)
        with self._lock:
            for s in snap.samples:
                if s.path in self._draining:
                    s.draining = True
        self._refresh_sick()
        self.last_snapshot = snap
        self.m_decode_replicas.set(len(snap.pool("decode")))
        self.m_prefill_replicas.set(len(snap.pool("prefill")))
        if snap.ttft_p99_s is not None:
            self.m_ttft_p99.set(round(snap.ttft_p99_s, 6))
        out: List[ScaleDecision] = []
        for role in ("decode", "prefill"):
            d = self._decide(role, snap)
            if d is not None:
                out.append(d)
                self.decisions.append(d)
                del self.decisions[:-256]          # bounded history
                self._act(d, snap)
        return out

    def _refresh_sick(self) -> None:
        """Pull the doctor's sick-replica verdict (bounded timeout; a
        dead doctor keeps the last-known set — a transient doctor
        outage must not flip victim preference every poll)."""
        if self._doctor_addr is None:
            return
        try:
            rep = json.loads(http_get(self._doctor_addr[0],
                                      self._doctor_addr[1],
                                      "/ws/v1/fleet/doctor",
                                      self.scraper.timeout))
            self._sick = set((rep.get("replicas") or {})
                             .get("flagged", {}).keys())
            # the SLO burn verdicts ride the same pull — one doctor
            # scrape feeds both victim preference and the grow signal
            classes = (rep.get("slo") or {}).get("classes") or {}
            self._slo_burn = {
                cls: {"burning": bool(row.get("burning")),
                      "burn_fast": row.get("burn_fast"),
                      "burn_slow": row.get("burn_slow"),
                      "availability": row.get("availability")}
                for cls, row in classes.items()
                if isinstance(row, dict)}
        except (OSError, ValueError) as e:
            log.debug("doctor scrape failed: %s", e)

    # ---------------------------------------------------------- policy

    def _grow_reason(self, role: str, snap: FleetSnapshot
                     ) -> Optional[str]:
        if role == "prefill":
            backlog = snap.mean_prefill_backlog("prefill")
            if snap.pool("prefill") and backlog > self.backlog_high:
                return (f"prefill backlog {backlog:.0f} tokens/replica "
                        f"> {self.backlog_high:.0f}")
            return None
        if snap.ttft_p99_s is not None and \
                snap.ttft_p99_s > self.ttft_slo:
            return (f"ttft p99 {snap.ttft_p99_s * 1e3:.0f}ms > SLO "
                    f"{self.ttft_slo * 1e3:.0f}ms")
        if snap.shed_delta > 0:
            return f"{snap.shed_delta} requests shed (429) this window"
        if self.slo_burn_enabled:
            burning = sorted(cls for cls, row in self._slo_burn.items()
                             if row.get("burning"))
            if burning:
                return (f"error-budget burn in class"
                        f"{'es' if len(burning) > 1 else ''} "
                        f"{', '.join(burning)} (doctor SLO scoreboard)")
        q = snap.mean_queue_depth(role)
        if q > self.queue_high:
            return f"queue depth {q:.1f}/replica > {self.queue_high:g}"
        # cold-start-aware saturation guard: the slower a replacement
        # replica comes up, the earlier the pool must order one
        lead = min(self.lead_max,
                   snap.max_load_seconds(role) / max(1.0, self.horizon))
        util = snap.utilization(role)
        if util >= self.util_high - lead:
            return (f"utilization {util:.2f} >= "
                    f"{self.util_high:g} - cold-start lead {lead:.2f}")
        return None

    def _quiet(self, role: str, snap: FleetSnapshot) -> bool:
        if role == "prefill":
            return snap.mean_prefill_backlog("prefill") <= 0
        ttft_ok = (snap.ttft_p99_s is None or
                   snap.ttft_p99_s < self.ttft_slo *
                   self.scalein_ttft_frac)
        return (ttft_ok and snap.shed_delta == 0
                and snap.mean_queue_depth(role) < 0.5
                and snap.utilization(role) < self.util_low)

    def _decide(self, role: str, snap: FleetSnapshot
                ) -> Optional[ScaleDecision]:
        pool = snap.pool(role)
        n = len(pool)
        lo, hi = self.bounds[role]
        st = self._pools[role]
        if role == "prefill" and n == 0 and lo == 0:
            return None       # no prefill pool configured: decode-only
        if n < lo and self._cooled(st):
            # below the configured floor (a crashed replica whose
            # record TTL-expired): restore capacity without waiting for
            # a breach — an empty quiet pool never breaches anything
            st.breach = st.idle = 0
            st.last_action = time.monotonic()
            return ScaleDecision(snap.at, role, "grow", n, n + 1,
                                 f"pool below min floor {lo}")
        reason = self._grow_reason(role, snap)
        if reason is not None:
            st.idle = 0
            st.breach += 1
            if st.breach >= self.breach_polls and n < hi and \
                    self._cooled(st):
                st.breach = 0
                st.last_action = time.monotonic()
                return ScaleDecision(snap.at, role, "grow", n, n + 1,
                                     reason)
            return None
        st.breach = 0
        if self._quiet(role, snap):
            st.idle += 1
            # the floor counts only HEALTHY members: with one working
            # and one wedged replica, n=2 > min=1 must not retire the
            # working one and leave a fleet of corpses
            healthy = sum(1 for s in pool if s.ok)
            if st.idle >= self.idle_polls and n > lo and \
                    healthy > lo and \
                    self._cooled(st):
                victim = self._pick_victim(pool)
                if victim is None:
                    return None
                st.idle = 0
                st.last_action = time.monotonic()
                return ScaleDecision(
                    snap.at, role, "shrink", n, n - 1,
                    f"quiet for {self.idle_polls} polls", victim.path)
        else:
            st.idle = 0
        return None

    def _cooled(self, st: _PoolState) -> bool:
        return time.monotonic() - st.last_action >= self.cooldown

    def _pick_victim(self, pool: List[ReplicaSample]
                     ) -> Optional[ReplicaSample]:
        """Affinity-aware victim choice: a doctor-flagged SICK replica
        first (retiring the statistical outlier removes the fleet's
        tail), then the least-loaded, then the fewest resident cached
        blocks — retire the member whose drain persists the least and
        whose loss moves the fewest rendezvous keys."""
        cands = [s for s in pool if s.ok]
        if not cands:
            return None
        sick = self._sick
        return min(cands, key=lambda s: (s.path not in sick,
                                         s.active + s.queue_depth,
                                         s.cached_blocks, s.path))

    # ---------------------------------------------------------- actions

    def _act(self, d: ScaleDecision, snap: FleetSnapshot) -> None:
        if d.action == "grow":
            self.m_scale_out.incr()
            log.info("autoscale: grow %s pool %d -> %d (%s)",
                     d.role, d.current, d.target, d.reason)
            try:
                self.actuator.scale_out(d.role, d.target)
            except Exception as e:  # noqa: BLE001 — a failed flex must
                # not kill the loop; the breach re-arms next poll
                log.warning("autoscale: scale_out failed: %s", e)
            return
        victim = next((s for s in snap.samples if s.path == d.victim),
                      None)
        if victim is None:
            return
        with self._lock:
            if victim.path in self._draining:
                return
            self._draining.add(victim.path)
        log.info("autoscale: shrink %s pool %d -> %d, draining %s (%s)",
                 d.role, d.current, d.target, victim.path, d.reason)
        threading.Thread(target=self._drain_and_retire,
                         args=(victim, d.target),
                         name="autoscale-drain", daemon=True).start()

    def _drain_and_retire(self, victim: ReplicaSample,
                          target: int) -> None:
        try:
            if not self.actuator.drains_via_platform:
                self._drain_via_door(victim)
            self.actuator.retire(victim, target)
            self.m_scale_in.incr()
        except Exception as e:  # noqa: BLE001 — a wedged victim is
            # logged and counted; the pool re-decides next poll
            self.m_drain_failures.incr()
            log.warning("autoscale: drain of %s failed: %s",
                        victim.path, e)
        finally:
            with self._lock:
                self._draining.discard(victim.path)

    def _drain_via_door(self, victim: ReplicaSample) -> None:
        """POST /v1/admin/drain, then watch the door until the drain
        completes (active and queue both zero) or the replica's door
        vanishes (it exited — the strongest completion signal)."""
        conn_timeout = self.scraper.timeout
        conn = http.client.HTTPConnection(victim.host, victim.port,
                                          timeout=conn_timeout)
        try:
            conn.request("POST", "/v1/admin/drain")
            resp = conn.getresponse()
            resp.read()
            if resp.status not in (200, 202):
                raise IOError(f"admin drain -> HTTP {resp.status}")
        finally:
            conn.close()
        deadline = time.monotonic() + self.drain_timeout
        attempt = 0
        misses = 0
        while time.monotonic() < deadline:
            try:
                h = json.loads(http_get(victim.host, victim.port,
                                        "/v1/health", conn_timeout))
                misses = 0
            except ConnectionRefusedError:
                return      # door socket closed: the replica exited
            except (OSError, IOError, ValueError):
                # a timeout or blip is NOT "exited" — a GIL-bound
                # persist can miss one poll, and retiring on it would
                # kill the replica mid-drain; only a persistent
                # silence reads as gone
                misses += 1
                if misses >= 3:
                    return
                time.sleep(backoff_delay(0.1, min(attempt, 4),
                                         max_s=2.0))
                attempt += 1
                continue
            if h.get("status") == "draining" and \
                    int(h.get("active", 0)) == 0 and \
                    int(h.get("queue_depth", 0)) == 0 and \
                    h.get("drain_complete", True):
                # drain_complete distinguishes "in-flight done" from
                # "cache persist flushed" — retiring between the two
                # would strand half-written DFS blocks (missing on a
                # pre-drain_complete door: assume the weaker signal)
                return
            time.sleep(backoff_delay(0.1, min(attempt, 4), max_s=2.0))
            attempt += 1
        raise TimeoutError(
            f"{victim.path} still draining after {self.drain_timeout}s")

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self.run,
                                        name="autoscaler", daemon=True)
        self._thread.start()

    def run(self) -> None:
        """The control loop: jittered cadence (a fleet of controllers
        restarted together must not scrape in lockstep — same law as
        every retry in this tree, via ``ipc.rpc.backoff_delay``)."""
        while not self._stop.wait(backoff_delay(
                self.interval, 0, max_s=self.interval * 1.5)):
            try:
                self.poll()
            except Exception as e:  # noqa: BLE001 — one bad poll
                # (replica mid-exit, registry restart) must not kill
                # the controller
                log.warning("autoscale poll failed: %s", e)

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.reg.close()

    def status(self) -> dict:
        snap = self.last_snapshot
        with self._lock:
            draining = sorted(self._draining)
        return {
            "service": self.service,
            "interval_s": self.interval,
            "ttft_p99_slo_s": self.ttft_slo,
            "pools": {
                role: {
                    "live": len(snap.pool(role)) if snap else 0,
                    "min": self.bounds[role][0],
                    "max": self.bounds[role][1],
                    "breach_polls": self._pools[role].breach,
                    "idle_polls": self._pools[role].idle,
                } for role in ("decode", "prefill")},
            "ttft_p99_s": snap.ttft_p99_s if snap else None,
            "shed_delta": snap.shed_delta if snap else 0,
            "draining": draining,
            "sick": sorted(self._sick),
            # last per-class SLO burn verdict (doctor scoreboard) next
            # to the decision history it can justify
            "slo_burn": {"enabled": self.slo_burn_enabled,
                         "classes": dict(self._slo_burn)},
            "decisions": [
                {"at": d.at, "role": d.role, "action": d.action,
                 "current": d.current, "target": d.target,
                 "reason": d.reason, "victim": d.victim}
                for d in self.decisions[-20:]],
        }
