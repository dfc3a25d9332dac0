"""Serving-door QoS: per-tenant fairness in front of engine admission.

The counterpart of ``hadoop_tpu/serving/qos.py``, whole, with its conf
keys. Requests are not unit-cost, so the decay accounting charges
**tokens** (prompt plus requested output), not calls:

- ``DecayCostScheduler``: per-tenant (auth identity) cost counters with
  periodic exponential decay; a tenant's share of the decayed total maps
  to a priority level through ``1/2^k`` thresholds.
- ``FairAdmissionQueue``: a drop-in for the engine's pending deque:
  per-level sub-queues drained by weighted round-robin (weights
  ``2^(L-1-i)``), so a light tenant's request overtakes a heavy tenant's
  backlog at admission. Preempted requests ride an urgent lane that
  always re-admits first.
- ``QoSGate``: the shed decision at the door: under overload (engine
  queue past ``serving.qos.shed.queue.depth``) over-share tenants get
  ``429 + Retry-After`` instead of a queue slot; past
  ``serving.qos.queue.max`` everyone sheds. Shed/admit counters feed
  ``/prom``.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional

from hadoop_tpu_torch.conf import ConfLike, Configuration

ENABLED_KEY = "serving.qos.enabled"
LEVELS_KEY = "serving.qos.levels"
DECAY_PERIOD_KEY = "serving.qos.decay.period"
DECAY_FACTOR_KEY = "serving.qos.decay.factor"
THRESHOLDS_KEY = "serving.qos.thresholds"
SHED_QUEUE_KEY = "serving.qos.shed.queue.depth"
HARD_QUEUE_KEY = "serving.qos.queue.max"
RETRY_AFTER_KEY = "serving.qos.retry.after"

DEFAULT_TENANT = "anonymous"


class DecayCostScheduler:
    """Per-tenant decayed cost accounting → priority level.

    The serving twin of ``ipc.callqueue.DecayRpcScheduler`` (same decay
    loop, same share thresholds), except ``charge`` takes an explicit
    cost — a 4k-token prefill and a 3-token probe are not the same unit
    of work, and counting calls would let a megaprompt tenant look
    light. Shed requests are charged too: demand is demand, and a
    shedding tenant that retries in a tight loop must not decay its way
    back to priority 0 while doing so.
    """

    def __init__(self, num_levels: int = 4,
                 conf: Optional[ConfLike] = None):
        conf = conf or Configuration(load_defaults=False)
        self.num_levels = max(2, int(num_levels))
        self.decay_period_s = conf.get_time_seconds(DECAY_PERIOD_KEY, 5.0)
        self.decay_factor = conf.get_float(DECAY_FACTOR_KEY, 0.5)
        raw = conf.get_list(THRESHOLDS_KEY)
        if raw:
            self.thresholds = [float(t) for t in raw]
        else:
            self.thresholds = [1.0 / (2 ** (self.num_levels - i))
                               for i in range(1, self.num_levels)]
        self._costs: Dict[str, float] = {}   # guarded-by: _lock
        self._total = 0.0                    # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._decay_loop, daemon=True,
                         name="qos-decay").start()

    def _decay_loop(self) -> None:
        # fixed-cadence decay tick, not a retry loop: jitter here would
        # skew every tenant's share identically and buys nothing
        while not self._stop.wait(self.decay_period_s):
            with self._lock:
                dead = []
                self._total = 0.0
                for tenant, cost in self._costs.items():
                    cost *= self.decay_factor
                    if cost < 0.5:
                        dead.append(tenant)
                    else:
                        self._costs[tenant] = cost
                        self._total += cost
                for tenant in dead:
                    del self._costs[tenant]

    def charge(self, tenant: str, cost: float) -> None:
        cost = max(1.0, float(cost))
        with self._lock:
            self._costs[tenant] = self._costs.get(tenant, 0.0) + cost
            self._total += cost

    def share_of(self, tenant: str) -> float:
        with self._lock:
            if not self._total:
                return 0.0
            return self._costs.get(tenant, 0.0) / self._total

    def level_of(self, tenant: str) -> int:
        share = self.share_of(tenant)
        level = 0
        for i, th in enumerate(self.thresholds):
            if share >= th:
                level = i + 1
        return min(level, self.num_levels - 1)

    @property
    def num_tenants(self) -> int:
        with self._lock:
            return len(self._costs)

    def snapshot(self) -> dict:
        with self._lock:
            return {"total": self._total, "tenants": dict(self._costs)}

    def stop(self) -> None:
        self._stop.set()


class FairAdmissionQueue:
    """Weighted-round-robin admission queue, deque-compatible with the
    engine's pending queue (``append``/``appendleft``/``popleft``/
    ``len``/``[0]`` — every call happens on the engine's paths under its
    scheduler condition, so the queue needs no lock of its own).

    Requests land in the sub-queue of their tenant's priority level at
    submit time (the FairCallQueue contract: priority is assigned at
    put) and are drained by weighted round-robin — level 0 gets
    ``2^(L-1)`` takes per cycle, the heaviest level 1 — so every level
    always eventually drains (no starvation) but light tenants overtake
    a heavy tenant's parked backlog. ``appendleft`` (the engine's
    preemption re-queue) rides an urgent lane that always pops first:
    a preempted request was already running, and fairness must not
    reorder the engine's recompute-resume contract.
    """

    def __init__(self, scheduler: DecayCostScheduler):
        self.sched = scheduler
        L = scheduler.num_levels
        self._levels: List[deque] = [deque() for _ in range(L)]
        self._urgent: deque = deque()
        self._weights = [2 ** (L - 1 - i) for i in range(L)]
        self._rr_level = 0
        self._rr_credit = self._weights[0]
        self._size = 0
        # the last [0] peek, pinned: the engine peeks, drops the lock
        # for allocation (new requests can append meanwhile — possibly
        # into a lighter, now-preferred level), then pops. The pop MUST
        # return the peeked request or the engine admits one request
        # and silently discards another (its client would hang forever)
        self._peeked: Optional[tuple] = None    # (lane, req)

    def __len__(self) -> int:
        return self._size

    def append(self, req) -> None:
        lvl = self.sched.level_of(
            getattr(req, "tenant", "") or DEFAULT_TENANT)
        self._levels[lvl].append(req)
        self._size += 1

    def appendleft(self, req) -> None:
        self._urgent.appendleft(req)
        self._size += 1

    def _choose(self) -> Optional[int]:
        """The level the next pop comes from (-1 = urgent lane), chosen
        WITHOUT mutating round-robin state — deterministic, so the
        engine's peek-then-pop (``[0]`` then ``popleft`` with no pops in
        between) always sees the same request."""
        if self._urgent:
            return -1
        lvl, credit = self._rr_level, self._rr_credit
        for _ in range(2 * len(self._levels)):
            if credit > 0 and self._levels[lvl]:
                return lvl
            lvl = (lvl + 1) % len(self._levels)
            credit = self._weights[lvl]
        for i, q in enumerate(self._levels):   # exhausted credits: scan
            if q:
                return i
        return None

    def __getitem__(self, i: int):
        if i != 0:
            raise IndexError("admission queue exposes only the head")
        c = self._choose()
        if c is None:
            raise IndexError("empty admission queue")
        req = self._urgent[0] if c == -1 else self._levels[c][0]
        self._peeked = (c, req)
        return req

    def _commit(self, c: int):
        """Pop from lane ``c``, advancing the WRR cursor the way
        ``_choose`` walked to it."""
        self._size -= 1
        if c == -1:
            return self._urgent.popleft()
        for _ in range(2 * len(self._levels)):
            if self._rr_level == c and self._rr_credit > 0:
                break
            self._rr_level = (self._rr_level + 1) % len(self._levels)
            self._rr_credit = self._weights[self._rr_level]
        if self._rr_level != c:                # starvation-scan pick
            self._rr_level = c
            self._rr_credit = self._weights[c]
        self._rr_credit -= 1
        return self._levels[c].popleft()

    def popleft(self):
        if self._peeked is not None:
            c, req = self._peeked
            self._peeked = None
            lane = self._urgent if c == -1 else self._levels[c]
            if lane and lane[0] is req:
                return self._commit(c)
        c = self._choose()
        if c is None:
            raise IndexError("pop from empty admission queue")
        self._peeked = None
        return self._commit(c)


class QoSGate:
    """The shed decision at the door, consulted before every
    ``engine.submit``. Admits freely below the overload line; between
    the overload line and the hard cap only tenants at priority 0
    (under-share) may queue; past the hard cap everyone sheds. Shedding
    requires at least two tracked tenants — fairness needs someone to
    be unfair TO, and shedding a deployment's only tenant would turn
    overload into an outage instead of a queue."""

    def __init__(self, conf: ConfLike, engine, metrics=None,
                 scheduler: Optional[DecayCostScheduler] = None):
        self.engine = engine
        self.metrics = metrics
        self.sched = scheduler or DecayCostScheduler(
            conf.get_int(LEVELS_KEY, 4), conf)
        self.shed_depth = conf.get_int(SHED_QUEUE_KEY, 32)
        self.hard_max = conf.get_int(HARD_QUEUE_KEY, 256)
        self.retry_after_s = conf.get_time_seconds(RETRY_AFTER_KEY, 1.0)
        self.admitted = 0                     # guarded-by: _lock
        self.sheds = 0                        # guarded-by: _lock
        self.sheds_by_tenant: Dict[str, int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    @staticmethod
    def cost_of(tokens, max_new_tokens: int) -> float:
        """Tokens of work the request demands — prompt prefill plus the
        requested decode budget."""
        return float(len(tokens) + max(1, int(max_new_tokens)))

    def admit(self, tenant: str, cost: float):
        """Returns ``(admitted, retry_after_s, level)``. Charges the
        tenant either way (see DecayCostScheduler)."""
        tenant = tenant or DEFAULT_TENANT
        self.sched.charge(tenant, cost)
        level = self.sched.level_of(tenant)
        depth = self.engine.queue_depth
        shed = depth >= self.hard_max or (
            depth >= self.shed_depth and level > 0
            and self.sched.num_tenants > 1)
        with self._lock:
            if shed:
                self.sheds += 1
                self.sheds_by_tenant[tenant] = \
                    self.sheds_by_tenant.get(tenant, 0) + 1
            else:
                self.admitted += 1
        if self.metrics:
            if shed:
                self.metrics.qos_shed.incr()
            else:
                self.metrics.qos_admitted.incr()
            self.metrics.qos_tenants.set(self.sched.num_tenants)
        if shed:
            # heavier tenants wait longer before retrying: the door's
            # Retry-After is the fleet-wide pushback signal the router
            # honors before its next pick
            return False, self.retry_after_s * (1 + level), level
        return True, 0.0, level

    def stats(self) -> dict:
        with self._lock:
            return {
                "admitted": self.admitted,
                "sheds": self.sheds,
                "sheds_by_tenant": dict(self.sheds_by_tenant),
                "tenants": self.sched.num_tenants,
                "shed_queue_depth": self.shed_depth,
                "queue_max": self.hard_max,
            }

    def stop(self) -> None:
        self.sched.stop()
