"""Trainer-side elastic controller: the fleet doctor's verdicts turned
into mesh decisions.

The counterpart of ``hadoop_tpu/parallel/elastic/controller.py``. Every
``elastic.poll.steps`` trainer steps the controller reads the doctor's
trainer verdicts (the ``trainers`` section of ``/ws/v1/fleet/doctor``:
flagged stragglers and the roster's dead ranks) and turns streaks into
three decisions:

- **DEMOTE**: a rank flagged ``elastic.demote.windows`` polls in a row.
  The trainer writes a protective checkpoint now, while the straggler
  still runs, so an eviction resumes from here and not from the last
  interval save.
- **EVICT**: flagged ``elastic.evict.windows`` polls, or dead
  ``elastic.dead.windows`` polls. The controller picks the largest
  healthy sub-mesh (``pick_shrunken_plan``: non-power-of-two dp
  included) and marks it pending; the trainer ends its step segment.
- **RESUME**: the trainer applies the pending plan (``apply_plan``:
  fence, rebuild, reshard-restore the newest snapshot); the lost steps
  and the wall time are recorded, then ``elastic.cooldown.polls`` polls
  of hysteresis follow.

Each decision is an event (with the ``ElasticConfig`` that made it, via
``dataclasses.asdict``) on the ``htpu_elastic_*`` counters of the port's
``metrics_system()`` and in ``report()``. A poll that fails is logged and
skipped, as in the reference: the next poll retries.

On a mesh every rank runs its own controller on the same reports (the
trainer's rank 0 polls and broadcasts), so every rank takes the same
decision at the same step. The controller also keeps the process ranks
(the roster rows' ``rank``) of the ranks it evicted, which the trainer
leaves out of the shrunken mesh; on an evicted rank's own process the
resume records a "leave" event instead (it runs no more steps).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from typing import Any, Callable, Dict, List, Optional

from hadoop_tpu_torch.http import http_get
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.parallel.elastic import ElasticConfig
from hadoop_tpu_torch.parallel.mesh import MeshPlan

log = logging.getLogger(__name__)

MAX_EVENTS = 256   # bounded event ring for report()


def doctor_http_poll(host: str, port: int,
                     timeout: float = 5.0) -> Callable[[], Dict]:
    """A poll function reading the fleet doctor's HTTP report."""
    def poll() -> Dict:
        return json.loads(http_get(host, port, "/ws/v1/fleet/doctor",
                                   timeout).decode())
    return poll


def pick_shrunken_plan(plan: MeshPlan, healthy: int, batch: int,
                       min_dp: int) -> Optional[MeshPlan]:
    """The largest healthy sub-mesh: only dp shrinks (the other axes
    shape the model's math), to the largest dp' ≤ ``healthy`` with
    ``batch % (dp' * ep) == 0`` and dp' ≥ ``min_dp``. None if there is
    none."""
    for d in range(min(plan.dp, healthy), min_dp - 1, -1):
        if d >= 1 and batch % (d * plan.ep) == 0:
            return dataclasses.replace(plan, dp=d)
    return None


class ElasticController:
    """Streak bookkeeping and decisions for one trainer.

    ``trainer`` needs ``.plan``, ``.step``, ``.batch``,
    ``.save(wait=False)`` and ``.apply_plan(plan) -> bool`` (the
    ``Trainer``'s; tests duck-type it). ``poll_fn`` returns the doctor's
    report dict (see :func:`doctor_http_poll`)."""

    def __init__(self, trainer, cfg: ElasticConfig, *,
                 poll_fn: Callable[[], Dict]):
        if poll_fn is None:
            raise ValueError("ElasticController needs a poll_fn (use "
                             "doctor_http_poll for a live doctor)")
        self.trainer = trainer
        self.cfg = cfg
        self._poll_fn = poll_fn
        self._flagged_streak: Dict[str, int] = {}
        self._dead_streak: Dict[str, int] = {}
        self._demoted: set = set()
        # ranks already evicted: their roster rows linger and must never
        # evict capacity that is already gone
        self._evicted_ranks: set = set()
        # and their process ranks, which the trainer's mesh leaves out
        self.evicted_process_ranks: set = set()
        self._cooldown = 0
        self._pending_plan: Optional[MeshPlan] = None
        self._pending_ranks: List[str] = []
        self._pending_ids: List[int] = []
        self.events: List[Dict[str, Any]] = []
        reg = metrics_system().source("elastic")
        self._m_polls = reg.counter(
            "polls", "doctor polls taken by the elastic controller",
            prom_name="htpu_elastic_polls")
        self._m_demotes = reg.counter(
            "demotes", "protective checkpoints on flagged-rank streaks",
            prom_name="htpu_elastic_demotes")
        self._m_evictions = reg.counter(
            "evictions", "ranks evicted from the mesh",
            prom_name="htpu_elastic_evictions")
        self._m_resumes = reg.counter(
            "resumes", "reshard-on-restore resumes completed",
            prom_name="htpu_elastic_resumes")
        self._m_lost_steps = reg.counter(
            "lost_steps", "steps re-run after elastic resumes",
            prom_name="htpu_elastic_lost_steps")
        self._m_resume_seconds = reg.counter(
            "resume_seconds", "wall seconds spent in elastic resumes",
            prom_name="htpu_elastic_resume_seconds")

    # ------------------------------------------------------------ events

    def _event(self, decision: str, step: int, **detail) -> Dict:
        ev = {"decision": decision, "step": int(step),
              "time": time.time(),
              "config": dataclasses.asdict(self.cfg)}
        ev.update(detail)
        self.events.append(ev)
        del self.events[:-MAX_EVENTS]
        log.info("elastic %s at step %d: %s", decision, step, detail)
        return ev

    # ------------------------------------------------------------- polls

    def on_step(self, step: int) -> bool:
        """One poll and decision. Returns True while an evict decision is
        pending: the trainer must end its step segment and call
        :meth:`resume`."""
        if self._pending_plan is not None:
            return True
        try:
            report = self._poll_fn()
        except Exception as e:  # noqa: BLE001 — an unreachable doctor
            # must not stop training; the next poll retries
            log.warning("elastic doctor poll failed: %s", e)
            return False
        self._m_polls.incr()
        trainers = (report or {}).get("trainers") or {}
        flagged = set(trainers.get("flagged") or ()) \
            - self._evicted_ranks
        roster = trainers.get("ranks") or {}
        dead = {name for name, row in roster.items()
                if not row.get("ok")} - self._evicted_ranks
        for name in list(self._flagged_streak):
            if name not in flagged:
                self._flagged_streak.pop(name)
                self._demoted.discard(name)
        for name in flagged:
            self._flagged_streak[name] = \
                self._flagged_streak.get(name, 0) + 1
        for name in list(self._dead_streak):
            if name not in dead:
                self._dead_streak.pop(name)
        for name in dead:
            self._dead_streak[name] = self._dead_streak.get(name, 0) + 1
        if self._cooldown > 0:
            self._cooldown -= 1
            return False

        evict = sorted(
            {n for n, s in self._dead_streak.items()
             if s >= self.cfg.dead_windows} |
            {n for n, s in self._flagged_streak.items()
             if s >= self.cfg.evict_windows})
        if evict:
            return self._decide_evict(step, evict, roster, dead)

        for name in sorted(flagged):
            if self._flagged_streak[name] >= self.cfg.demote_windows \
                    and name not in self._demoted:
                self._demoted.add(name)
                self._demote(step, name)
        return False

    # --------------------------------------------------------- decisions

    def _demote(self, step: int, rank: str) -> None:
        """A protective checkpoint while the straggler still runs."""
        self.trainer.save(wait=False)
        self._m_demotes.incr()
        self._event("demote", step, rank=rank,
                    streak=self._flagged_streak.get(rank, 0),
                    snapshot_step=int(step))

    def _decide_evict(self, step: int, ranks: List[str], roster: Dict,
                      dead: set) -> bool:
        plan = self.trainer.plan
        if roster:
            healthy = sum(1 for name, row in roster.items()
                          if row.get("ok") and name not in ranks)
        else:
            # a doctor without a roster: one rank a dp slice
            healthy = plan.dp - len(ranks)
        new_plan = pick_shrunken_plan(plan, healthy, self.trainer.batch,
                                      self.cfg.min_dp)
        if new_plan is None:
            self._event("evict-infeasible", step, ranks=ranks,
                        healthy=healthy, plan=dataclasses.asdict(plan))
            raise RuntimeError(
                f"elastic eviction of {ranks} leaves {healthy} healthy "
                f"ranks but no dp in [{self.cfg.min_dp}, {plan.dp}] "
                f"divides batch={self.trainer.batch} (ep={plan.ep})")
        self._m_evictions.incr(len(ranks))
        self._event("evict", step, ranks=ranks, healthy=healthy,
                    dead=sorted(dead),
                    plan_from=dataclasses.asdict(plan),
                    plan_to=dataclasses.asdict(new_plan))
        self._pending_plan = new_plan
        self._pending_ranks = list(ranks)
        self._pending_ids = [int(roster[n]["rank"]) for n in ranks
                             if roster.get(n, {}).get("rank") is not None]
        return True

    def resume(self) -> bool:
        """Apply the pending evict decision through the trainer's
        ``apply_plan`` (between step segments, never under a running
        prefetch thread). Returns whether a snapshot was restored."""
        plan = self._pending_plan
        if plan is None:
            return False
        self._pending_plan = None
        ranks, self._pending_ranks = self._pending_ranks, []
        self._evicted_ranks.update(ranks)
        self.evicted_process_ranks.update(self._pending_ids)
        self._pending_ids = []
        step_before = int(self.trainer.step)
        t0 = time.monotonic()
        restored = self.trainer.apply_plan(plan)
        resume_s = time.monotonic() - t0
        if getattr(self.trainer, "left_mesh", False):
            # this process was evicted: it left the mesh and stops
            self._event("leave", step_before, ranks=ranks,
                        plan_to=dataclasses.asdict(plan))
            return False
        lost = step_before - int(self.trainer.step) if restored \
            else step_before
        self._m_resumes.incr()
        self._m_lost_steps.incr(int(lost))
        self._m_resume_seconds.incr(int(round(resume_s)))
        self._event("resume", self.trainer.step, ranks=ranks,
                    restored=bool(restored), lost_steps=int(lost),
                    resume_seconds=round(resume_s, 3),
                    plan_to=dataclasses.asdict(plan))
        self._cooldown = self.cfg.cooldown_polls
        self._flagged_streak.clear()
        self._dead_streak.clear()
        self._demoted.clear()
        return bool(restored)

    @property
    def pending(self) -> bool:
        return self._pending_plan is not None

    # ------------------------------------------------------------ report

    def report(self) -> Dict[str, Any]:
        """The trainer's elastic block (the reference's
        ``/ws/v1/trainer`` one)."""
        return {
            "enabled": self.cfg.enabled,
            "config": dataclasses.asdict(self.cfg),
            "plan": dataclasses.asdict(self.trainer.plan),
            "cooldown": self._cooldown,
            "flagged_streaks": dict(self._flagged_streak),
            "dead_streaks": dict(self._dead_streak),
            "evicted_ranks": sorted(self._evicted_ranks),
            "events": list(self.events[-32:]),
        }
