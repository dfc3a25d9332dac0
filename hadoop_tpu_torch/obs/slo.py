"""The bounded tenant classes, and the fleet SLO scoreboard over them.

The port's copy of ``hadoop_tpu/obs/slo.py``. The serving door stamps
each request with a class of p0..p3 (p0 the under-share, interactive end
of the QoS decay ladder, p3 the over-share end; deeper ladders clamp into
p3, so every ``htpu_slo_*`` family keeps a closed label set): the
level-to-class map, and the ``obs.slo.class.map`` identity map
(``"tenant=class,tenant=class"``) that pins a tenant's class.

:class:`SloScoreboard` is the fleet doctor's judge of those families:
each poll ``observe`` diffs an endpoint's cumulative class-labeled
``/prom`` families against its last (a counter that fell means the
replica restarted: its whole history is this window), and ``commit``
merges the poll's deltas into one fleet window, forgets endpoints that
left, and computes per class over the last ``obs.slo.window.fast`` and
``obs.slo.window.slow`` polls: availability ``ok / (ok + shed +
failed)``, TTFT and per-token p99 against ``obs.slo.<class>.ttft.p99.ms``
/ ``.token.p99.ms``, and the error-budget burn ``(1 - availability) /
(1 - obs.slo.<class>.availability)`` in both windows, ``burning`` once
both pass ``obs.slo.burn.fast`` / ``.slow`` in ``obs.slo.burn.min-
windows`` of the last ``obs.slo.burn.history`` polls. No clock feeds a
verdict: polls are the clock.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Deque, Dict, Iterable, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike
from hadoop_tpu_torch.serving.autoscale.signals import histogram_p99

log = logging.getLogger(__name__)

SLO_CLASSES = ("p0", "p1", "p2", "p3")

CLASS_MAP_KEY = "obs.slo.class.map"

# the /prom families the serving door's metrics write
TTFT_FAMILY = "htpu_slo_ttft_seconds"
TOKEN_FAMILY = "htpu_slo_token_seconds"
REQUESTS_FAMILY = "htpu_slo_requests_total"

_OUTCOMES = ("ok", "shed", "failed")


def slo_class_of(level: int) -> str:
    """Map a DecayCostScheduler level onto the bounded class set."""
    return SLO_CLASSES[min(max(level, 0), len(SLO_CLASSES) - 1)]


def parse_class_map(conf) -> Dict[str, str]:
    """``obs.slo.class.map`` from ``conf`` (a ``ConfLike``). Entries that
    name a class outside :data:`SLO_CLASSES` are dropped with a warning."""
    out: Dict[str, str] = {}
    raw = (conf.get(CLASS_MAP_KEY, "") or "").strip()
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, cls = (s.strip() for s in part.split("=", 1))
        if tenant and cls in SLO_CLASSES:
            out[tenant] = cls
        elif tenant:
            log.warning("slo: class map entry %r names unknown class "
                        "%r (known: %s) -- ignored", tenant, cls,
                        ",".join(SLO_CLASSES))
    return out


class SloTargets:
    """Per-class conf'd targets (registered keys; see README)."""

    def __init__(self, conf: ConfLike):
        self.ttft_p99_ms: Dict[str, float] = {}
        self.token_p99_ms: Dict[str, float] = {}
        self.availability: Dict[str, float] = {}
        for cls in ("p0", "p1", "p2", "p3"):
            self.ttft_p99_ms[cls] = conf.get_float(
                f"obs.slo.{cls}.ttft.p99.ms", 2000.0)
            self.token_p99_ms[cls] = conf.get_float(
                f"obs.slo.{cls}.token.p99.ms", 500.0)
            self.availability[cls] = conf.get_float(
                f"obs.slo.{cls}.availability", 0.99)

    def as_dict(self, cls: str) -> Dict[str, float]:
        return {"ttft_p99_ms": self.ttft_p99_ms[cls],
                "token_p99_ms": self.token_p99_ms[cls],
                "availability": self.availability[cls]}


class _ClassWindow:
    """One class's deltas for one poll window (merged across the
    fleet)."""

    __slots__ = ("ttft_buckets", "ttft_count", "token_buckets",
                 "token_count", "outcomes")

    def __init__(self):
        self.ttft_buckets: Dict[float, float] = {}
        self.ttft_count = 0.0
        self.token_buckets: Dict[float, float] = {}
        self.token_count = 0.0
        self.outcomes: Dict[str, float] = {o: 0.0 for o in _OUTCOMES}


def _merge_buckets(into: Dict[float, float],
                   delta: Dict[float, float]) -> None:
    for le, d in delta.items():
        into[le] = into.get(le, 0.0) + d


def _sum_windows(windows: Iterable[_ClassWindow]
                 ) -> Tuple[Dict[float, float], float,
                            Dict[float, float], float,
                            Dict[str, float]]:
    tb: Dict[float, float] = {}
    tc = 0.0
    kb: Dict[float, float] = {}
    kc = 0.0
    oc: Dict[str, float] = {o: 0.0 for o in _OUTCOMES}
    for w in windows:
        _merge_buckets(tb, w.ttft_buckets)
        tc += w.ttft_count
        _merge_buckets(kb, w.token_buckets)
        kc += w.token_count
        for o in _OUTCOMES:
            oc[o] += w.outcomes[o]
    return tb, tc, kb, kc, oc


class SloScoreboard:
    """Fleet SLO scoreboard over the doctor's replica scrapes.

    Drive it one poll at a time::

        for ep, fams in scraped:          # parsed /prom families
            sb.observe(ep, fams)
        report = sb.commit(seen)          # end of poll: window + math

    ``observe`` diffs each endpoint's cumulative class-labeled
    families against its stored baseline (counter reset => the whole
    history is this window, matching a replica restart); ``commit``
    merges the poll's per-class deltas into one fleet window, prunes
    endpoints that left the registry, and recomputes the report.
    """

    def __init__(self, conf: ConfLike):
        self.targets = SloTargets(conf)
        # window sizes in POLLS, not seconds -- the doctor's poll
        # period is the clock, so tests pump polls instead of sleeping
        self.fast = max(1, conf.get_int("obs.slo.window.fast", 3))
        self.slow = max(self.fast, conf.get_int("obs.slo.window.slow",
                                                12))
        self.burn_fast_x = conf.get_float("obs.slo.burn.fast", 14.0)
        self.burn_slow_x = conf.get_float("obs.slo.burn.slow", 2.0)
        self.history = max(1, conf.get_int("obs.slo.burn.history", 5))
        self.min_windows = max(1, conf.get_int(
            "obs.slo.burn.min-windows", 2))
        self._lock = threading.Lock()
        # endpoint -> class -> (ttft buckets, ttft count,
        #                       token buckets, token count, outcomes)
        self._prev: Dict[str, Dict[str, Tuple[Dict[float, float],
                                              float,
                                              Dict[float, float],
                                              float,
                                              Dict[str, float]]]] = {}
        # this poll's accumulating deltas (between observe and commit)
        self._pending: Dict[str, _ClassWindow] = {}
        self._windows: Deque[Dict[str, _ClassWindow]] = deque(
            maxlen=self.slow)
        # hysteresis: per class, the last `history` polls' burn flags
        self._flags: Dict[str, Deque[bool]] = {
            cls: deque(maxlen=self.history) for cls in SLO_CLASSES}
        self._report: Dict[str, object] = {"classes": {},
                                           "windows_seen": 0}

    # ---------------------------------------------------- ingestion

    def observe(self, endpoint: str,
                fams: Dict[str, List[Tuple[Dict[str, str], float]]]
                ) -> None:
        """Feed one endpoint's parsed ``/prom`` families for this
        poll."""
        cur = self._extract(fams)
        with self._lock:
            prev = self._prev.get(endpoint, {})
            for cls, (tb, tc, kb, kc, oc) in cur.items():
                ptb, ptc, pkb, pkc, poc = prev.get(
                    cls, ({}, 0.0, {}, 0.0,
                          {o: 0.0 for o in _OUTCOMES}))
                # counter reset => the endpoint restarted; its whole
                # history belongs to this window (FleetScraper rule)
                if (tc < ptc or kc < pkc
                        or any(oc[o] < poc.get(o, 0.0)
                               for o in _OUTCOMES)):
                    ptb, ptc, pkb, pkc = {}, 0.0, {}, 0.0
                    poc = {o: 0.0 for o in _OUTCOMES}
                win = self._pending.setdefault(cls, _ClassWindow())
                _merge_buckets(win.ttft_buckets,
                               {le: v - ptb.get(le, 0.0)
                                for le, v in tb.items()})
                win.ttft_count += tc - ptc
                _merge_buckets(win.token_buckets,
                               {le: v - pkb.get(le, 0.0)
                                for le, v in kb.items()})
                win.token_count += kc - pkc
                for o in _OUTCOMES:
                    win.outcomes[o] += oc[o] - poc.get(o, 0.0)
            self._prev[endpoint] = cur

    @staticmethod
    def _extract(fams: Dict[str, List[Tuple[Dict[str, str], float]]]
                 ) -> Dict[str, Tuple[Dict[float, float], float,
                                      Dict[float, float], float,
                                      Dict[str, float]]]:
        out: Dict[str, Tuple[Dict[float, float], float,
                             Dict[float, float], float,
                             Dict[str, float]]] = {}

        def row(cls: str):
            if cls not in out:
                out[cls] = ({}, 0.0, {}, 0.0,
                            {o: 0.0 for o in _OUTCOMES})
            return out[cls]

        for fam, which in ((TTFT_FAMILY + "_bucket", "ttft"),
                           (TOKEN_FAMILY + "_bucket", "token")):
            for labels, value in fams.get(fam, []):
                cls = labels.get("class", "")
                if cls not in SLO_CLASSES:
                    continue
                try:
                    le = float(labels.get("le", "nan"))
                except ValueError:
                    continue
                r = row(cls)
                buckets = r[0] if which == "ttft" else r[2]
                buckets[le] = buckets.get(le, 0.0) + value
        for fam, which in ((TTFT_FAMILY + "_count", "ttft"),
                           (TOKEN_FAMILY + "_count", "token")):
            for labels, value in fams.get(fam, []):
                cls = labels.get("class", "")
                if cls not in SLO_CLASSES:
                    continue
                tb, tc, kb, kc, oc = row(cls)
                if which == "ttft":
                    tc += value
                else:
                    kc += value
                out[cls] = (tb, tc, kb, kc, oc)
        for labels, value in fams.get(REQUESTS_FAMILY, []):
            cls = labels.get("class", "")
            outcome = labels.get("outcome", "")
            if cls not in SLO_CLASSES or outcome not in _OUTCOMES:
                continue
            r = row(cls)
            r[4][outcome] = r[4].get(outcome, 0.0) + value
        return out

    # ------------------------------------------------------ windows

    def prune(self, seen: Iterable[str]) -> None:
        """Forget endpoints that left the registry (their counters
        must not replay as negative deltas if the address returns)."""
        keep = set(seen)
        with self._lock:
            for ep in list(self._prev):
                if ep not in keep:
                    del self._prev[ep]

    def commit(self, seen: Optional[Iterable[str]] = None
               ) -> Dict[str, object]:
        """Close the poll: merge pending deltas into one fleet window,
        prune departed endpoints, recompute the report."""
        if seen is not None:
            self.prune(seen)
        with self._lock:
            pending, self._pending = self._pending, {}
            if not pending and not self._prev:
                # nothing scraped and nobody known: not a window --
                # an empty fleet must not age out standing verdicts
                return dict(self._report)
            self._windows.append(pending)
            self._report = self._compute()
            return dict(self._report)

    # --------------------------------------------------------- math

    def _percentile(self, buckets: Dict[float, float], q: float
                    ) -> Optional[float]:
        return histogram_p99(buckets, q)

    def _compute(self) -> Dict[str, object]:
        windows = list(self._windows)
        classes: Dict[str, Dict[str, object]] = {}
        for cls in SLO_CLASSES:
            fast = [w[cls] for w in windows[-self.fast:] if cls in w]
            slow = [w[cls] for w in windows[-self.slow:] if cls in w]
            tb, tc, kb, kc, oc = _sum_windows(fast)
            _, _, _, _, oc_slow = _sum_windows(slow)

            def avail(counts: Dict[str, float]) -> Optional[float]:
                total = sum(counts.values())
                if total <= 0:
                    return None
                return counts["ok"] / total

            av_fast = avail(oc)
            av_slow = avail(oc_slow)
            budget = max(1e-9, 1.0 - self.targets.availability[cls])
            burn_fast = (0.0 if av_fast is None
                         else (1.0 - av_fast) / budget)
            burn_slow = (0.0 if av_slow is None
                         else (1.0 - av_slow) / budget)
            # multi-window rule: both the fast and the slow window
            # must be burning -- a brief spike (fast only) or stale
            # history (slow only) does not flag
            burning_now = (burn_fast >= self.burn_fast_x
                           and burn_slow >= self.burn_slow_x)
            self._flags[cls].append(burning_now)
            burning = (sum(self._flags[cls]) >= self.min_windows)

            ttft_p99_s = self._percentile(tb, 0.99) if tc > 0 else None
            token_p99_s = (self._percentile(kb, 0.99)
                           if kc > 0 else None)
            ttft_ms = None if ttft_p99_s is None else ttft_p99_s * 1e3
            token_ms = (None if token_p99_s is None
                        else token_p99_s * 1e3)
            classes[cls] = {
                "targets": self.targets.as_dict(cls),
                "window": {o: oc[o] for o in _OUTCOMES},
                "availability": av_fast,
                "availability_slow": av_slow,
                "ttft_p99_ms": ttft_ms,
                "ttft_attained": (None if ttft_ms is None else
                                  ttft_ms
                                  <= self.targets.ttft_p99_ms[cls]),
                "token_p99_ms": token_ms,
                "token_attained": (None if token_ms is None else
                                   token_ms
                                   <= self.targets.token_p99_ms[cls]),
                "burn_fast": burn_fast,
                "burn_slow": burn_slow,
                "burning": burning,
            }
        return {"classes": classes,
                "windows_seen": len(windows),
                "window_polls": {"fast": self.fast,
                                 "slow": self.slow},
                "burn_thresholds": {"fast": self.burn_fast_x,
                                    "slow": self.burn_slow_x}}

    # ------------------------------------------------------- report

    def report(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._report)

    def burning_classes(self) -> List[str]:
        rep = self.report()
        classes = rep.get("classes") or {}
        return sorted(cls for cls, row in classes.items()  # type: ignore[union-attr]
                      if row.get("burning"))
