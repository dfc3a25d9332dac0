"""The fleet signal plane of the SLO autoscaler.

The port's copy of ``hadoop_tpu/serving/autoscale/signals.py``. One poll
is one :class:`FleetSnapshot`: the registry names the members, each
member's door is scraped for its load (``/v1/health``: queue depth,
active slots, prefill backlog, cache residency), and ``/prom`` supplies
the SLO histograms. TTFT p99 is computed over the window since the
previous poll, by differencing each endpoint's cumulative histogram
buckets and merging the deltas across the fleet: the autoscaler reacts
to the last few seconds, not to a lifetime average.

Every scrape has a bounded timeout (``serving.autoscale.scrape.timeout``,
through the port's ``http.http_get``): a wedged replica is itself a
signal (``ok=False``), never a stall in the control loop.
"""

from __future__ import annotations

import json
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.http import http_get

log = logging.getLogger(__name__)

SCRAPE_TIMEOUT_KEY = "serving.autoscale.scrape.timeout"

TTFT_FAMILY = "htpu_time_to_first_token_seconds"
SHED_FAMILY = "htpu_qos_shed_total"


def parse_prom(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Minimal Prometheus text-exposition parser: sample name →
    [(labels, value)]. Enough for the families the autoscaler reads;
    unparseable lines are skipped (a scraper must never die on one
    daemon's odd metric)."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # histogram _bucket lines may carry an OpenMetrics exemplar
        # suffix ('value # {trace_id="..."} ex_value ts') — strip it, or
        # float(valstr) below rejects the line and the autoscaler loses
        # exactly the TTFT buckets it scales on
        if " # " in line:
            line = line.split(" # ", 1)[0].rstrip()
        try:
            if "{" in line:
                name, rest = line.split("{", 1)
                labelstr, valstr = rest.rsplit("}", 1)
                labels = {}
                for part in labelstr.split(","):
                    if not part:
                        continue
                    k, _, v = part.partition("=")
                    labels[k.strip()] = v.strip().strip('"')
            else:
                name, _, valstr = line.rpartition(" ")
                labels = {}
            out.setdefault(name.strip(), []).append(
                (labels, float(valstr.strip())))
        except ValueError:
            continue
    return out


def histogram_p99(buckets: Dict[float, float], q: float = 0.99
                  ) -> Optional[float]:
    """Quantile estimate from cumulative ``{le_bound: count}`` buckets
    (linear interpolation inside the winning bucket — the standard
    ``histogram_quantile`` estimator). None when the window saw no
    samples."""
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for b in bounds:
        cum = buckets[b]
        if cum >= target:
            if math.isinf(b):
                return prev_bound        # the overflow bucket has no
                #                          upper edge to interpolate to
            span = cum - prev_cum
            frac = (target - prev_cum) / span if span > 0 else 1.0
            return prev_bound + (b - prev_bound) * frac
        prev_bound, prev_cum = b, cum
    return bounds[-1] if not math.isinf(bounds[-1]) else prev_bound


@dataclass
class ReplicaSample:
    """One replica's registry record + door scrape for one poll."""
    path: str
    host: str
    port: int
    role: str = "mixed"
    load_seconds: float = 0.0
    ok: bool = False
    error: str = ""
    draining: bool = False
    queue_depth: int = 0
    active: int = 0
    slots: int = 0
    prefilling: int = 0
    prefill_backlog: int = 0
    cached_blocks: int = 0
    hits_dfs: int = 0
    qos_sheds: int = 0


@dataclass
class FleetSnapshot:
    """Everything one control-loop iteration decides from."""
    at: float
    samples: List[ReplicaSample] = field(default_factory=list)
    ttft_p99_s: Optional[float] = None   # over the inter-poll window
    ttft_samples: int = 0
    shed_delta: int = 0                  # 429s since the previous poll
    scrape_failures: int = 0

    def pool(self, role: str) -> List[ReplicaSample]:
        """Live members of one scaling pool: ``prefill`` is the strict
        prefill role; ``decode`` is everything else (mixed replicas
        decode). Draining replicas are mid-retirement — they belong to
        no pool, or scale-in would count its own victim and shrink
        twice."""
        if role == "prefill":
            mine = [s for s in self.samples if s.role == "prefill"]
        else:
            mine = [s for s in self.samples if s.role != "prefill"]
        return [s for s in mine if not s.draining]

    def utilization(self, role: str) -> float:
        pool = [s for s in self.pool(role) if s.ok]
        slots = sum(s.slots for s in pool)
        if not slots:
            return 0.0
        return sum(s.active for s in pool) / slots

    def mean_queue_depth(self, role: str) -> float:
        pool = [s for s in self.pool(role) if s.ok]
        if not pool:
            return 0.0
        return sum(s.queue_depth for s in pool) / len(pool)

    def mean_prefill_backlog(self, role: str) -> float:
        pool = [s for s in self.pool(role) if s.ok]
        if not pool:
            return 0.0
        return sum(s.prefill_backlog for s in pool) / len(pool)

    def max_load_seconds(self, role: str) -> float:
        pool = self.pool(role)
        if not pool:
            return 0.0
        return max(s.load_seconds for s in pool)


class FleetScraper:
    """Scrapes the fleet and carries the inter-poll histogram state
    (previous cumulative buckets per endpoint) that turns lifetime
    counters into windowed signals."""

    def __init__(self, conf: Optional[ConfLike] = None):
        conf = conf or Configuration()
        self.timeout = conf.get_time_seconds(SCRAPE_TIMEOUT_KEY, 2.0)
        # endpoint → (ttft {le: cum}, ttft count, shed total)
        self._prev: Dict[str, Tuple[Dict[float, float], float, float]] = {}

    @staticmethod
    def _endpoint(record) -> Tuple[str, int]:
        host, _, port = record.endpoints["http"].rpartition(":")
        return host or "127.0.0.1", int(port)

    def _scrape_health(self, s: ReplicaSample) -> None:
        h = json.loads(http_get(s.host, s.port, "/v1/health",
                                self.timeout))
        s.draining = h.get("status") == "draining"
        s.queue_depth = int(h.get("queue_depth", 0))
        s.active = int(h.get("active", 0))
        s.slots = int(h.get("slots", 0))
        s.prefilling = int(h.get("prefilling", 0))
        s.prefill_backlog = int(h.get("prefill_backlog", 0))
        cache = h.get("prefix_cache") or {}
        s.cached_blocks = int(cache.get("cached_blocks", 0))
        tiers = cache.get("tiers") or {}
        s.hits_dfs = int(tiers.get("hits_dfs", 0))
        qos = h.get("qos") or {}
        s.qos_sheds = int(qos.get("sheds", 0))

    def _scrape_prom(self, s: ReplicaSample
                     ) -> Tuple[Dict[float, float], float, float]:
        fams = parse_prom(http_get(s.host, s.port, "/prom",
                                   self.timeout).decode())
        buckets: Dict[float, float] = {}
        count = 0.0
        for labels, value in fams.get(f"{TTFT_FAMILY}_bucket", []):
            le = labels.get("le", "")
            bound = math.inf if le == "+Inf" else float(le)
            buckets[bound] = buckets.get(bound, 0.0) + value
        for _, value in fams.get(f"{TTFT_FAMILY}_count", []):
            count += value
        shed = sum(v for _, v in fams.get(SHED_FAMILY, []))
        return buckets, count, shed

    def scrape(self, records) -> FleetSnapshot:
        snap = FleetSnapshot(at=time.time())
        merged: Dict[float, float] = {}
        merged_count = 0.0
        shed_delta = 0.0
        seen: set = set()
        for rec in records:
            try:
                host, port = self._endpoint(rec)
            except (KeyError, ValueError):
                continue
            # still a member (even if this scrape fails): its window
            # state must survive a transient scrape failure, or the
            # next success reads its whole lifetime as one window
            seen.add(f"{host}:{port}")
            attrs = rec.attributes
            s = ReplicaSample(
                path=rec.path, host=host, port=port,
                role=attrs.get("role", "mixed"),
                load_seconds=float(attrs.get("load_seconds", 0) or 0),
                draining=attrs.get("state") == "draining")
            try:
                self._scrape_health(s)
                buckets, count, shed = self._scrape_prom(s)
                s.ok = True
            except (OSError, IOError, ValueError) as e:
                s.error = str(e)
                snap.scrape_failures += 1
                snap.samples.append(s)
                continue
            key = f"{host}:{port}"
            prev_b, prev_c, prev_shed = self._prev.get(
                key, ({}, 0.0, 0.0))
            if count < prev_c or shed < prev_shed:
                # counter reset: the replica restarted behind the same
                # endpoint — its whole history is this window
                prev_b, prev_c, prev_shed = {}, 0.0, 0.0
            for bound, cum in buckets.items():
                d = cum - prev_b.get(bound, 0.0)
                if d > 0:
                    merged[bound] = merged.get(bound, 0.0) + d
            merged_count += count - prev_c
            shed_delta += shed - prev_shed
            self._prev[key] = (buckets, count, shed)
            snap.samples.append(s)
        # drop inter-poll state for endpoints that left the fleet —
        # elastic fleets mint a fresh port per replica, and keeping
        # every dead endpoint's bucket dict would grow without bound
        for key in list(self._prev):
            if key not in seen:
                del self._prev[key]
        # the merged per-bucket deltas stay cumulative (they arrive
        # cumulative per endpoint, so the diffs are cumulative per
        # bound; merging sums preserve that)
        snap.ttft_p99_s = histogram_p99(merged)
        snap.ttft_samples = int(merged_count)
        snap.shed_delta = int(shed_delta)
        return snap
