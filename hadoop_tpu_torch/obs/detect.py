"""Slow-node detection: median/MAD outliers with report-window
hysteresis.

The port's copy of ``hadoop_tpu/obs/detect.py``. :func:`mad_outliers`
flags a node whose value passes all of ``median + mad_k * MAD`` (MAD
scaled by 1.4826), ``ratio * median`` and ``abs_floor``, among at least
``min_peers`` nodes; :class:`SlowNodeDetector` reports the nodes flagged
in at least ``min_windows`` of the last ``history`` windows, with the
newest evidence; :class:`RollingStat` is a bounded window of samples
with its mean and median. Decisions are arithmetic over the values the
caller observed: no clock feeds them.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List, Optional

# MAD -> sigma-equivalent scale for normally-distributed samples (the
# constant of Hadoop's OutlierDetector)
MAD_SCALE = 1.4826


def median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    if n == 0:
        return 0.0
    mid = n // 2
    if n % 2:
        return xs[mid]
    return (xs[mid - 1] + xs[mid]) / 2.0


def mad_outliers(values: Dict[str, float], *, min_peers: int = 3,
                 mad_k: float = 3.0, ratio: float = 1.5,
                 abs_floor: float = 0.0) -> Dict[str, Dict]:
    """One detection pass: ``{node: value}`` in, ``{node: evidence}``
    out (empty when no outliers, or when fewer than ``min_peers`` nodes
    reported — an outlier needs peers to be an outlier *among*).

    A node is flagged when its value exceeds ALL of:
      - ``median + mad_k * MAD`` (the statistical outlier test),
      - ``ratio * median``       (meaningfully slower, not just spread),
      - ``abs_floor``            (absolute noise floor, e.g. 1 ms).
    """
    if len(values) < min_peers:
        return {}
    vals = list(values.values())
    med = median(vals)
    mad = median([abs(v - med) for v in vals]) * MAD_SCALE
    threshold = max(med + mad_k * mad, med * ratio, abs_floor)
    out: Dict[str, Dict] = {}
    for node, v in values.items():
        if v > threshold:
            out[node] = {"value": round(v, 6), "median": round(med, 6),
                         "mad": round(mad, 6),
                         "threshold": round(threshold, 6),
                         "peers": len(values)}
    return out


class SlowNodeDetector:
    """Windows of mad_outliers() passes -> a stable flagged set.

    One detector instance tracks one *kind* of signal over one
    population (DN pipeline latency, replica decode-step time, ...).
    ``observe`` ingests a per-node summary for one report window;
    ``report`` names the nodes that were outliers in >= ``min_windows``
    of the last ``history`` windows, with the newest evidence attached.
    """

    def __init__(self, *, history: int = 5, min_windows: int = 3,
                 min_peers: int = 3, mad_k: float = 3.0,
                 ratio: float = 1.5, abs_floor: float = 0.0):
        self.history = max(1, history)
        self.min_windows = max(1, min(min_windows, self.history))
        self.min_peers = min_peers
        self.mad_k = mad_k
        self.ratio = ratio
        self.abs_floor = abs_floor
        self._lock = threading.Lock()
        # deque of {node: evidence} per window, newest last
        self._windows: deque = deque(maxlen=self.history)  # guarded-by: _lock
        self._observed = 0                                 # guarded-by: _lock

    def observe(self, values: Dict[str, float]) -> Dict[str, Dict]:
        """Ingest one window; returns this window's raw outliers."""
        flagged = mad_outliers(values, min_peers=self.min_peers,
                               mad_k=self.mad_k, ratio=self.ratio,
                               abs_floor=self.abs_floor)
        with self._lock:
            self._windows.append(flagged)
            self._observed += 1
        return flagged

    def report(self) -> Dict[str, Dict]:
        """Nodes flagged in >= min_windows of the retained windows."""
        with self._lock:
            windows = list(self._windows)
            observed = self._observed
        counts: Dict[str, int] = {}
        latest: Dict[str, Dict] = {}
        for w in windows:
            for node, ev in w.items():
                counts[node] = counts.get(node, 0) + 1
                latest[node] = ev
        out: Dict[str, Dict] = {}
        for node, n in counts.items():
            if n >= self.min_windows:
                ev = dict(latest[node])
                ev["windows_flagged"] = n
                ev["windows_seen"] = min(observed, self.history)
                out[node] = ev
        return out

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
            self._observed = 0


class RollingStat:
    """Bounded rolling window of latency samples: O(1) record, cheap
    mean/median summary. The building block of per-peer tracking."""

    __slots__ = ("_samples", "_sum", "last_at")

    def __init__(self, window: int = 128):
        self._samples: deque = deque(maxlen=window)
        self._sum = 0.0
        self.last_at = 0.0

    def record(self, v: float) -> None:
        if len(self._samples) == self._samples.maxlen:
            self._sum -= self._samples[0]
        self._samples.append(v)
        self._sum += v
        self.last_at = time.time()

    def summary(self) -> Optional[Dict]:
        n = len(self._samples)
        if n == 0:
            return None
        return {"n": n, "mean": self._sum / n,
                "median": median(list(self._samples))}
