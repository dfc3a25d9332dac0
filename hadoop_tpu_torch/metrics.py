"""Metrics of the serving door and the trainer: registries of counters,
gauges, rates, quantiles and histograms, a process-wide system of them,
and their ``/jmx`` and Prometheus (``/prom``) expositions.

The part of ``hadoop_tpu/metrics/registry.py`` and ``metrics/prom.py``
that ``serving/metrics.py`` and ``obs/trainer.py`` use. Names, label
keys, bucket bounds and the text format are the reference's, so a
scraper or dashboard built for a ``hadoop_tpu`` replica or trainer rank
reads a port one the same way:

  counter    -> ``htpu_<name>_total``
  gauge      -> ``htpu_<name>``
  rate       -> ``htpu_<name>_num_ops_total`` + ``htpu_<name>_avg_time``
  quantiles  -> summary (``quantile`` labels + ``_count``)
  histogram  -> cumulative ``_bucket{le=...}``, ``_sum``, ``_count``
  callback gauge -> gauge (numeric values only)

The source registry's name rides as the ``source`` label; ``prom_name``
and ``prom_labels`` let several metrics publish under one family. Each
histogram bucket keeps an exemplar, the most recent sampled trace id that
landed there (OpenMetrics exemplar syntax on the ``_bucket`` line).
"""

from __future__ import annotations

import bisect
import logging
import math
import os
import random
import re
import subprocess
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from hadoop_tpu_torch.tracing import current_span

log = logging.getLogger(__name__)


class MutableCounter:
    """Monotonic counter."""

    def __init__(self, name: str, description: str = "",
                 prom_name: str = None, prom_labels: dict = None):
        self.name = name
        self.description = description
        self.prom_name = prom_name
        self.prom_labels = dict(prom_labels) if prom_labels else {}
        self._value = 0
        self._lock = threading.Lock()

    def incr(self, delta: int = 1) -> None:
        with self._lock:
            self._value += delta

    def value(self) -> int:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {self.name: self._value}


class MutableGauge:
    """Settable gauge."""

    def __init__(self, name: str, description: str = "", initial=0,
                 prom_name: str = None, prom_labels: dict = None):
        self.name = name
        self.description = description
        self.prom_name = prom_name
        self.prom_labels = dict(prom_labels) if prom_labels else {}
        self._value = initial
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self._value = v

    def value(self):
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {self.name: self._value}


class MutableRate:
    """Op count (lifetime) and mean/min/max duration since the last
    resetting snapshot."""

    def __init__(self, name: str, description: str = ""):
        self.name = name
        self.description = description
        self._lock = threading.Lock()
        self._n = 0
        self._total = 0.0
        self._min = float("inf")
        self._max = 0.0
        self._lifetime_n = 0

    def add(self, elapsed_s: float) -> None:
        with self._lock:
            self._n += 1
            self._lifetime_n += 1
            self._total += elapsed_s
            self._min = min(self._min, elapsed_s)
            self._max = max(self._max, elapsed_s)

    def snapshot(self, reset: bool = False) -> Dict[str, Any]:
        with self._lock:
            out = {
                f"{self.name}_num_ops": self._lifetime_n,
                f"{self.name}_avg_time":
                    (self._total / self._n) if self._n else 0.0,
                f"{self.name}_min_time":
                    0.0 if self._min == float("inf") else self._min,
                f"{self.name}_max_time": self._max,
            }
            if reset:
                self._n = 0
                self._total = 0.0
                self._min = float("inf")
                self._max = 0.0
            return out


class MutableQuantiles:
    """Bounded-reservoir quantiles (p50/p75/p90/p95/p99)."""

    QUANTILES = (0.50, 0.75, 0.90, 0.95, 0.99)

    def __init__(self, name: str, description: str = "",
                 max_samples: int = 4096):
        self.name = name
        self.description = description
        self.max_samples = max_samples
        self._samples: List[float] = []
        self._n = 0
        self._lock = threading.Lock()

    def add(self, v: float) -> None:
        with self._lock:
            self._n += 1
            if len(self._samples) < self.max_samples:
                bisect.insort(self._samples, v)
            elif random.randrange(self._n) < self.max_samples:
                # reservoir sampling keeps the estimate unbiased
                del self._samples[random.randrange(len(self._samples))]
                bisect.insort(self._samples, v)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {f"{self.name}_count": self._n}
            s = self._samples
            for q in self.QUANTILES:
                out[f"{self.name}_p{int(q * 100)}"] = \
                    s[min(len(s) - 1, int(q * len(s)))] if s else 0.0
            return out


class MutableHistogram:
    """Log-bucketed histogram (seconds): 20 bounds from 0.25 ms, x2 each,
    then +Inf. Each bucket keeps one exemplar: the trace id passed as
    ``exemplar_trace``, else the active span's when it is sampled."""

    BOUNDS = tuple(0.00025 * (2 ** i) for i in range(20))

    def __init__(self, name: str, description: str = "",
                 prom_name: str = None, prom_labels: dict = None):
        self.name = name
        self.description = description
        self.prom_name = prom_name
        self.prom_labels = dict(prom_labels) if prom_labels else {}
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.BOUNDS) + 1)
        # bucket index -> (trace_id, value, unix_ts)   guarded-by: _lock
        self._exemplars: Dict[int, tuple] = {}
        self._sum = 0.0
        self._n = 0

    def add(self, v: float, exemplar_trace: Optional[int] = None) -> None:
        if exemplar_trace is None:
            sp = current_span()
            if sp is not None and sp.sampled:
                exemplar_trace = sp.trace_id
        with self._lock:
            self._n += 1
            self._sum += v
            i = bisect.bisect_left(self.BOUNDS, v)
            self._counts[i] += 1
            if exemplar_trace is not None:
                self._exemplars[i] = (exemplar_trace, v, time.time())

    def buckets(self):
        """[(upper_bound_or_inf, cumulative_count)], sum, count."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._n
        out = []
        cum = 0
        for bound, c in zip(self.BOUNDS, counts):
            cum += c
            out.append((bound, cum))
        out.append((float("inf"), cum + counts[-1]))
        return out, total, n

    def bucket_exemplars(self):
        """One (trace_id, value, unix_ts) or None per bucket, +Inf last."""
        with self._lock:
            ex = dict(self._exemplars)
        return [ex.get(i) for i in range(len(self.BOUNDS) + 1)]

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            n, total = self._n, self._sum
        return {f"{self.name}_count": n,
                f"{self.name}_sum": round(total, 6),
                f"{self.name}_mean": (total / n) if n else 0.0}


class MetricsRegistry:
    """One source's metrics, made on first request and shared after."""

    def __init__(self, name: str):
        self.name = name
        self._metrics: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, description: str = "",
                prom_name: str = None,
                prom_labels: dict = None) -> MutableCounter:
        return self._get_or_make(name, lambda: MutableCounter(
            name, description, prom_name=prom_name,
            prom_labels=prom_labels))

    def gauge(self, name: str, description: str = "", initial=0,
              prom_name: str = None,
              prom_labels: dict = None) -> MutableGauge:
        return self._get_or_make(name, lambda: MutableGauge(
            name, description, initial, prom_name=prom_name,
            prom_labels=prom_labels))

    def rate(self, name: str, description: str = "") -> MutableRate:
        return self._get_or_make(name,
                                 lambda: MutableRate(name, description))

    def quantiles(self, name: str,
                  description: str = "") -> MutableQuantiles:
        return self._get_or_make(
            name, lambda: MutableQuantiles(name, description))

    def histogram(self, name: str, description: str = "",
                  prom_name: str = None,
                  prom_labels: dict = None) -> MutableHistogram:
        return self._get_or_make(name, lambda: MutableHistogram(
            name, description, prom_name=prom_name,
            prom_labels=prom_labels))

    def metrics(self) -> List[Any]:
        with self._lock:
            return list(self._metrics.values())

    def remove(self, name: str) -> None:
        """Drop one metric, so that making it again can change its
        exposition (a re-ranked trainer's label)."""
        with self._lock:
            self._metrics.pop(name, None)

    def register_callback_gauge(self, name: str, fn: Callable[[], Any],
                                prom_name: str = None,
                                prom_labels: dict = None) -> None:
        """A gauge whose value ``fn()`` reads at each snapshot."""
        with self._lock:
            self._metrics[name] = _CallbackGauge(
                name, fn, prom_name=prom_name, prom_labels=prom_labels)

    def _get_or_make(self, name: str, factory: Callable):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            return m

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for m in self.metrics():
            out.update(m.snapshot())
        return out


class _CallbackGauge:
    def __init__(self, name: str, fn: Callable[[], Any],
                 prom_name: str = None, prom_labels: dict = None):
        self.name = name
        self.prom_name = prom_name
        self.prom_labels = dict(prom_labels) if prom_labels else {}
        self._fn = fn

    def snapshot(self) -> Dict[str, Any]:
        try:
            return {self.name: self._fn()}
        except Exception:  # noqa: BLE001 — a torn-down provider reads
            return {self.name: None}    # as no value, not a dead scrape


class MetricsSystem:
    """The process's sources by name."""

    def __init__(self):
        self._sources: Dict[str, MetricsRegistry] = {}
        self._lock = threading.Lock()

    def source(self, name: str) -> MetricsRegistry:
        with self._lock:
            reg = self._sources.get(name)
            if reg is None:
                reg = self._sources[name] = MetricsRegistry(name)
            return reg

    def sources(self) -> Dict[str, MetricsRegistry]:
        with self._lock:
            return dict(self._sources)

    def snapshot_all(self) -> Dict[str, Dict[str, Any]]:
        return {name: reg.snapshot()
                for name, reg in self.sources().items()}

    def reset_for_tests(self) -> None:
        with self._lock:
            self._sources.clear()


_global = MetricsSystem()


def metrics_system() -> MetricsSystem:
    return _global


# ----------------------------------------------------------------- /prom

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
PREFIX = "htpu_"


def _san(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    return "_" + name if name and name[0].isdigit() else name


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if math.isnan(v):
            return "NaN"
        return repr(v)
    return str(v)


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"')


def _line(name: str, labels: dict, value) -> str:
    if labels:
        lab = ",".join(f'{k}="{_esc(v)}"' for k, v in labels.items())
        return f"{name}{{{lab}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


def render_prom(system: MetricsSystem, exemplars: bool = True) -> str:
    """Every source as Prometheus text exposition, grouped by family (one
    contiguous group per family after its TYPE line, as the format asks)."""
    fams: Dict[str, Dict] = {}

    def fam(name: str, mtype: str, help_text: str) -> Optional[List[str]]:
        f = fams.get(name)
        if f is None:
            f = fams[name] = {"type": mtype, "help": help_text,
                              "lines": []}
        elif f["type"] != mtype:
            return None      # same family name, conflicting type: skip
        return f["lines"]

    def add(name, mtype, help_text, labels, value) -> None:
        lines = fam(name, mtype, help_text)
        if lines is not None:
            lines.append(_line(name, labels, value))

    for source, reg in sorted(system.sources().items()):
        labels = {"source": source}
        for m in reg.metrics():
            name = PREFIX + _san(m.name)
            mlabels = labels
            if getattr(m, "prom_name", None):
                name = PREFIX + _san(m.prom_name)
            if getattr(m, "prom_labels", None):
                mlabels = dict(labels, **m.prom_labels)
            if isinstance(m, MutableCounter):
                add(f"{name}_total", "counter", m.description, mlabels,
                    m.value())
            elif isinstance(m, MutableGauge):
                add(name, "gauge", m.description, mlabels, m.value())
            elif isinstance(m, MutableHistogram):
                lines = fam(name, "histogram", m.description)
                if lines is None:
                    continue
                buckets, total, n = m.buckets()
                bucket_ex = m.bucket_exemplars() if exemplars \
                    else [None] * len(buckets)
                for (bound, cum), ex in zip(buckets, bucket_ex):
                    le = "+Inf" if math.isinf(bound) else _fmt(bound)
                    line = _line(f"{name}_bucket", dict(mlabels, le=le),
                                 cum)
                    if ex is not None:
                        trace_id, value, ts = ex
                        line += (f' # {{trace_id="{trace_id:016x}"}} '
                                 f"{_fmt(value)} {ts:.3f}")
                    lines.append(line)
                lines.append(_line(f"{name}_sum", mlabels, total))
                lines.append(_line(f"{name}_count", mlabels, n))
            elif isinstance(m, MutableQuantiles):
                lines = fam(name, "summary", m.description)
                if lines is None:
                    continue
                snap = m.snapshot()
                for q in m.QUANTILES:
                    lines.append(_line(
                        name, dict(labels, quantile=_fmt(q)),
                        snap[f"{m.name}_p{int(q * 100)}"]))
                lines.append(_line(f"{name}_count", labels,
                                   snap[f"{m.name}_count"]))
            elif isinstance(m, MutableRate):
                snap = m.snapshot()
                add(f"{name}_num_ops_total", "counter", m.description,
                    labels, snap[f"{m.name}_num_ops"])
                add(f"{name}_avg_time", "gauge", "", labels,
                    snap[f"{m.name}_avg_time"])
            elif isinstance(m, _CallbackGauge):
                v = m.snapshot().get(m.name)
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    add(name, "gauge", "", mlabels, v)
    out: List[str] = []
    for name in sorted(fams):
        f = fams[name]
        if not f["lines"]:
            continue
        if f["help"]:
            out.append(f"# HELP {name} {f['help']}")
        out.append(f"# TYPE {name} {f['type']}")
        out.extend(f["lines"])
    return "\n".join(out) + "\n"


_BUILD_INFO: Optional[Dict[str, str]] = None


def _git_hash() -> str:
    env = os.environ.get("HTPU_CODE_HASH", "").strip()
    if env:
        return env
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("build hash probe failed: %s", e)
    return "unknown"


def _installed(package: str) -> str:
    """The installed version of ``package`` from its metadata (nothing is
    imported), or "none"."""
    from importlib.metadata import PackageNotFoundError, version
    try:
        return version(package)
    except PackageNotFoundError:
        return "none"


def build_info_prom() -> str:
    """The ``htpu_build_info`` block: a value-1 gauge whose labels carry
    the build identity (``code_hash``: ``HTPU_CODE_HASH``, else the
    checkout's git HEAD, else "unknown"; ``jax``: the installed JAX
    version or "none", the reference's label set). Probed once."""
    global _BUILD_INFO
    if _BUILD_INFO is None:
        _BUILD_INFO = {"code_hash": _git_hash(), "jax": _installed("jax")}
    labels = ",".join(f'{k}="{_esc(v)}"'
                      for k, v in sorted(_BUILD_INFO.items()))
    return ("# HELP htpu_build_info build identity of this process\n"
            "# TYPE htpu_build_info gauge\n"
            f"htpu_build_info{{{labels}}} 1\n")
