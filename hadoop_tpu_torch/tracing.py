"""Distributed tracing: spans, their wire context, the process tracer and
the span collector behind every chassis's ``/ws/v1/traces``.

The port's copy of ``hadoop_tpu/tracing/tracer.py`` and
``tracing/collector.py``, in one module. ``SpanContext`` has the
reference's header and RPC forms byte for byte, so a trace started by a
``hadoop_tpu`` router or client continues here and the other way round:
the HTTP header ``X-Htpu-Trace`` carries
``<trace_id hex>:<span_id hex>:<sampled 0|1>``, an RPC request's ``t``
field ``{"t": trace_id, "s": span_id, "sm": 0|1}``.

Sampling is decided once, at a root span, and children (local, or remote
through a ``SpanContext``) inherit it, so a trace is delivered whole or
not at all. The active span lives in a contextvar; engine-side spans run
on the scheduler thread, so their parent context rides the request.
Finished sampled spans go to the tracer's in-memory ``finished`` list and
to every receiver added with ``add_receiver``. ``carry_context`` wraps a
callable so the caller's active span survives into the thread that runs
it (the KV tier's DFS writer).

:class:`SpanCollector` (``span_collector()``, a receiver of the global
tracer) keeps finished spans in a bounded ring, counting what it drops,
and promotes a whole trace into a retained flight-recorder buffer when
any of its spans passes its plane's slow threshold (milliseconds, 0
turns a rule off): ``tracing.slow.xceiver.ms`` (``dfs.xceiver.*``, 500),
``tracing.slow.client.ms`` (``dfs.client.*``, 2000),
``tracing.slow.ckpt.ms`` (``trainer.ckpt.*``, 30000),
``tracing.slow.step.ms`` (``trainer.step*``, 1000),
``tracing.slow.serving.ms`` (``serving.*``, 1000) and
``tracing.slow.rpc.ms`` (everything else, 300). Sizes:
``tracing.collector.max-spans`` (4096) and ``tracing.flight.max-traces``
(32).
"""

from __future__ import annotations

import contextvars
import logging
import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

TRACE_HEADER = "X-Htpu-Trace"

_active: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "htpu_torch_active_span", default=None)


class SpanContext:
    """Wire form of a span: what travels in headers."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: int, span_id: int, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled

    def to_wire(self) -> Dict[str, int]:
        """The RPC request's form."""
        return {"t": self.trace_id, "s": self.span_id,
                "sm": 1 if self.sampled else 0}

    @classmethod
    def from_wire(cls, d: Optional[Dict[str, int]]
                  ) -> Optional["SpanContext"]:
        if not d:
            return None
        # a peer without the sampled bit delivered the context: sampled
        return cls(d["t"], d["s"], bool(d.get("sm", 1)))

    def to_header(self) -> str:
        """Compact HTTP-header form (``X-Htpu-Trace``)."""
        return f"{self.trace_id:x}:{self.span_id:x}:{int(self.sampled)}"

    @classmethod
    def from_header(cls, h: Optional[str]) -> Optional["SpanContext"]:
        if not h:
            return None
        try:
            t, s, sm = h.split(":")
            return cls(int(t, 16), int(s, 16), sm != "0")
        except (ValueError, AttributeError):
            return None


class Span:
    def __init__(self, tracer: "Tracer", name: str, trace_id: int,
                 parent_id: Optional[int], sampled: bool = True):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = random.getrandbits(63)
        self.parent_id = parent_id
        self.sampled = sampled
        self.start = time.time()
        self.end: Optional[float] = None
        self.annotations: List[str] = []
        self.kv: Dict[str, str] = {}
        self._token = None

    def annotate(self, msg: str) -> None:
        self.annotations.append(msg)

    def add_kv(self, k: str, v: str) -> None:
        self.kv[k] = v

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

    def duration_ms(self) -> float:
        return ((self.end if self.end is not None else time.time())
                - self.start) * 1e3

    def __enter__(self) -> "Span":
        self._token = _active.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        self.finish()
        return False

    def finish(self) -> None:
        if self.end is None:
            self.end = time.time()
            if self._token is not None:
                _active.reset(self._token)
                self._token = None
            self.tracer._deliver(self)

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "trace_id": self.trace_id,
            "span_id": self.span_id, "parent_id": self.parent_id,
            "start": self.start, "end": self.end,
            "annotations": list(self.annotations), "kv": dict(self.kv),
        }


def parse_trace_id_candidates(raw: str) -> List[int]:
    """The readings of a trace id a user pasted: ``0x...`` is hex; an
    all-digit string is tried as hex and as decimal (span JSON prints
    ids in decimal, the slow-trace log line in ``016x``), hex first.
    Callers treat the result as a set; empty means unparseable."""
    raw = raw.strip().lower()
    base16 = raw[2:] if raw.startswith("0x") else raw
    bases = ((16, base16),) if raw.startswith("0x") \
        else ((16, base16), (10, raw))
    out: List[int] = []
    for base, s in bases:
        try:
            v = int(s, base)
        except ValueError:
            continue
        if v not in out:
            out.append(v)
    return out


def current_span() -> Optional[Span]:
    return _active.get()


def current_context() -> Optional[SpanContext]:
    """Wire context of the active span, if any."""
    sp = _active.get()
    return sp.context() if sp is not None else None


def carry_context(fn: Callable) -> Callable:
    """Capture the CALLER's contextvars (the active span among them) and
    run ``fn`` under them in whatever thread eventually calls the
    wrapper, so spans made there parent into the spawning trace."""
    ctx = contextvars.copy_context()

    def run(*args, **kwargs):
        return ctx.run(fn, *args, **kwargs)
    return run


class Tracer:
    """Per-process tracer with root-decided sampling and receivers."""

    def __init__(self, name: str = "htpu", sample_rate: float = 1.0,
                 rng: Optional[random.Random] = None):
        self.name = name
        self.sample_rate = sample_rate
        self._rng = rng or random
        self._receivers: List[Callable[[Span], None]] = []
        self._lock = threading.Lock()
        self.finished: List[Span] = []   # guarded-by: _lock
        self.max_kept = 1000

    def add_receiver(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            self._receivers.append(fn)

    def remove_receiver(self, fn: Callable[[Span], None]) -> None:
        with self._lock:
            self._receivers.remove(fn)

    def span(self, name: str, parent: Optional[SpanContext] = None) -> Span:
        """New span: child of ``parent`` (wire context), else of the active
        span, else a new trace root, which alone rolls for sampling."""
        cur = _active.get()
        if parent is not None:
            return Span(self, name, parent.trace_id, parent.span_id,
                        sampled=parent.sampled)
        if cur is not None:
            return Span(self, name, cur.trace_id, cur.span_id,
                        sampled=cur.sampled)
        sampled = (self.sample_rate >= 1.0 or
                   self._rng.random() < self.sample_rate)
        return Span(self, name, random.getrandbits(63), None,
                    sampled=sampled)

    def _deliver(self, span: Span) -> None:
        if not span.sampled:
            return
        with self._lock:
            self.finished.append(span)
            if len(self.finished) > self.max_kept:
                del self.finished[: len(self.finished) // 2]
            receivers = list(self._receivers)
        for r in receivers:
            try:
                r(span)
            except Exception as e:  # noqa: BLE001 — receiver is user code
                log.debug("span receiver %r failed: %s", r, e)

    def set_sample_rate(self, rate: float) -> None:
        self.sample_rate = rate


_global_tracer = Tracer()


def global_tracer() -> Tracer:
    return _global_tracer


# span-name prefix -> (conf key, default ms); the first match wins, the
# rpc rule catches the rest (RPC server spans are <daemon>.<method>).
# Long-by-design bulk spans have rules of their own, so routine
# checkpoint writes and multi-packet reads do not churn the flight
# recorder under the 300 ms rule
_THRESHOLD_RULES = (
    ("dfs.xceiver.", "tracing.slow.xceiver.ms", 500.0),
    ("dfs.client.", "tracing.slow.client.ms", 2000.0),
    ("trainer.ckpt.", "tracing.slow.ckpt.ms", 30000.0),
    ("trainer.step", "tracing.slow.step.ms", 1000.0),
    ("serving.", "tracing.slow.serving.ms", 1000.0),
    ("", "tracing.slow.rpc.ms", 300.0),
)


class SpanCollector:
    """Bounded ring of finished spans + flight recorder of slow traces."""

    def __init__(self, max_spans: int = 4096, max_traces: int = 32):
        self._lock = threading.Lock()
        self.max_spans = max_spans
        self._ring: deque = deque(maxlen=max_spans)   # guarded-by: _lock
        self.dropped = 0                              # guarded-by: _lock
        self._slow: deque = deque(maxlen=max_traces)  # guarded-by: _lock
        self.slow_promoted = 0                        # guarded-by: _lock
        self._thresholds: Dict[str, float] = {
            key: default for _, key, default in _THRESHOLD_RULES}

    def configure(self, conf) -> None:
        """Thresholds and sizes from a daemon's conf. Process-wide like
        the tracer: the last daemon to start in a process wins."""
        for _, key, default in _THRESHOLD_RULES:
            self._thresholds[key] = conf.get_float(key, default)
        max_spans = conf.get_int("tracing.collector.max-spans",
                                 self.max_spans)
        if max_spans != self.max_spans:
            with self._lock:
                self.max_spans = max_spans
                self._ring = deque(self._ring, maxlen=max_spans)
        with self._lock:
            cur_max = self._slow.maxlen
        max_traces = conf.get_int("tracing.flight.max-traces", cur_max)
        if max_traces != cur_max:
            with self._lock:
                self._slow = deque(self._slow, maxlen=max_traces)

    def threshold_ms_for(self, name: str) -> float:
        for prefix, key, _ in _THRESHOLD_RULES:
            if name.startswith(prefix):
                return self._thresholds[key]
        return self._thresholds["tracing.slow.rpc.ms"]

    def receive(self, span: Span) -> None:
        """Tracer receiver: ring-buffer the span; promote its trace when
        it passed its slow threshold."""
        ms = span.duration_ms()
        threshold = self.threshold_ms_for(span.name)
        slow = 0 < threshold <= ms
        retained = 0
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)
            if slow:
                trace = [s for s in self._ring
                         if s.trace_id == span.trace_id]
                # one slot a trace: a trace whose spans trip several
                # planes' thresholds refreshes its entry instead of
                # evicting other traces from the few retained slots
                existing = next((t for t in self._slow
                                 if t["trace_id"] == span.trace_id),
                                None)
                spans = [s.to_dict() for s in trace]
                if existing is not None:
                    # spans the ring already churned past live only in
                    # the retained entry: keep them
                    seen = {s["span_id"] for s in spans}
                    spans = [s for s in existing["spans"]
                             if s["span_id"] not in seen] + spans
                    self._slow.remove(existing)
                self._slow.append({
                    "trace_id": span.trace_id,
                    "trigger": span.name,
                    "trigger_ms": round(ms, 2),
                    "threshold_ms": threshold,
                    "retained_at": time.time(),
                    "spans": spans,
                })
                if existing is None:
                    self.slow_promoted += 1
                retained = len(spans)
        if slow:
            log.warning(
                "slow-trace trace_id=%016x trigger=%s ms=%.1f "
                "threshold_ms=%.0f spans_retained=%d",
                span.trace_id, span.name, ms, threshold, retained)

    def snapshot(self, trace_id=None, limit: int = 0) -> Dict:
        """``trace_id``: one id or a collection of candidates (the HTTP
        handler passes both readings of an all-digit query)."""
        with self._lock:
            spans = list(self._ring)
            dropped = self.dropped
        if trace_id is not None:
            wanted = (set(trace_id) if isinstance(trace_id, (set, list,
                                                             tuple))
                      else {trace_id})
            spans = [s for s in spans if s.trace_id in wanted]
        if limit > 0:
            spans = spans[-limit:]
        return {"spans": [s.to_dict() for s in spans],
                "dropped": dropped, "max_spans": self.max_spans}

    def slow_traces(self) -> Dict:
        with self._lock:
            return {"traces": list(self._slow),
                    "promoted": self.slow_promoted,
                    "max_traces": self._slow.maxlen}

    def reset_for_tests(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()
            self.dropped = 0
            self.slow_promoted = 0
            self._thresholds = {key: default
                                for _, key, default in _THRESHOLD_RULES}


_collector: Optional[SpanCollector] = None
_collector_lock = threading.Lock()


def span_collector(tracer: Optional[Tracer] = None) -> SpanCollector:
    """The process's collector, added as a receiver of the global tracer
    (or ``tracer``) on first use."""
    global _collector
    with _collector_lock:
        if _collector is None:
            _collector = SpanCollector()
            (tracer or global_tracer()).add_receiver(_collector.receive)
        return _collector
