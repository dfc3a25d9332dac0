"""Distributed tracing for the serving door: spans, their wire context and
the process tracer.

The part of ``hadoop_tpu/tracing/tracer.py`` the door and the engine use.
``SpanContext`` has the reference's header form byte for byte, so a
trace started by a ``hadoop_tpu`` router or client continues here and the
other way round: the HTTP header ``X-Htpu-Trace`` carries
``<trace_id hex>:<span_id hex>:<sampled 0|1>``.

Sampling is decided once, at a root span, and children (local, or remote
through a ``SpanContext``) inherit it, so a trace is delivered whole or
not at all. The active span lives in a contextvar; engine-side spans run
on the scheduler thread, so their parent context rides the request.
Finished sampled spans go to the tracer's in-memory ``finished`` list and
to every receiver added with ``add_receiver``. ``carry_context`` wraps a
callable so the caller's active span survives into the thread that runs
it (the KV tier's DFS writer).
"""

from __future__ import annotations

import contextvars
import logging
import random
import threading
import time
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
        self.kv: Dict[str, str] = {}
        self._token = None

    def add_kv(self, k: str, v: str) -> None:
        self.kv[k] = v

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id, self.sampled)

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


_global_tracer = Tracer()


def global_tracer() -> Tracer:
    return _global_tracer
