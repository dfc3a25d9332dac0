"""Cross-daemon trace assembly: every daemon's spans, one tree.

The port's copy of ``hadoop_tpu/obs/assemble.py``. :class:`FleetTraceStore`
pulls each endpoint's ``/ws/v1/traces`` ring and ``/ws/v1/traces/slow``
flight recorder (each GET bounded by ``obs.doctor.scrape.timeout``, 2 s:
a wedged daemon is a status row), merges the spans by trace id (one per
span id, stamped with the daemon that gave it), keeps the newest
``obs.doctor.max-traces`` traces (LRU, 256), and assembles a tree on
demand with each span's self time and the per-daemon critical path
(:func:`assemble_tree`). A daemon that dies keeps the spans it gave; its
status row goes when discovery stops listing it. ``fetch_trace`` pulls
one trace id from every endpoint, for an id the periodic scrape missed.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.http import http_get

MAX_TRACES_KEY = "obs.doctor.max-traces"
SCRAPE_TIMEOUT_KEY = "obs.doctor.scrape.timeout"


class Endpoint:
    """One scrape target: a daemon's admin HTTP server."""

    __slots__ = ("name", "host", "port", "kind")

    def __init__(self, name: str, host: str, port: int,
                 kind: str = "daemon"):
        self.name = name
        self.host = host
        self.port = int(port)
        self.kind = kind      # "namenode" | "datanode" | "replica" | ...

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"

    def to_dict(self) -> Dict:
        return {"name": self.name, "host": self.host, "port": self.port,
                "kind": self.kind}


class FleetTraceStore:
    """Pulls per-daemon span rings + flight recorders, merges by
    trace id, assembles trees on demand."""

    def __init__(self, conf: Optional[ConfLike] = None):
        conf = conf or Configuration(load_defaults=False)
        self.timeout = conf.get_time_seconds(SCRAPE_TIMEOUT_KEY, 2.0)
        self.max_traces = conf.get_int(MAX_TRACES_KEY, 256)
        self._lock = threading.Lock()
        # trace_id -> {span_id: span_dict} (LRU: newest-touched last)
        self._traces: "OrderedDict[int, Dict[int, Dict]]" = \
            OrderedDict()                       # guarded-by: _lock
        # endpoint key -> {"endpoint", "ok", "error", "last_scrape",
        #                  "spans_seen"}
        self._status: Dict[str, Dict] = {}      # guarded-by: _lock

    # ----------------------------------------------------------- scraping

    def _pull(self, ep: Endpoint, path: str) -> Dict:
        return json.loads(http_get(ep.host, ep.port, path, self.timeout))

    def scrape(self, endpoints: Iterable[Endpoint]) -> None:
        """One jittered-cadence pass: pull every endpoint's ring + slow
        buffer; prune bookkeeping for endpoints discovery dropped."""
        endpoints = list(endpoints)
        seen = set()
        for ep in endpoints:
            seen.add(ep.key)
            spans: List[Dict] = []
            err = ""
            try:
                spans.extend(self._pull(ep, "/ws/v1/traces")
                             .get("spans", []))
                for t in self._pull(ep, "/ws/v1/traces/slow") \
                        .get("traces", []):
                    spans.extend(t.get("spans", []))
            except (OSError, ValueError) as e:
                err = str(e)
            self._ingest(ep, spans)
            with self._lock:
                st = self._status.setdefault(ep.key, {"spans_seen": 0})
                st.update({"endpoint": ep.to_dict(), "ok": not err,
                           "error": err, "last_scrape": time.time()})
        with self._lock:
            # departed endpoints: prune the STATUS (bounded bookkeeping)
            # — spans they already contributed stay in their traces
            for key in [k for k in self._status if k not in seen]:
                del self._status[key]

    def fetch_trace(self, trace_id: int,
                    endpoints: Iterable[Endpoint]) -> None:
        """Targeted pull of ONE trace id from every endpoint (ring
        filter + flight recorder) — how an exemplar trace id that the
        periodic scrape never saw still resolves."""
        for ep in list(endpoints):
            spans: List[Dict] = []
            try:
                spans.extend(
                    self._pull(ep, f"/ws/v1/traces?trace_id={trace_id}")
                    .get("spans", []))
                for t in self._pull(ep, "/ws/v1/traces/slow") \
                        .get("traces", []):
                    if t.get("trace_id") == trace_id:
                        spans.extend(t.get("spans", []))
            except (OSError, ValueError):
                continue                # churn: keep what others gave us
            self._ingest(ep, [s for s in spans
                              if s.get("trace_id") == trace_id])

    def _ingest(self, ep: Endpoint, spans: List[Dict]) -> None:
        if not spans:
            return
        with self._lock:
            for s in spans:
                tid = s.get("trace_id")
                sid = s.get("span_id")
                if tid is None or sid is None:
                    continue
                trace = self._traces.get(tid)
                if trace is None:
                    trace = self._traces[tid] = {}
                cur = trace.get(sid)
                if cur is None or (s.get("end") is not None
                                   and cur.get("end") is None):
                    s = dict(s)
                    s["daemon"] = ep.name
                    trace[sid] = s
                self._traces.move_to_end(tid)
            st = self._status.setdefault(ep.key, {})
            st["spans_seen"] = st.get("spans_seen", 0) + len(spans)
            while len(self._traces) > self.max_traces:
                self._traces.popitem(last=False)

    # ----------------------------------------------------------- queries

    def trace_ids(self) -> List[int]:
        with self._lock:
            return list(self._traces)

    def status(self) -> Dict[str, Dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._status.items()}

    def assemble(self, trace_id: int) -> Optional[Dict]:
        """One assembled tree + critical-path summary, or None."""
        with self._lock:
            trace = self._traces.get(trace_id)
            if trace is None:
                return None
            spans = [dict(s) for s in trace.values()]
        return assemble_tree(trace_id, spans)


def assemble_tree(trace_id: int, spans: List[Dict]) -> Dict:
    """Pure assembly: nest spans by parent_id (orphans — spans whose
    parent never arrived, e.g. their daemon died before the scrape —
    become roots, so churn degrades to a forest, never to data loss),
    compute per-span self time (duration minus direct children) and the
    per-daemon critical-path split."""
    by_id = {s["span_id"]: s for s in spans}
    children: Dict[int, List[Dict]] = {}
    roots: List[Dict] = []
    for s in spans:
        pid = s.get("parent_id")
        if pid is not None and pid in by_id:
            children.setdefault(pid, []).append(s)
        else:
            roots.append(s)

    def dur(s: Dict) -> float:
        start, end = s.get("start"), s.get("end")
        if start is None or end is None:
            return 0.0
        return max(0.0, end - start)

    self_time: Dict[str, float] = {}

    def build(s: Dict) -> Dict:
        kids = sorted(children.get(s["span_id"], []),
                      key=lambda c: c.get("start") or 0.0)
        d = dur(s)
        child_d = sum(dur(c) for c in kids)
        self_s = max(0.0, d - child_d)
        daemon = s.get("daemon", "?")
        self_time[daemon] = self_time.get(daemon, 0.0) + self_s
        node = dict(s)
        node["duration_ms"] = round(d * 1e3, 3)
        node["self_ms"] = round(self_s * 1e3, 3)
        node["children"] = [build(c) for c in kids]
        return node

    tree = [build(r) for r in
            sorted(roots, key=lambda s: s.get("start") or 0.0)]
    total = sum(dur(r) for r in roots)
    crit = sorted(({"daemon": d, "self_ms": round(t * 1e3, 3),
                    "frac": round(t / total, 4) if total else 0.0}
                   for d, t in self_time.items()),
                  key=lambda e: -e["self_ms"])
    return {"trace_id": trace_id, "trace_id_hex": f"{trace_id:016x}",
            "num_spans": len(spans), "roots": len(tree),
            "duration_ms": round(total * 1e3, 3),
            "critical_path": crit, "tree": tree}


def parse_endpoint_list(raw: str) -> List[Tuple[str, str, int]]:
    """``name=host:port,name2=host:port`` (name optional) ->
    [(name, host, port)]."""
    out: List[Tuple[str, str, int]] = []
    for item in (raw or "").split(","):
        item = item.strip()
        if not item:
            continue
        name, _, addr = item.rpartition("=")
        host, _, port = addr.rpartition(":")
        out.append((name or addr, host or "127.0.0.1", int(port)))
    return out
