"""Embedded HTTP server: the chassis the serving door and a trainer
rank's telemetry door ride.

The port's copy of ``hadoop_tpu/http/server.py``'s ``HttpServer``, with
its dispatch contract and standard servlets, so a handler written for
one runs on the other and a fleet tool reads both the same way:

- a handler ``fn(query, body)`` is registered under a path prefix
  (longest prefix wins) and receives the query parameters plus
  ``__path__``, ``__method__``, ``__cookie__`` (the ``Cookie`` header)
  and ``__trace__`` (the ``X-Htpu-Trace`` header), and the request body;
- it returns ``(status, payload)`` or ``(status, payload, headers)``: a
  dict or list goes out as JSON, a str as text, bytes as they are, and
  an iterator with chunked framing (raw bytes and a close for
  ``Connection: close`` or HTTP/1.0 clients). The iterator's ``close()``
  runs in a ``finally``, so a client that disconnects mid-stream
  finishes whatever the generator holds (a stream's span) at once;
- an exception a handler raises becomes a JSON ``RemoteException`` with
  404 (``FileNotFoundError``), 403 (``PermissionError``) or 500.

Standard endpoints, as the reference's:

- ``/jmx``: the metrics system as JSON (``?qry=`` filters sources);
- ``/prom``: Prometheus text, exemplars on unless ``?exemplars=0`` or
  ``metrics.prom.exemplars=false``;
- ``/health``: ``{"status": "alive", "daemon": name}``;
- ``/conf``: the live configuration, ``secret``, ``password``,
  ``keytab`` and ``credential`` keys shown as ``<redacted>``;
- ``/stacks`` (text) and ``/ws/v1/stacks`` (JSON): every thread's stack;
- ``/ws/v1/top``: the top-N of the decay accountings registered in
  ``obs/top.py`` (``?n=``);
- ``/ws/v1/traces``: the span collector's ring (``?trace_id=`` in hex
  or decimal, ``?limit=``), ``/ws/v1/traces/slow`` its flight recorder;
- ``/ws/v1/conf``: the port's generated conf-key registry
  (``conf/registry.py``) joined with the live conf, as the reference's
  rows (``?diff=1``: the set keys only; ``unregistered``: set keys the
  registry does not know); 503, as the reference's, without a registry.

Constructing a server configures the process's span collector from its
conf (the slow thresholds and sizes).

stdlib ``ThreadingHTTPServer``: one thread per connection.
"""

from __future__ import annotations

import json
import sys
import threading
import traceback
from fnmatch import fnmatchcase
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, unquote, urlparse

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.metrics import (build_info_prom, metrics_system,
                                      render_prom)
from hadoop_tpu_torch.obs.top import top_n
from hadoop_tpu_torch.tracing import (TRACE_HEADER,
                                      parse_trace_id_candidates,
                                      span_collector)

_REDACT = ("secret", "password", "keytab", "credential")


# a request body above this reaches the handler as a _BodyReader
STREAM_BODY_THRESHOLD = 4 * 1024 * 1024


class _BodyReader:
    """Bounded reader over the request socket for a large upload."""

    def __init__(self, rfile, n: int):
        self._rfile = rfile
        self.remaining = n

    def read(self, n: int = -1) -> bytes:
        if self.remaining <= 0:
            return b""
        want = self.remaining if n < 0 else min(n, self.remaining)
        data = self._rfile.read(want)
        self.remaining -= len(data)
        return data


def _redacted(key: str, value):
    return "<redacted>" if any(s in key.lower() for s in _REDACT) \
        else value


class HttpServer:
    """Path-prefix handlers on a threading HTTP/1.1 server."""

    def __init__(self, conf: Optional[ConfLike] = None,
                 bind: Tuple[str, int] = ("127.0.0.1", 0),
                 daemon_name: str = "daemon"):
        self.conf = conf or Configuration()
        self.daemon_name = daemon_name
        # path prefix -> fn(query_dict, body_bytes) -> (status, payload)
        self._handlers: Dict[str, Callable] = {}
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _dispatch(self, body: bytes = b""):
                try:
                    outer._dispatch(self, body)
                except BrokenPipeError:
                    pass
                except Exception as e:  # noqa: BLE001 — the handler's
                    # failure goes back to the client as a JSON error
                    try:
                        payload = json.dumps(
                            {"RemoteException": {
                                "exception": type(e).__name__,
                                "message": str(e)}}).encode()
                        self.send_response(
                            404 if isinstance(e, FileNotFoundError) else
                            403 if isinstance(e, PermissionError) else 500)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length",
                                         str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                    except OSError:
                        pass

            def do_GET(self):
                self._dispatch()

            def do_PUT(self):
                n = int(self.headers.get("Content-Length", 0) or 0)
                if n > STREAM_BODY_THRESHOLD:
                    # a large upload (a WebHDFS CREATE) reaches the
                    # handler as a bounded reader, never whole in memory
                    self._dispatch(_BodyReader(self.rfile, n))
                else:
                    self._dispatch(self.rfile.read(n) if n else b"")

            def do_POST(self):
                self.do_PUT()

            def do_DELETE(self):
                self._dispatch()

        self._httpd = ThreadingHTTPServer(bind, Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None
        self.add_handler("/jmx", self._jmx)
        self.add_handler("/conf", self._conf)
        self.add_handler("/stacks", self._stacks)
        self.add_handler("/health", lambda q, b: (
            200, {"status": "alive", "daemon": self.daemon_name}))
        self.add_handler("/prom", self._prom)
        self.add_handler("/ws/v1/traces", self._traces)
        self.add_handler("/ws/v1/traces/slow", self._traces_slow)
        self.add_handler("/ws/v1/stacks", self._ws_stacks)
        self.add_handler("/ws/v1/top", self._ws_top)
        self.add_handler("/ws/v1/conf", self._ws_conf)
        span_collector().configure(self.conf)

    def add_handler(self, prefix: str, fn: Callable) -> None:
        """``fn(query: dict, body: bytes) -> (status, obj|bytes|str|iter
        [, headers])``, matched by longest path prefix."""
        self._handlers[prefix] = fn

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"http-{self.daemon_name}-{self.port}", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # shutdown() waits for serve_forever's loop: on a server never
        # started it would wait forever
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()

    # ------------------------------------------------------------- dispatch

    def _dispatch(self, req, body: bytes) -> None:
        parsed = urlparse(req.path)
        path = unquote(parsed.path)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        query["__path__"] = path
        query["__method__"] = req.command
        query["__cookie__"] = req.headers.get("Cookie", "")
        query["__trace__"] = req.headers.get(TRACE_HEADER, "")
        handler = None
        best = -1
        for prefix, fn in self._handlers.items():
            if path == prefix or path.startswith(prefix.rstrip("/") + "/") \
                    or (prefix.endswith("/") and path.startswith(prefix)):
                if len(prefix) > best:
                    handler = fn
                    best = len(prefix)
        if handler is None:
            req.send_response(404)
            req.send_header("Content-Length", "0")
            req.end_headers()
            return
        out = handler(query, body)
        if len(out) == 3:
            status, payload, extra_headers = out
        else:
            status, payload = out
            extra_headers = {}
        if isinstance(payload, (dict, list)):
            payload = json.dumps(payload, default=str).encode()
            ctype = "application/json"
        elif isinstance(payload, str):
            payload = payload.encode()
            ctype = "text/plain"
        elif not isinstance(payload, (bytes, bytearray)):
            self._stream(req, status, payload, extra_headers)
            return
        else:
            ctype = "application/octet-stream"
        req.send_response(status)
        req.send_header("Content-Type", ctype)
        req.send_header("Content-Length", str(len(payload)))
        for name, value in extra_headers.items():
            req.send_header(name, value)
        req.end_headers()
        req.wfile.write(payload)

    @staticmethod
    def _stream(req, status: int, payload, extra_headers: Dict) -> None:
        """An iterator payload: chunked framing on the keep-alive
        connection, or raw bytes and a close for a client that asked for
        ``Connection: close`` or speaks HTTP/1.0."""
        raw_close = (req.headers.get("Connection", "").lower() == "close"
                     or req.request_version == "HTTP/1.0")
        req.send_response(status)
        req.send_header("Content-Type", "application/octet-stream")
        if raw_close:
            req.send_header("Connection", "close")
        else:
            req.send_header("Transfer-Encoding", "chunked")
        for name, value in extra_headers.items():
            req.send_header(name, value)
        req.end_headers()
        try:
            for chunk in payload:
                if not chunk:
                    continue
                if raw_close:
                    req.wfile.write(chunk)
                else:
                    req.wfile.write(f"{len(chunk):x}\r\n".encode())
                    req.wfile.write(chunk)
                    req.wfile.write(b"\r\n")
        finally:
            # a client that disconnects raises out of the write above and
            # leaves the generator suspended at a yield: close() runs its
            # cleanup (finishing any span it holds) now, not at some GC
            close = getattr(payload, "close", None)
            if close is not None:
                close()
        if raw_close:
            req.close_connection = True
        else:
            req.wfile.write(b"0\r\n\r\n")

    # ------------------------------------------------------------ endpoints

    def _jmx(self, query, body):
        snap = metrics_system().snapshot_all()
        qry = query.get("qry")
        if qry:
            snap = {k: v for k, v in snap.items() if k.startswith(qry)}
        return 200, {"beans": [dict(name=k, **v) for k, v in snap.items()]}

    def _prom(self, query, body):
        exemplars = self.conf.get_bool("metrics.prom.exemplars", True)
        q = (query.get("exemplars") or "").strip().lower()
        if q:
            exemplars = q not in ("0", "false", "no")
        return 200, (render_prom(metrics_system(), exemplars=exemplars)
                     + build_info_prom())

    def _conf(self, query, body):
        # /conf sits outside any auth filter, as the reference's: a
        # signing secret shown here would let anyone forge cookies
        return 200, {k: _redacted(k, v)
                     for k, v in self.conf.to_dict().items()}

    def _ws_conf(self, query, body):
        """The effective lever table: every key of the port's generated
        registry joined with this door's live conf (``source`` ``set`` or
        ``default``, ``effective`` redacted as ``/conf`` does), with the
        lever annotation where one exists. ``?diff=1`` keeps the set
        rows; ``unregistered`` lists set keys that no registered key or
        pattern names."""
        try:
            from hadoop_tpu_torch.conf import registry
        except ImportError:
            return 503, {"error": "conf registry not generated — run "
                                  "`python -m hadoop_tpu_torch.analysis "
                                  "--write-conf-registry`"}
        live = self.conf.to_dict()
        diff_only = (query.get("diff") or "") in ("1", "true", "yes")
        rows = []
        overridden = []
        for key, meta in sorted(registry.KEYS.items()):
            is_set = key in live
            if is_set:
                overridden.append(key)
            if diff_only and not is_set:
                continue
            row = {"key": key,
                   "type": meta["type"],
                   "defaults": list(meta["defaults"]),
                   "namespace": meta["namespace"],
                   "documented": meta["documented"],
                   "source": "set" if is_set else "default",
                   "effective": _redacted(key, live[key]) if is_set
                   else None}
            lever = registry.LEVERS.get(key)
            if lever is not None:
                row["lever"] = {lk: list(lv) if isinstance(lv, tuple) else lv
                                for lk, lv in lever.items()}
            rows.append(row)
        unregistered = sorted(
            k for k in live
            if k not in registry.KEYS
            and not any(fnmatchcase(k, p) for p in registry.PATTERNS))
        return 200, {
            "registry_keys": len(registry.KEYS),
            "patterns": sorted(registry.PATTERNS),
            "keys": rows,
            "overridden": overridden,
            "unregistered": [{"key": k, "value": _redacted(k, live[k])}
                             for k in unregistered],
        }

    @staticmethod
    def _bad(what: str, value):
        return 400, {"RemoteException": {
            "exception": "IllegalArgumentException",
            "message": f"bad {what} {value!r}"}}

    def _traces(self, query, body):
        tid = (query.get("trace_id") or "").strip()
        try:
            limit = int(query.get("limit", 0) or 0)
        except ValueError:
            return self._bad("limit", query.get("limit"))
        cands = set()
        if tid:
            cands = set(parse_trace_id_candidates(tid))
            if not cands:
                return self._bad("trace_id", tid)
        return 200, span_collector().snapshot(trace_id=cands or None,
                                              limit=limit)

    def _traces_slow(self, query, body):
        return 200, span_collector().slow_traces()

    def _stacks(self, query, body):
        out = []
        frames = sys._current_frames()
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            stack = "".join(traceback.format_stack(frame)) if frame else ""
            out.append(f'Thread "{t.name}" daemon={t.daemon}:\n{stack}')
        return 200, "\n".join(out)

    def _ws_stacks(self, query, body):
        threads = []
        frames = sys._current_frames()
        for t in threading.enumerate():
            frame = frames.get(t.ident)
            stack = [] if frame is None else [
                {"file": fs.filename, "line": fs.lineno, "func": fs.name}
                for fs in traceback.extract_stack(frame)]
            threads.append({"name": t.name, "daemon": t.daemon,
                            "ident": t.ident, "alive": t.is_alive(),
                            "stack": stack})
        return 200, {"daemon": self.daemon_name,
                     "num_threads": len(threads), "threads": threads}

    def _ws_top(self, query, body):
        try:
            n = int(query.get("n", 10) or 10)
        except ValueError:
            return self._bad("n", query.get("n"))
        return 200, {"daemon": self.daemon_name, "sources": top_n(n)}
