"""HTTP front-end of a serving replica: the door of the PyTorch engine.

The counterpart of ``hadoop_tpu/serving/server.py``'s ``ServingServer``,
with its wire contract (routes, JSON bodies, status codes, headers, conf
keys), over the port's chassis (``http/server.py``), so a client or
router built for a ``hadoop_tpu`` replica cannot tell the two apart:

    POST /v1/generate   {"tokens": [...], "max_new_tokens": 8,
                         "temperature": 0.7, "top_k": 40,
                         "stream": true, "timeout": 300}
    POST /v1/prefill    {"tokens": [...]}: 400, no DFS KV tier yet
    GET  /v1/health     liveness and load: queue depth, occupancy, free
                        KV pages, prefix cache, weights, HBM ledger, QoS
    POST /v1/admin/drain  graceful drain, 202 at once, idempotent

``/v1/generate``, ``/v1/prefill`` and ``/v1/admin/drain`` sit behind
the hadoop-auth filter when ``serving.http.auth.secret`` is set: callers
present ``?user.name=`` or the signed ``hadoop.auth`` cookie; anonymous
callers only if ``serving.http.auth.anonymous.allowed``. ``/v1/health``
stays outside it. Outcomes: 400 for a malformed request, 401 without a
credential, 408 when a blocking generation outlives its ``timeout``,
429 with ``Retry-After`` when the QoS gate sheds an over-share tenant,
500 when the engine fails the request, 503 once draining. A streamed
response is one JSON line per token (``{"token": t}``) and a terminal
``{"done": true, ...}`` line. An ``X-Htpu-Trace`` header continues the
caller's trace through ``serving.request`` into the engine's spans.

Handler threads do host work only: they read the engine's host mirrors
(occupancy, pool, prefix cache, weights) and never a device tensor, so a
scrape never waits on the step the scheduler thread is running.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from typing import Dict, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.http.server import HttpServer
from hadoop_tpu_torch.obs.hbm import hbm_ledger
from hadoop_tpu_torch.obs.slo import parse_class_map, slo_class_of
from hadoop_tpu_torch.security.http_auth import AuthFilter
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.tracing import SpanContext, global_tracer

log = logging.getLogger(__name__)

SECRET_KEY = "serving.http.auth.secret"
ANON_KEY = "serving.http.auth.anonymous.allowed"
MAX_NEW_CAP_KEY = "serving.max.new.tokens"


class ServingServer:
    """One replica's HTTP door in front of a ``DecodeEngine``."""

    def __init__(self, engine: DecodeEngine,
                 conf: Optional[ConfLike] = None,
                 bind: Tuple[str, int] = ("127.0.0.1", 0),
                 qos=None, drain_cb=None):
        self.engine = engine
        self.conf = conf or Configuration()
        self.http = HttpServer(self.conf, bind, daemon_name="serving")
        self.tracer = global_tracer()
        self._draining = threading.Event()
        # set when drain() has fully FINISHED (every in-flight request
        # delivered) — _draining only marks the start. /v1/health
        # exposes it so a controller never retires a replica that still
        # holds work
        self._drain_done = threading.Event()
        self.max_new_cap = self.conf.get_int(MAX_NEW_CAP_KEY, 1024)
        # door QoS (serving/qos.py): per-tenant decay-cost accounting +
        # load shedding in front of engine admission. None = open door
        # (bare servers in tests; ServingReplica wires the gate).
        self.qos = qos
        # fleet SLO scoreboard (obs/slo): every request is stamped
        # with a bounded tenant class — the QoS scheduler's decay
        # level clamped into p0..p3, or a conf-pinned identity — and
        # the door records class-labeled TTFT / per-token / outcome
        # families the doctor diffs per poll window
        self._class_map = parse_class_map(self.conf)
        # autoscaler hook: /v1/admin/drain invokes this (async) so a
        # controller can retire THIS replica — the replica process
        # wires its own full drain-and-exit here
        self.drain_cb = drain_cb
        self._drain_lock = threading.Lock()
        self._drain_started = False     # guarded-by: _drain_lock
        secret = self.conf.get(SECRET_KEY, "")
        handler = self._generate
        admin_drain = self._admin_drain
        if secret:
            filt = AuthFilter(
                secret.encode(),
                allow_anonymous=self.conf.get_bool(ANON_KEY, False))
            handler = filt.wrap(handler)
            admin_drain = filt.wrap(admin_drain)
        prefill_handler = self._prefill
        if secret:
            prefill_handler = filt.wrap(prefill_handler)
        self.http.add_handler("/v1/generate", handler)
        self.http.add_handler("/v1/prefill", prefill_handler)
        self.http.add_handler("/v1/health", self._health)
        self.http.add_handler("/v1/admin/drain", admin_drain)

    # ------------------------------------------------------------ lifecycle

    @property
    def port(self) -> int:
        return self.http.port

    def start(self) -> None:
        self.http.start()
        log.info("serving replica on :%d (slots=%d, kv pages=%d)",
                 self.port, self.engine.max_batch,
                 self.engine.pool.num_usable)

    def drain(self, timeout: float = 60.0) -> None:
        """Graceful shutdown, phase 1: refuse new work (503 + draining
        health so the router stops routing here), let the engine finish
        what it holds."""
        self._draining.set()
        self.engine.stop(drain=True, timeout=timeout)
        self._drain_done.set()

    def stop(self) -> None:
        if not self._draining.is_set():
            self.engine.stop()
        if self.qos is not None:
            self.qos.stop()
        self.http.stop()

    # ------------------------------------------------------------------ slo

    def _slo_class(self, tenant: str, level: int) -> str:
        """Bounded tenant class: the conf identity map wins, else the
        QoS decay level clamps into p0..p3 (open door => p0)."""
        cls = self._class_map.get(tenant or "anonymous")
        return cls if cls is not None else slo_class_of(level)

    def _slo_record(self, cls: str, outcome: str,
                    ttft_s: Optional[float] = None,
                    token_s: Optional[float] = None) -> None:
        m = getattr(self.engine, "metrics", None)
        if m is None or not hasattr(m, "slo_requests"):
            return                       # bare engines mint no metrics
        m.slo_requests[(cls, outcome)].incr()
        if ttft_s is not None:
            m.slo_ttft_hist[cls].add(ttft_s)
        if token_s is not None:
            m.slo_token_hist[cls].add(token_s)

    def _slo_finish(self, cls: str, handle, failed: bool) -> None:
        """Terminal accounting for an admitted request: outcome plus
        the latency families when a first token was delivered."""
        ttft_s = None
        token_s = None
        if handle.first_token_at is not None:
            ttft_s = max(0.0, handle.first_token_at
                         - handle.submitted_at)
            n = len(handle.out_tokens)
            if n >= 2:
                token_s = max(0.0, (time.monotonic()
                                    - handle.first_token_at)
                              / (n - 1))
        self._slo_record(cls, "failed" if failed else "ok",
                         ttft_s=ttft_s, token_s=token_s)

    # ------------------------------------------------------------- handlers

    def _health(self, query: Dict, body) -> Tuple[int, Dict]:
        eng = self.engine
        out = {
            "status": "draining" if self._draining.is_set() else "serving",
            "drain_complete": self._drain_done.is_set(),
            "queue_depth": eng.queue_depth,
            "active": eng.num_active,
            "slots": eng.max_batch,
            "kv_blocks_free": eng.pool.num_free,
            "kv_blocks_total": eng.pool.num_usable,
            "tokens_generated": eng.tokens_generated,
            "prefilling": eng.num_prefilling,
            # the autoscaler's per-replica load signals ride here (the
            # /prom exposition is process-wide, so an in-process fleet
            # can only tell replicas apart through this door)
            "prefill_backlog": eng.prefill_backlog,
            # prefix-reuse cache + chunked-prefill observability: the
            # router and ops dashboards read hit_rate/cached_blocks here
            "prefix_cache": eng.cache_stats(),
            # the weight plane: resident dtype, measured weight bytes,
            # quantize-at-load seconds, and the lanes x context those
            # bytes left room for (serving/weightplane.py)
            "weights": eng.weight_plane(),
            # the long-context plane: CP width, streamed-block and
            # window-page-in traffic, pinned compile counters — or
            # {"enabled": False} on a bitwise replica
            "longctx": eng.longctx_stats(),
        }
        # the live HBM ledger: what the chip's memory is spent on, one
        # scrape — weights / kv_pool / longctx window+tail components
        # cross-checked against the CUDA allocator's stats
        out["hbm"] = hbm_ledger().report()
        if self.qos is not None:
            out["qos"] = self.qos.stats()
        return 200, out

    def _admin_drain(self, query: Dict, body) -> Tuple[int, Dict]:
        """Autoscaler-initiated retirement: refuse new work, finish
        in-flight generations — asynchronously, so the controller gets its 202 immediately and
        watches /v1/health (then the registry record vanishing) for
        completion. Idempotent: a second POST during an active drain
        just reports it."""
        if query.get("__method__") != "POST":
            return 200, {"draining": self._draining.is_set()}
        # atomic check-and-set: two racing POSTs (controller retry vs
        # operator) must start exactly ONE drain thread — _draining is
        # only set later inside that thread, so it can't be the guard
        with self._drain_lock:
            already = self._drain_started
            self._drain_started = True
        if not already:
            cb = self.drain_cb or self.drain
            threading.Thread(target=cb, name="admin-drain",
                             daemon=True).start()
        return 202, {"draining": True, "already_draining": already}

    def _prefill(self, query: Dict, body):
        """The prefill half of prefill/decode disaggregation: prefill
        the prompt and persist its full-block KV span to the DFS tier.
        400 when this replica has no DFS tier (the port's engine has
        none yet, ROADMAP Queue A 3), so a router probing a
        misconfigured fleet fails fast instead of retrying the handoff
        everywhere."""
        if self._draining.is_set():
            return 503, {"RemoteException": {
                "exception": "RetriableException",
                "message": "replica draining"}}
        try:
            req = json.loads(body or b"{}")
            tokens = req["tokens"]
            if (not isinstance(tokens, list) or not tokens or
                    not all(isinstance(t, int) for t in tokens)):
                raise ValueError("'tokens' must be a non-empty int list")
            timeout = float(req.get("timeout", 300.0))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"RemoteException": {
                "exception": "IllegalArgumentException",
                "message": f"bad prefill request: {e}"}}
        parent = SpanContext.from_header(query.get("__trace__"))
        with self.tracer.span("serving.prefill_request",
                              parent=parent) as span:
            span.add_kv("prompt_tokens", str(len(tokens)))
            try:
                persisted = self.engine.prefill_to_store(
                    tokens, timeout=timeout)
            except ValueError as e:
                return 400, {"RemoteException": {
                    "exception": "IllegalArgumentException",
                    "message": str(e)}}
            except (RuntimeError, TimeoutError) as e:
                span.add_kv("failed", str(e))
                return 500, {"RemoteException": {
                    "exception": "PrefillFailedException",
                    "message": str(e)}}
            span.add_kv("persisted_tokens", str(persisted))
        return 200, {"persisted_tokens": persisted,
                     "prompt_tokens": len(tokens)}

    def _generate(self, query: Dict, body):
        if self._draining.is_set():
            return 503, {"RemoteException": {
                "exception": "RetriableException",
                "message": "replica draining"}}
        try:
            req = json.loads(body or b"{}")
            tokens = req["tokens"]
            if (not isinstance(tokens, list) or not tokens or
                    not all(isinstance(t, int) for t in tokens)):
                raise ValueError("'tokens' must be a non-empty int list")
            sampling = SamplingParams(
                max_new_tokens=min(int(req.get("max_new_tokens", 16)),
                                   self.max_new_cap),
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                stop_token=req.get("stop_token"))
            timeout = float(req.get("timeout", 300.0))
        except (KeyError, TypeError, ValueError) as e:
            return 400, {"RemoteException": {
                "exception": "IllegalArgumentException",
                "message": f"bad generate request: {e}"}}
        # the tenant is the authenticated principal (the auth filter's
        # __user__), falling back to the unauthenticated ?user.name=
        # claim — QoS fairness, unlike authz, is useful even on an
        # open door
        tenant = query.get("__user__") or query.get("user.name") or ""
        slo_cls = self._slo_class(tenant, 0)
        if self.qos is not None:
            ok, retry_after, level = self.qos.admit(
                tenant, self.qos.cost_of(tokens,
                                         sampling.max_new_tokens))
            slo_cls = self._slo_class(tenant, level)
            if not ok:
                self._slo_record(slo_cls, "shed")
                # the router treats 429 + Retry-After as
                # retriable-on-another-replica; a direct caller backs
                # off — either way this replica sheds the over-share
                # tenant before light tenants feel the overload
                return (429,
                        {"RemoteException": {
                            "exception": "ServerTooBusyException",
                            "message": f"tenant {tenant or 'anonymous'} "
                                       f"over fair share (priority "
                                       f"{level}) under overload"}},
                        {"Retry-After": f"{retry_after:g}"})
        # resume the ROUTER's trace from the X-Htpu-Trace header (the
        # HTTP twin of the RPC header's SpanContext): the door, engine
        # admit, and first token all join the request's one trace
        parent = SpanContext.from_header(query.get("__trace__"))
        span = self.tracer.span("serving.request", parent=parent)
        span.add_kv("user", query.get("__user__", ""))
        span.add_kv("prompt_tokens", str(len(tokens)))
        try:
            # the door span's context rides the request into the engine
            # so admit/preempt/first-token spans join this trace
            handle = self.engine.submit(tokens, sampling,
                                        trace_ctx=span.context(),
                                        tenant=tenant)
        except ValueError as e:
            span.finish()
            return 400, {"RemoteException": {
                "exception": "IllegalArgumentException",
                "message": str(e)}}
        span.add_kv("request", str(handle.id))
        if str(req.get("stream", "")).lower() in ("1", "true", "yes") or \
                req.get("stream") is True:
            return 200, self._stream(handle, span, slo_cls)
        try:
            out = handle.wait(timeout=timeout)
        except RuntimeError as e:
            # engine failed the request (decode error, stop/drain):
            # the span must still deliver — the failure path is exactly
            # where the cross-daemon trace earns its keep
            span.add_kv("failed", str(e))
            span.finish()
            self._slo_finish(slo_cls, handle, failed=True)
            return 500, {"RemoteException": {
                "exception": "GenerationFailedException",
                "message": f"request {handle.id}: {e}"}}
        except TimeoutError:
            # 4xx on purpose: the router fails 4xx fast, so a slow
            # generation is NOT replayed end-to-end on every other
            # replica (retry amplification exactly when the fleet is
            # loaded); the request keeps decoding here and its tokens
            # drop — same semantics as a client killing a stream
            span.add_kv("timed_out", "true")
            span.finish()
            # a missed deadline spends error budget: the caller never
            # got their generation, whatever the engine does next
            self._slo_record(slo_cls, "failed")
            return 408, {"RemoteException": {
                "exception": "RequestTimedOutException",
                "message": f"request {handle.id} still decoding after "
                           f"{timeout}s"}}
        span.add_kv("tokens_out", str(len(out)))
        span.finish()
        self._slo_finish(slo_cls, handle, failed=False)
        return 200, {"request_id": handle.id, "tokens": out,
                     "prompt_tokens": len(tokens)}

    def _stream(self, handle, span, slo_cls: str = "p0"):
        """Chunked body: one JSON line per token, terminal summary line.
        The chassis frames each yielded chunk; a killed connection just
        ends the generator — the engine finishes the request and the
        tokens fall on the floor, which is the right drop semantics."""
        timed_out = [False]

        def gen():
            try:
                while True:
                    try:
                        tok = handle.tokens_out.get(timeout=300.0)
                    except queue.Empty:
                        timed_out[0] = True
                        yield (json.dumps(
                            {"error": "timed out"}) + "\n").encode()
                        return
                    if tok is None:
                        break
                    yield (json.dumps({"token": tok}) + "\n").encode()
                done = {"done": True, "request_id": handle.id,
                        "tokens": list(handle.out_tokens)}
                if handle.state == "FAILED":
                    done = {"done": True, "error": handle.error,
                            "request_id": handle.id}
                yield (json.dumps(done) + "\n").encode()
            finally:
                span.add_kv("tokens_out", str(len(handle.out_tokens)))
                span.finish()
                self._slo_finish(
                    slo_cls, handle,
                    failed=timed_out[0] or handle.state == "FAILED")
        return gen()
