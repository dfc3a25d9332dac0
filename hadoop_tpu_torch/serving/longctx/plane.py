"""The long-context serving plane: one replica's long-prompt lane.

The counterpart of ``hadoop_tpu/serving/longctx/plane.py``. It ties the
pieces into a request lifecycle the door already understands:

    engine.submit() routes prompts >= ``serving.longctx.min.tokens``
    here (under the ``serving.parity=relaxed`` guard) →
    CP prefill (``prefill.py``; the sp ranks share the one device) →
    the finished KV blocks stream straight into the host/DFS tiers
    (``TieredKVCache.ingest_chain``: digest-chained, codec-eligible,
    never pinned in the engine's pool) →
    the first token sampled from the CP logits →
    working-set decode (``decode.py``) pages the chain back through a
    fixed device window while generated tokens' K/V accumulates in the
    device tail.

The plane runs its own single worker thread: a long prefill is a
whole-device job, so two cannot overlap anyway, and the engine's fused
step keeps serving short prompts beside it (its two step shapes and
their CUDA graphs are untouched; the plane's pieces count their own
shapes, ``decode.trace_counts``).

Requests are ordinary ``GenRequest``s: tokens stream through the same
queue, the same door handlers and trace ids (``serving.longctx.prefill``
/ ``serving.longctx.decode`` spans join the request's trace), and the
same metrics (``htpu_longctx_*``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.obs.hbm import hbm_ledger
from hadoop_tpu_torch.serving.engine import (FAILED, FINISHED, RUNNING,
                                             GenRequest, SamplingParams,
                                             _to_host)
from hadoop_tpu_torch.serving.longctx.decode import (WorkingSetDecoder,
                                                     _host_sample,
                                                     dispatch_counts,
                                                     trace_counts)
from hadoop_tpu_torch.serving.longctx.prefill import ContextParallelPrefiller
from hadoop_tpu_torch.tracing import global_tracer

log = logging.getLogger(__name__)

ENABLED_KEY = "serving.longctx.enabled"
MIN_TOKENS_KEY = "serving.longctx.min.tokens"
MAX_TOKENS_KEY = "serving.longctx.max.tokens"
CHIPS_KEY = "serving.longctx.chips"
SP_MODE_KEY = "serving.longctx.sp.mode"
WINDOW_KEY = "serving.longctx.decode.window.blocks"
TAIL_KEY = "serving.longctx.decode.tail.tokens"
PIPELINE_KEY = "serving.longctx.decode.pipeline"
SAMPLER_KEY = "serving.longctx.decode.sampler"
FETCH_KEY = "serving.longctx.decode.fetch.windows"


def _host_blocks(blocks):
    """The prefill's block stream as the tiers hold payloads: numpy, bf16
    as uint16 bits."""
    for k, v in blocks:
        yield _to_host(k), _to_host(v)


class LongContextPlane:
    """CP prefill + tier streaming + working-set decode behind one
    submit seam. Construct directly (tests, benches) or from conf via
    :func:`longctx_plane_from_conf`."""

    def __init__(self, params, cfg: ModelConfig, store, *,
                 block_size: int, min_tokens: int,
                 max_tokens: Optional[int] = None, sp: int = 0,
                 sp_mode: str = "ring", window_blocks: int = 4,
                 tail_tokens: int = 256, pipeline: bool = True,
                 sampler: str = "device", fetch_windows: int = 0,
                 devices=None, metrics=None, tracer=None):
        if not store.cold_enabled:
            raise ValueError(
                "the longctx plane streams prefill KV into the cold "
                "tiers — enable serving.kv.host.bytes and/or "
                "serving.kv.dfs.enable")
        # a quantized tree serves int8-resident: the CP prefill and the
        # pipelined decoder run their matmuls through the weight plane,
        # so the plane shares the engine's one resident copy. The
        # attribute stays (always 0) for the stats / health surface.
        self.dequantized_view_bytes = 0
        self.cfg = cfg
        self.store = store
        self.min_tokens = int(min_tokens)
        self.metrics = metrics
        self.tracer = tracer or global_tracer()
        self.prefiller = ContextParallelPrefiller(
            params, cfg, block_size=block_size,
            pad_tokens=max_tokens or cfg.max_seq, sp=sp,
            sp_mode=sp_mode, devices=devices)
        self.decoder = WorkingSetDecoder(
            params, cfg, store, block_size=block_size,
            window_blocks=window_blocks, tail_tokens=tail_tokens,
            pipeline=pipeline, sampler=sampler,
            fetch_windows=fetch_windows, metrics=metrics)
        self.requests_served = 0
        self.blocks_streamed = 0
        self._q: "queue.Queue" = queue.Queue()
        # accepted-but-unfinished requests: incremented at submit BEFORE
        # the queue put, decremented after serve, so `idle` never races
        # a request between q.get() and "busy"
        self._inflight = 0              # guarded-by: _inflight_lock
        self._inflight_lock = threading.Lock()
        # called after every request completes (success or failure): the
        # engine wires its scheduler condition here, so a drain parked on
        # `idle` wakes when the plane finishes
        self.on_done = None
        self._stopped = threading.Event()
        # orders submit's stopped-check + enqueue against stop(): a
        # submit racing shutdown either lands BEFORE the sentinel (the
        # drain loop fails it) or sees _stopped and raises
        self._admit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._work_loop,
                                        name="longctx-plane", daemon=True)
        self._worker.start()
        if metrics:
            metrics.longctx_chips.set(self.prefiller.sp)
        # the HBM ledger (obs/hbm.py): the decode working set as window
        # (both slabs of the double buffer when pipelining), tail, and
        # the device sampler's state when it is on
        self._hbm_owner = f"longctx@{id(self)}."
        dec = self.decoder
        led = hbm_ledger()
        led.register(f"{self._hbm_owner}window", "longctx_window",
                     lambda: dec.hbm_window_bytes)
        led.register(f"{self._hbm_owner}tail", "longctx_tail",
                     lambda: dec.tail_cap * dec._per_tok_bytes)
        if dec.sampler_state_bytes:
            led.register(f"{self._hbm_owner}sampler", "longctx_sampler",
                         lambda: dec.sampler_state_bytes)

    # ----------------------------------------------------------- submit

    def longctx_submit(self, prompt: List[int], sampling=None,
                       trace_ctx=None, tenant: str = ""):
        """Admit one long prompt. Relaxed-tier entry point: the engine
        calls this under its ``serving.parity=relaxed`` guard. Raises
        ``ValueError`` for requests the plane can never serve (the door's
        400)."""
        sampling = sampling or SamplingParams()
        s = len(prompt)
        bs = self.decoder.block_size
        if s > self.prefiller.pad_tokens:
            raise ValueError(
                f"prompt ({s} tokens) exceeds {MAX_TOKENS_KEY}="
                f"{self.prefiller.pad_tokens}")
        if s + sampling.max_new_tokens > self.cfg.max_seq:
            # generated positions past the rope/pos tables would clamp
            # to the last row: wrong logits, no error
            raise ValueError(
                f"prompt({s}) + max_new({sampling.max_new_tokens}) "
                f"exceeds the model's max_seq {self.cfg.max_seq}")
        tail_len = s % bs
        if tail_len + sampling.max_new_tokens > self.decoder.tail_cap:
            raise ValueError(
                f"prompt tail ({tail_len}) + max_new "
                f"({sampling.max_new_tokens}) exceeds {TAIL_KEY}="
                f"{self.decoder.tail_cap}")
        n_full = s // bs
        if not self.store.dfs_enabled and self.store.host is not None:
            # a host-ring-only deployment must hold the WHOLE chain plus
            # churn slack: the fused step demotes its evictions into the
            # same ring, and an exact-fit chain would lose its head to
            # the first concurrent demotion (one full pool sweep is the
            # per-request bound; heavier churn wants the DFS tier)
            need = n_full + self.store.pool.num_usable
            if self.store.host.capacity < need:
                raise ValueError(
                    f"longctx chain needs {n_full} host-ring blocks "
                    f"plus {self.store.pool.num_usable} demotion-churn "
                    f"slack but serving.kv.host.bytes holds "
                    f"{self.store.host.capacity}; grow the ring or "
                    f"enable the DFS tier")
        req = GenRequest(prompt=list(prompt), sampling=sampling,
                         trace_ctx=trace_ctx, tenant=tenant)
        with self._admit_lock:
            if self._stopped.is_set():
                raise ValueError("longctx plane is stopped")
            with self._inflight_lock:
                self._inflight += 1
            self._q.put(req)
        if self.metrics:
            self.metrics.requests.incr()
            self.metrics.longctx_requests.incr()
        return req

    # ----------------------------------------------------- request work

    def _work_loop(self) -> None:
        while True:
            req = self._q.get()
            if req is None:
                return
            try:
                self._serve(req)
            except Exception as e:  # noqa: BLE001 — fail the request,
                # not the lane: a poisoned prompt must not wedge every
                # later long prompt behind a dead worker
                log.warning("longctx request %d failed: %s", req.id, e)
                req._finish(FAILED, f"longctx failed: {e}")
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
                done_cb = self.on_done
                if done_cb is not None:
                    done_cb()

    def _serve(self, req) -> None:
        req.state = RUNNING
        sp = self.tracer.span("serving.longctx.prefill",
                              parent=req.trace_ctx)
        sp.add_kv("request", str(req.id))
        sp.add_kv("prompt_tokens", str(len(req.prompt)))
        sp.add_kv("chips", str(self.prefiller.sp))
        sp.add_kv("sp_mode", self.prefiller.sp_mode)
        try:
            res = self.prefiller.cp_prefill(req.prompt)
        finally:
            sp.finish()
        # the first token BEFORE the tier ingest: it needs only the CP
        # logits, so TTFT is the prefill's time, not prefill + writes
        rng = np.random.default_rng(req.id)
        smp = req.sampling
        first = _host_sample(res.last_logits, smp.temperature, smp.top_k,
                             rng)
        self._deliver(req, first)
        ttft = req.first_token_at - req.submitted_at
        if self.metrics:
            self.metrics.ttft.add(ttft)
            self.metrics.ttft_hist.add(
                ttft, exemplar_trace=req.trace_ctx.trace_id
                if req.trace_ctx is not None and req.trace_ctx.sampled
                else None)
        streamed = self.store.ingest_chain(req.prompt,
                                           _host_blocks(res.blocks),
                                           parent_ctx=req.trace_ctx)
        self.blocks_streamed += streamed
        if self.metrics:
            self.metrics.longctx_blocks_streamed.incr(streamed)
            self.metrics.longctx_prefill_hist.add(res.seconds)
        if streamed and self.store.dfs_enabled:
            # decode reads the chain back THROUGH the tiers: when the
            # host ring is smaller than the chain, the head blocks exist
            # only in the store, so wait for durability first
            if not self.store.flush(timeout=120.0,
                                    up_to=self.store.persists_enqueued):
                raise RuntimeError(
                    "longctx DFS persist did not drain before decode "
                    "(the store slow or refusing writes?)")
        done = smp.max_new_tokens <= 1 or \
            (smp.stop_token is not None and first == smp.stop_token)
        if not done:
            dsp = self.tracer.span("serving.longctx.decode",
                                   parent=req.trace_ctx)
            dsp.add_kv("request", str(req.id))
            try:
                # the SAME rng that drew the first token (re-seeding would
                # replay its stream); the device sampler keys off seed =
                # req.id and the position
                self.decoder.paged_decode(
                    req.prompt, first, smp,
                    tail_k=res.tail_k, tail_v=res.tail_v,
                    deliver=lambda t: self._deliver(req, t),
                    stop=self._stopped.is_set, seed=req.id, rng=rng,
                    parent_ctx=req.trace_ctx)
            finally:
                dsp.add_kv("tokens_out", str(len(req.out_tokens)))
                dsp.finish()
        self.requests_served += 1
        # a non-drain stop truncates the generation: that surfaces as a
        # failure, so a client can tell 37-then-stopped from complete
        truncated = self._stopped.is_set() and \
            len(req.out_tokens) < smp.max_new_tokens and \
            (smp.stop_token is None or
             req.out_tokens[-1] != smp.stop_token)
        if truncated:
            req._finish(FAILED, "longctx plane stopped mid-generation")
        else:
            req._finish(FINISHED)

    def _deliver(self, req, tok: int) -> None:
        req._deliver(tok)
        if self.metrics:
            self.metrics.tokens_out.incr()

    # ------------------------------------------- disaggregation handoff

    def prefill_to_store(self, prompt: List[int],
                         timeout: float = 60.0) -> int:
        """The /v1/prefill half for long prompts: CP prefill, stream the
        chain into the tiers, wait for DFS durability. Returns the
        durable token span (full blocks only)."""
        if not self.store.dfs_enabled:
            raise ValueError("longctx prefill handoff needs the DFS KV "
                             "tier (serving.kv.dfs.enable)")
        # the handoff runs on the door's HTTP thread: it counts as
        # in-flight work, or a concurrent engine.stop(drain=True) reads
        # the plane idle and closes the store under this flush
        with self._admit_lock:
            if self._stopped.is_set():
                raise ValueError("longctx plane is stopped")
            with self._inflight_lock:
                self._inflight += 1
        try:
            fails_before = self.store.stats()["dfs_persist_failures"]
            res = self.prefiller.cp_prefill(prompt)
            n = self.store.ingest_chain(prompt, _host_blocks(res.blocks))
            watermark = self.store.persists_enqueued
            if n and not self.store.flush(timeout, up_to=watermark):
                raise TimeoutError(
                    f"longctx DFS persist did not drain in {timeout}s")
            # flush() counts failed persists toward its watermark: a
            # refused write is never reported as a durable handoff
            fails = self.store.stats()["dfs_persist_failures"] \
                - fails_before
            durable = max(0, n - fails)
            if n and not durable:
                raise RuntimeError(
                    f"longctx handoff persist failed: 0/{n} blocks "
                    "durable (the store refusing writes?)")
            return durable * self.decoder.block_size
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            done_cb = self.on_done
            if done_cb is not None:
                done_cb()

    # -------------------------------------------------------- lifecycle

    @property
    def idle(self) -> bool:
        with self._inflight_lock:
            return self._inflight == 0

    def stop(self, drain: bool = False, timeout: float = 30.0) -> None:
        hbm_ledger().unregister_prefix(self._hbm_owner)
        if drain:
            deadline = time.monotonic() + timeout
            while not self.idle and time.monotonic() < deadline:
                time.sleep(0.02)
        with self._admit_lock:
            # once set under the lock no submit can enqueue; everything
            # in the queue is older than the sentinel
            self._stopped.set()
            self._q.put(None)
        self._worker.join(timeout=timeout)
        # fail anything still queued: a submit that raced this shutdown
        # must fail its request, never strand a client on .done
        sentinel_seen = False
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is None:
                sentinel_seen = True
                continue
            with self._inflight_lock:
                self._inflight -= 1
            if not req.done.is_set():
                req._finish(FAILED, "longctx plane stopped")
        if sentinel_seen and self._worker.is_alive():
            # the join timed out mid-request and this drain swallowed the
            # worker's sentinel: re-arm it
            self._q.put(None)

    def stats(self) -> Dict:
        dec = self.decoder
        return {
            "enabled": True,
            "min_tokens": self.min_tokens,
            "max_tokens": self.prefiller.pad_tokens,
            "chips": self.prefiller.sp,
            "sp_mode": self.prefiller.sp_mode,
            "requests": self.requests_served,
            "blocks_streamed": self.blocks_streamed,
            "window_fetches": dec.window_fetches,
            "window_tokens": dec.win,
            "tail_tokens": dec.tail_cap,
            "decode_pipeline": dec.pipeline,
            "decode_sampler": dec.sampler,
            "fetch_windows": dec.fetch_windows,
            "int8_weights": dec.relaxed_qweights,
            "tokens_decoded": dec.tokens_decoded,
            "decode_dispatches": dec.dispatches,
            "dispatches_per_token": round(dec.dispatches_per_token, 2),
            "hbm_window_bytes": dec.hbm_window_bytes,
            "hbm_working_set_bytes": dec.hbm_working_set_bytes,
            "dequantized_view_bytes": self.dequantized_view_bytes,
            "prefill_compiles": self.prefiller.prefill_compiles,
            "decode_traces": trace_counts(),
            "decode_dispatch_counts": dispatch_counts(),
        }


def longctx_plane_from_conf(conf, cfg: ModelConfig, engine
                            ) -> LongContextPlane:
    """Build the plane off a replica's conf and engine, on the engine's
    device. Relaxed-tier entry point: callers gate on
    ``serving.parity=relaxed``, and this re-validates (the CP softmax
    reassociation is not bitwise)."""
    from hadoop_tpu_torch.serving.weightplane import weightplane_from_conf
    wp = weightplane_from_conf(conf)
    if not wp.relaxed:
        raise ValueError(
            f"{ENABLED_KEY} requires serving.parity=relaxed — the CP "
            "softmax reassociation is not bitwise vs the single-device "
            "step")
    return LongContextPlane(
        engine.params, cfg, engine.kvstore,
        block_size=engine.block_size,
        min_tokens=conf.get_int(MIN_TOKENS_KEY, 4096),
        max_tokens=conf.get_int(MAX_TOKENS_KEY, 0) or cfg.max_seq,
        sp=conf.get_int(CHIPS_KEY, 0),
        sp_mode=conf.get(SP_MODE_KEY, "ring"),
        window_blocks=conf.get_int(WINDOW_KEY, 4),
        tail_tokens=conf.get_int(TAIL_KEY, 256),
        pipeline=conf.get_bool(PIPELINE_KEY, True),
        sampler=conf.get(SAMPLER_KEY, "device"),
        fetch_windows=conf.get_int(FETCH_KEY, 0),
        devices=[engine.device],
        metrics=engine.metrics, tracer=engine.tracer)
