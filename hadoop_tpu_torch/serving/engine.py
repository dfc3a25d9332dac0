"""Continuous-batching decode engine over ``models.decoder`` weights.

The port of ``DecodeEngine`` (``hadoop_tpu/serving/engine.py``) for one GPU,
keeping its semantics:

- **One fused step.** Every row of a step is "one token at one position,
  scattered into and gathered through a block table": the first
  ``max_batch`` rows are the running decode lanes, and when a prompt is
  prefilling, ``prefill_chunk`` more rows carry a chunk of it. The step
  has exactly two shapes (decode-only and fused); ``decode_compiles`` /
  ``prefill_compiles`` count the distinct row counts each family used,
  so a workload that keeps to the two shapes reads 1 and 1. Unlike the
  reference, which runs the fused step's rows as one batch, the lanes
  and the chunk run as two row groups of fixed size inside it, so each
  row meets the same op shapes in every step and a request's tokens do
  not depend on the rest of the batch (in bf16 on the GPU, a lane's
  rounding otherwise changed with the step shape that carried it). A
  preempted request's tokens, recomputed as prompt rows, may still
  round otherwise. The chunk's rows, all of one request, gather that
  request's paged context once, not once per row.
- **Paged KV cache.** K/V live in a pool ``[L, num_blocks, block_size,
  Hkv, Dh]``; each running request owns a block table. Each step
  scatters the new rows' K/V into ``table[pos // bs], pos % bs`` and
  gathers each row's context back through its table. Block 0 is a
  write-off scratch page for inactive rows and chunk padding. The pools
  are updated in place (the JAX engine donates them to the same end).
- **Prefix reuse.** A radix index remembers fully-filled prompt blocks;
  a new request whose prefix walks a cached path maps those pages
  (shared, read-only) and prefills only the tail. Zero-ref cached pages
  are evicted LRU when the pool runs dry, before the youngest running
  request is preempted (recompute preemption).
- **Device-resident step state.** Tables, positions, last tokens,
  active mask, sampling params and token budgets are tensors on the
  device, changed from the host only on slot events (admission, prefill
  completion, page growth, preemption, release). The stop-condition
  scan runs on the device and the host reads back one packed ``[B, 4]``
  bundle (token | emit count | finished | accept length) per step.
- **Sampling.** Greedy when temperature <= 0, else top-k + temperature
  (``_mask_and_scale``) and a Gumbel-max draw from a ``torch.Generator``
  seeded with the step count, the counterpart of the JAX engine's
  carried per-step PRNG seed.

- **Two CUDA graphs.** The reference compiles each step shape once; on a
  CUDA device the port captures each once as a ``torch.cuda.CUDAGraph``
  and replays it, so a step is one graph launch instead of some 1300
  kernel launches from the host. The step reads only device tensors that
  live as long as the engine (the step state, written in place, and one
  static buffer for the chunk's tokens, slot, start and length), and the
  sampler's generator is registered with each graph, so a replay draws
  what the eager step draws from the same seed. The first step of each
  shape runs eagerly (its warm-up) and is then captured; a capture that
  fails raises. On the CPU the step runs eagerly.
- **HBM ledger.** The weights and the K/V pool are registered with the
  process's ledger (``obs/hbm.py``) and unregistered by ``stop()``.
- **The door's hooks**, at the reference's call sites: ``metrics=`` (a
  ``serving/metrics.py`` ``ServingMetrics``) and ``tracer=`` (the
  ``serving.admit``, ``serving.preempt`` and ``serving.first_token``
  spans join each request's ``trace_ctx``); ``submit(..., tenant=)``
  and ``admission_queue=``, any deque-shaped queue installed as the
  pending queue (the door's QoS ``FairAdmissionQueue``). All of it is
  host work on host mirrors, outside the captured graphs: it reads no
  device tensor and adds no synchronisation to the step. TTFT is stamped
  when the first token reaches the host, at the step's one readback.

Attention in the step is torch ops (the reference's is plain jnp too) —
the flash kernel does not take paged, offset rows.

Not ported yet, and refused with ``NotImplementedError`` when asked for:
speculation, the host/DFS KV tiers, the int8 weight plane, MoE, the
long-context plane, tensor-parallel ``plan`` and ``hbm_bytes`` sizing.
``prefill_to_store`` raises the reference's ``ValueError`` for a replica
without a DFS tier, which the port's always is.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hadoop_tpu_torch.device import check_on, resolve_device
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import _norm, head_matrix, layer_slices
from hadoop_tpu_torch.obs.hbm import hbm_ledger, tree_nbytes
from hadoop_tpu_torch.ops import gelu, rope_frequencies, swiglu
from hadoop_tpu_torch.serving.kvstore import BlockPool, PrefixCache
from hadoop_tpu_torch.tracing import current_context, global_tracer

log = logging.getLogger(__name__)

_NEG_INF = -1e30


# --------------------------------------------------------------- requests

@dataclass
class SamplingParams:
    """Per-request decode controls. ``temperature <= 0`` is greedy;
    ``top_k <= 0`` disables the top-k filter."""
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    stop_token: Optional[int] = None


_req_ids = itertools.count(1)

QUEUED, RUNNING, FINISHED, FAILED = "QUEUED", "RUNNING", "FINISHED", "FAILED"


@dataclass
class GenRequest:
    """One generation request. Tokens stream into ``tokens_out`` (a
    Queue terminated by ``None``); ``done`` fires at completion."""
    prompt: List[int]
    sampling: SamplingParams
    id: int = field(default_factory=lambda: next(_req_ids))
    state: str = QUEUED
    out_tokens: List[int] = field(default_factory=list)
    tokens_out: "queue.Queue" = field(default_factory=queue.Queue)
    done: threading.Event = field(default_factory=threading.Event)
    error: Optional[str] = None
    submitted_at: float = field(default_factory=time.monotonic)
    first_token_at: Optional[float] = None
    # auth identity for door QoS: the fair admission queue orders
    # pending requests by the tenant's decayed usage share
    tenant: str = ""
    preemptions: int = 0
    prefix_tokens_reused: int = 0     # cached tokens mapped at admission
    # the door span's context: engine-side spans run on the scheduler
    # thread, where no contextvar of the caller's survives
    trace_ctx: Optional[Any] = None
    # engine-private placement
    _slot: Optional[int] = None
    _blocks: List[int] = field(default_factory=list)
    _ctx: List[int] = field(default_factory=list)
    _prefill_pos: Optional[int] = None  # next position to prefill
    _admit_seq: int = 0

    def _deliver(self, token: int) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self.out_tokens.append(token)
        self.tokens_out.put(token)

    def _finish(self, state: str = FINISHED, error: str = None) -> None:
        self.state = state
        self.error = error
        self.tokens_out.put(None)
        self.done.set()

    def wait(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError(f"request {self.id} not done")
        if self.state == FAILED:
            raise RuntimeError(self.error or "generation failed")
        return list(self.out_tokens)


# ------------------------------------------------------------ step pieces

def _rope_at(x, cos, sin, pos):
    """Rotate one token per row: x [T, H, Dh], pos [T]."""
    c = cos[pos][:, None, :]
    s = sin[pos][:, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)


def _mask_and_scale(logits, temps, topks):
    """The top-k mask + temperature transform ``_sample`` draws from,
    over any leading axes."""
    v = logits.shape[-1]
    srt = torch.sort(logits, dim=-1).values                  # ascending
    kidx = torch.clamp(v - topks, 0, v - 1)
    kth = torch.gather(srt, -1, kidx[..., None].long())[..., 0]
    drop = (topks > 0)[..., None] & (logits < kth[..., None])
    masked = torch.where(drop, torch.full_like(logits, _NEG_INF), logits)
    return masked / torch.clamp(temps, min=1e-6)[..., None]


def _sample(logits, temps, topks, generator: torch.Generator):
    """logits [T, V] float32; per-row temperature/top-k; greedy when
    temperature <= 0, else a Gumbel-max draw from the scaled logits."""
    greedy = torch.argmax(logits, dim=-1)
    scaled = _mask_and_scale(logits, temps, topks)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temps <= 0, greedy, sampled)


def _refuse(what: str) -> None:
    raise NotImplementedError(f"{what} is not ported to the PyTorch engine "
                              "yet (see ROADMAP.md)")


# ----------------------------------------------------------------- engine

class DecodeEngine:
    """Continuous-batching decode over a fixed slot batch and a paged KV
    pool, with prefix reuse and step-fused chunked prefill. Drive it
    with the background scheduler thread (``start``/``submit``/``stop``)
    or by calling ``step()`` directly (tests, offline runs)."""

    def __init__(self, params, cfg: ModelConfig, *,
                 max_batch: int = 4, block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 max_context: Optional[int] = None,
                 prefill_chunk: int = 16,
                 prefix_cache: bool = True,
                 device=None,
                 speculate_k: int = 0, kv_host_bytes: int = 0,
                 kv_store_fs=None, hbm_bytes: int = 0, plan=None,
                 admission_queue=None, metrics=None, tracer=None):
        if speculate_k:
            _refuse("speculative decoding")
        if kv_host_bytes or kv_store_fs is not None:
            _refuse("the host/DFS KV tiers")
        if hbm_bytes:
            _refuse("hbm_bytes sizing")
        if plan is not None:
            _refuse("tensor-parallel serving")
        if cfg.is_moe:
            _refuse("MoE serving")
        if any(isinstance(w, dict) for w in params["layers"].values()):
            _refuse("the int8 weight plane")
        self.device = resolve_device(device)
        check_on(params["embed"], self.device, "params")
        self.cfg = cfg
        self.params = params
        self.block_size = block_size
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.max_context = min(max_context or cfg.max_seq, cfg.max_seq)
        self.blocks_per_seq = -(-self.max_context // block_size)
        self.s_max = self.blocks_per_seq * block_size
        if self.s_max > cfg.max_seq:
            # never round past the rope/pos-embed tables: positions
            # beyond max_seq would silently clamp (wrong logits)
            self.blocks_per_seq = cfg.max_seq // block_size
            if self.blocks_per_seq == 0:
                raise ValueError(f"block_size {block_size} exceeds the "
                                 f"model's max_seq {cfg.max_seq}")
            self.s_max = self.blocks_per_seq * block_size
        self.max_batch = max_batch
        if num_blocks is None:
            num_blocks = max_batch * self.blocks_per_seq + 1
        self.pool = BlockPool(num_blocks, block_size)
        self.prefix_cache = PrefixCache(block_size) if prefix_cache else None
        pool_shape = (cfg.n_layers, num_blocks, block_size, cfg.n_kv_heads,
                      cfg.head_dim)
        self._kp = torch.zeros(pool_shape, dtype=cfg.torch_dtype,
                               device=self.device)
        self._vp = torch.zeros_like(self._kp)
        # the HBM ledger (obs/hbm.py): the weights and the K/V pool sized
        # beside them, unregistered in stop(). The providers return
        # numbers, so an engine never stopped pins no tensor there.
        self.weight_bytes = tree_nbytes(params)
        # the weight plane's description, fixed at construction: health
        # scrapes read it from a handler thread and touch no tensor
        self._weight_dtype = str(params["embed"].dtype).replace("torch.", "")
        self.metrics = metrics
        if metrics:
            metrics.weight_bytes.set(self.weight_bytes)
        self.tracer = tracer or global_tracer()
        self.block_nbytes = 2 * self._kp[:, 0].numel() * \
            self._kp.element_size()
        kv_pool_bytes = num_blocks * self.block_nbytes
        # trailing separator: unregister_prefix("engine@123") must not
        # also match a coexisting "engine@1234..." owner
        self._hbm_owner = f"engine@{id(self)}."
        led = hbm_ledger()
        weight_bytes = self.weight_bytes
        led.register(f"{self._hbm_owner}weights", "weights",
                     lambda: weight_bytes)
        led.register(f"{self._hbm_owner}kv", "kv_pool",
                     lambda: kv_pool_bytes)
        self._layers = layer_slices(params["layers"], cfg.n_layers)
        self._cos, self._sin = (rope_frequencies(
            cfg.head_dim, cfg.max_seq, cfg.rope_theta, device=self.device)
            if cfg.use_rope else (None, None))
        self._gen = torch.Generator(device=self.device)

        # host MIRRORS of the slot state (page allocation, occupancy,
        # tests); the device copy in _dstate is what the step consumes
        self._tables = np.zeros((max_batch, self.blocks_per_seq), np.int64)
        self._seq_lens = np.zeros((max_batch,), np.int64)
        self._last_tokens = np.zeros((max_batch,), np.int64)
        self._active = np.zeros((max_batch,), bool)
        self._slots: List[Optional[GenRequest]] = [None] * max_batch
        self._dstate = self._fresh_dstate()
        # the fused step's chunk: tokens [C], then slot, start and n_valid
        self._chunk_in = torch.zeros(self.prefill_chunk + 3,
                                     dtype=torch.int64, device=self.device)
        # per shape (fused or not): the captured graph and its output
        self._graphs: Dict[bool, "torch.cuda.CUDAGraph"] = {}
        self._graph_out: Dict[bool, torch.Tensor] = {}
        self._graph_stream = None

        # the admission seam: a deque, or any deque-shaped queue
        # (append/appendleft/popleft/len/[0]) such as the door's QoS
        # FairAdmissionQueue
        self._pending = admission_queue if admission_queue is not None \
            else deque()                        # guarded-by: _cond
        self._admit_counter = itertools.count()
        self._cond = threading.Condition()
        self._sched_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.steps = 0
        self.tokens_generated = 0
        self.occupancy_log: List[int] = []      # active slots per step
        self._row_counts = {"decode": set(), "fused": set()}
        self._chunk_fill = 0                    # chunk rows used last step
        # prefix-cache lifetime stats
        self.prefix_hit_blocks = 0
        self.prefix_tokens_seen = 0
        self.prefix_tokens_matched = 0
        self.prefix_evictions = 0
        self.prefix_inserted_blocks = 0

    def attach_longctx(self, plane) -> None:
        _refuse("the long-context plane")

    @property
    def decode_compiles(self) -> int:
        """Distinct row counts of decode-only steps (1 when shapes hold)."""
        return len(self._row_counts["decode"])

    @property
    def prefill_compiles(self) -> int:
        """Distinct row counts of fused steps (1 when shapes hold)."""
        return len(self._row_counts["fused"])

    # ----------------------------------------------------------- the step

    def _mlp(self, x, lp):
        if self.cfg.use_swiglu:
            return swiglu(x @ lp["w_gate"], x @ lp["w_up"]) @ lp["w_down"]
        return gelu(x @ lp["w_in"] + lp["b_in"]) @ lp["w_out"] + lp["b_out"]

    def _rows(self, tokens, positions, active, tables,
              one_context: bool = False) -> torch.Tensor:
        """Float32 logits [t, V] of one group of rows, each "one token at
        one position": K/V scattered into ``table[pos // bs], pos % bs``
        (block 0 for inactive rows), then gathered back through each row's
        table ([t, blocks_per_seq]). Scatter-all-then-gather makes earlier
        rows' K/V visible to later positions of the group; the mask ``kpos
        <= pos`` does the rest. ``one_context``: every row belongs to one
        request, whose table ([1, blocks_per_seq]) is gathered once."""
        cfg = self.cfg
        t = tokens.shape[0]
        pos = torch.clamp(positions, max=self.s_max - 1)
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        rep = hq // hkv
        params = self.params
        h = params["embed"][tokens]
        if not cfg.use_rope:
            h = h + params["pos_embed"][torch.clamp(pos, 0, cfg.max_seq - 1)]
        blk = torch.gather(tables.expand(t, -1), 1,
                           (pos // self.block_size)[:, None])[:, 0]
        blk = torch.where(active, blk, torch.zeros_like(blk))
        off = pos % self.block_size
        scale = 1.0 / (dh ** 0.5)
        visible = torch.arange(self.s_max, device=self.device)[None, :] \
            <= pos[:, None]                                  # [t, S_max]

        for li, lp in enumerate(self._layers):
            kc, vc = self._kp[li], self._vp[li]
            x = _norm(h, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg)
            q = (x @ lp["wq"]).reshape(t, hq, dh)
            k = (x @ lp["wk"]).reshape(t, hkv, dh)
            v = (x @ lp["wv"]).reshape(t, hkv, dh)
            if cfg.use_rope:
                q = _rope_at(q, self._cos, self._sin, pos)
                k = _rope_at(k, self._cos, self._sin, pos)
            kc[blk, off] = k.to(kc.dtype)
            vc[blk, off] = v.to(vc.dtype)
            # paged gather: each row's pages back into a contiguous
            # [S_max] context view through its block table; a one-request
            # group's single view is shared by every row
            kctx = kc[tables].reshape(-1, self.s_max, hkv, dh)
            vctx = vc[tables].reshape(-1, self.s_max, hkv, dh)
            ctx = "tkgd"
            if one_context:
                kctx, vctx, ctx = kctx[0], vctx[0], "kgd"
            logits = torch.einsum(f"tgrd,{ctx}->tgrk",
                                  q.reshape(t, hkv, rep, dh).float(),
                                  kctx.float()) * scale
            logits = logits.masked_fill(~visible[:, None, None, :], _NEG_INF)
            probs = torch.softmax(logits, dim=-1).to(vctx.dtype)
            attn = torch.einsum(f"tgrk,{ctx}->tgrd", probs, vctx)
            h2 = h + (attn.reshape(t, hq * dh) @ lp["wo"]).to(h.dtype)
            x2 = _norm(h2, lp["mlp_norm_w"], lp.get("mlp_norm_b"), cfg)
            h = h2 + self._mlp(x2, lp).to(h.dtype)
        h = _norm(h, params["final_norm_w"], params.get("final_norm_b"), cfg)
        return (h @ head_matrix(params, cfg, h.dtype)).float()

    @torch.no_grad()
    def _step_impl(self, fused: bool) -> torch.Tensor:
        """One step over the decode lanes plus, when ``fused``, one prompt
        chunk, read from ``_chunk_in``. The lanes ([B] rows) and the chunk
        ([C] rows) run as two row groups, each always at its own size, so
        every op a row goes through has the same shape in every step: a
        request's tokens do not depend on what else the batch holds or on
        which step shape carried it (the groups touch disjoint pages: a
        lane writes its own private page, the chunk the prefilling slot's).
        The chunk's rows share one request's context, gathered once.
        Returns the packed readback, flat int64: per lane token | emit
        count | finished | accept length ([B * 4]), then, when fused, the
        chunk's first sampled token. It reads only tensors that live as
        long as the engine and writes the step state in place, so one
        call can be captured as a CUDA graph."""
        st = self._dstate
        logits = self._rows(st["last"], st["positions"], st["active"],
                            st["tables"])
        out = _sample(logits, st["temps"], st["topks"], self._gen)

        # on-device stop-condition scan: budget clamp, stop_token, lane
        # retirement — the host reads the verdict, it does not compute it
        outc, maxn, stopt = st["outc"], st["maxn"], st["stopt"]
        act = st["active"]
        n_emit = torch.clamp(maxn - outc, 0, 1)
        n_emit = torch.where(act, n_emit, torch.zeros_like(n_emit))
        stop_hit = (stopt >= 0) & (out == stopt) & (n_emit > 0)
        finished = act & ((outc + n_emit >= maxn) | stop_hit)
        last = torch.where(act, out, st["last"])
        still = act & ~finished
        packed = torch.stack([out, n_emit, finished.long(),
                              torch.zeros_like(out)], dim=1).flatten()
        st["last"].copy_(last)
        st["positions"].add_(n_emit)
        st["outc"].add_(n_emit)
        st["active"].copy_(still)
        if fused:
            C = self.prefill_chunk
            c_tok, c_slot = self._chunk_in[:C], self._chunk_in[C:C + 1]
            c_start, c_n = self._chunk_in[C + 1:C + 2], self._chunk_in[C + 2:]
            cj = torch.arange(C, device=self.device)
            c_logits = self._rows(c_tok, c_start + cj, cj < c_n,
                                  st["tables"].index_select(0, c_slot),
                                  one_context=True)
            c_out = _sample(c_logits,
                            st["temps"].index_select(0, c_slot).expand(C),
                            st["topks"].index_select(0, c_slot).expand(C),
                            self._gen)
            # the chunk's last valid row sits at the context's last
            # position: its sample is the request's first token
            packed = torch.cat([packed, c_out.index_select(0, c_n - 1)])
        return packed

    def _step_eager(self, fused: bool) -> torch.Tensor:
        """The step run op by op, on any device: what a replay of its
        graph computes. The sampler's generator is seeded with the step
        count, the counterpart of the JAX engine's per-step seed."""
        self._gen.manual_seed(self.steps)
        return self._step_impl(fused)

    def _launch_step(self, fused: bool) -> torch.Tensor:
        """The step of this shape: on a CUDA device a replay of its graph
        (captured at the shape's first step), else eager."""
        if self.device.type != "cuda":
            return self._step_eager(fused)
        with torch.cuda.device(self.device):
            graph = self._graphs.get(fused)
            if graph is None:
                return self._capture(fused)
            self._gen.manual_seed(self.steps)
            graph.replay()
            return self._graph_out[fused]

    def _capture(self, fused: bool) -> torch.Tensor:
        """Run this shape's step for real, eagerly, on the capture stream
        (the warm-up: cuBLAS and the allocator settle there), then capture
        the same step as a CUDA graph, which records and does not run.
        Returns the eager step's output; a failed capture raises."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        side, main = self._graph_stream, torch.cuda.current_stream(
            self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._step_eager(fused)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        # thread_local: other threads (the caller's, a door's) may use the
        # device while the scheduler thread captures
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode="thread_local"):
            static_out = self._step_impl(fused)
        self._graphs[fused] = graph
        self._graph_out[fused] = static_out
        return out

    # -------------------------------------------------------- public face

    def submit(self, prompt: List[int],
               sampling: Optional[SamplingParams] = None,
               trace_ctx=None, tenant: str = "") -> GenRequest:
        sampling = sampling or SamplingParams()
        if not prompt:
            raise ValueError("empty prompt")
        if sampling.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill "
                             "always emits the first token)")
        if len(prompt) + sampling.max_new_tokens > self.s_max:
            raise ValueError(
                f"prompt({len(prompt)}) + max_new({sampling.max_new_tokens})"
                f" exceeds engine max_context {self.s_max}")
        # fail fast on requests the pool can NEVER satisfy — parking
        # them in the admission queue would wedge the queue forever
        pages = -(-(len(prompt) + sampling.max_new_tokens)
                  // self.block_size)
        if pages > self.pool.num_usable:
            raise ValueError(
                f"request needs {pages} KV pages but the pool holds only "
                f"{self.pool.num_usable} — it could never run alone")
        req = GenRequest(prompt=list(prompt), sampling=sampling,
                         trace_ctx=trace_ctx or current_context(),
                         tenant=tenant)
        with self._cond:
            self._pending.append(req)
            depth = len(self._pending)
            self._cond.notify_all()
        if self.metrics:
            self.metrics.requests.incr()
            self.metrics.queue_depth.set(depth)
        return req

    @property
    def num_active(self) -> int:
        return int(self._active.sum())

    @property
    def num_prefilling(self) -> int:
        return sum(1 for r in list(self._slots)
                   if r is not None and r._prefill_pos is not None)

    @property
    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    @property
    def prefill_backlog(self) -> int:
        """Prompt tokens still awaiting prefill across admitted requests.
        Read lock-free from the health thread: each slot's fields are
        read once, so a prefill completing mid-scan reads as 0."""
        total = 0
        for r in list(self._slots):
            if r is None:
                continue
            pos = r._prefill_pos
            if pos is not None:
                total += max(0, len(r._ctx) - pos)
        return total

    def longctx_stats(self) -> Dict[str, Any]:
        """The long-context plane's face: the port attaches none
        (ROADMAP Queue A 7)."""
        return {"enabled": False}

    def weight_plane(self) -> Dict[str, Any]:
        """The resident-weight policy and the capacity it bought, with the
        reference's keys: the bitwise tier (the checkpoint's own dtype;
        the int8 plane is ROADMAP Queue A 4) and no experts."""
        return {
            "parity": "bitwise",
            "dtype": self._weight_dtype,
            "weight_bytes": self.weight_bytes,
            "quantize_seconds": 0.0,
            "quantized_leaves": 0,
            "hbm_bytes": 0,
            "lanes": self.max_batch,
            "max_context": self.s_max,
            "kv_capacity_tokens": self.pool.num_usable * self.block_size,
            "lanes_x_context": self.max_batch * self.s_max,
            "experts": 0,
            "expert_shards": 0,
            "expert_bytes": 0,
        }

    def prefill_to_store(self, prompt: List[int],
                         timeout: float = 60.0) -> int:
        """The prefill half of prefill/decode disaggregation needs the DFS
        KV tier (ROADMAP Queue A 3); like a reference replica without one,
        this raises ``ValueError``."""
        raise ValueError("DFS KV tier disabled (set serving.kv.dfs.enable "
                         "for prefill-role replicas; the PyTorch engine "
                         "has no DFS tier yet, ROADMAP Queue A 3)")

    @property
    def idle(self) -> bool:
        """Nothing queued and nothing running."""
        with self._cond:
            has_pending = bool(self._pending)
        return not has_pending and all(r is None for r in self._slots)

    def cache_stats(self) -> Dict[str, Any]:
        """Prefix-cache + chunked-prefill counters."""
        seen = self.prefix_tokens_seen
        return {
            "enabled": self.prefix_cache is not None,
            "cached_blocks": len(self.prefix_cache)
                             if self.prefix_cache is not None else 0,
            "tokens_seen": seen,
            "tokens_matched": self.prefix_tokens_matched,
            "hit_rate": (self.prefix_tokens_matched / seen) if seen
                        else 0.0,
            "evictions": self.prefix_evictions,
            "inserted_blocks": self.prefix_inserted_blocks,
            "prefill_chunk": self.prefill_chunk,
            # the reference's per-tier and speculation keys: HBM only,
            # no speculation (ROADMAP Queue A 3)
            "tiers": {"host_enabled": False, "dfs_enabled": False,
                      "codec": "raw", "hits_hbm": self.prefix_hit_blocks,
                      "hits_host": 0, "hits_dfs": 0, "demotions": 0,
                      "promotions": 0, "host_resident": 0,
                      "host_capacity_blocks": 0, "dfs_persists": 0,
                      "dfs_persist_failures": 0, "chain_ingested": 0,
                      "fetch_window": 4},
            "speculate": {"k": 0, "proposed": 0, "accepted": 0,
                          "accept_rate": 0.0},
        }

    # ------------------------------------------------------ the scheduler

    def step(self) -> int:
        """One scheduler iteration: admit waiting requests into free
        slots (mapping any cached prefix), ensure every decoding request
        has a page for this step's token, run the fused step, retire
        finished requests. Returns the number of tokens emitted."""
        with self._sched_lock:
            self._admit()
            self._ensure_blocks()
            emitted = self._run_step()
            self._publish_metrics()
            return emitted

    def _admit(self) -> None:
        while True:
            with self._cond:
                if not self._pending:
                    return
                req = self._pending[0]
            slot = next((i for i, r in enumerate(self._slots)
                         if r is None), None)
            if slot is None:
                return
            # prompt plus already-generated tokens (preempted requests
            # resume by recompute); the first decode step after prefill
            # needs one more page slot for its token
            ctx = req.prompt + req.out_tokens
            shared: List[int] = []
            if self.prefix_cache is not None:
                # cap the match below the full context: the last token
                # must always be prefilled so its logits exist to
                # sample the first output token from
                limit = (len(ctx) - 1) // self.block_size
                shared = self.prefix_cache.match(ctx)[:limit]
                if shared:
                    # pin before any eviction this admission might do
                    self.pool.incref(shared)
            need = -(-(len(ctx) + 1) // self.block_size) - len(shared)
            private = self._try_alloc(need)
            if private is None:
                # running requests outrank waiting ones: wait for
                # retirements to return pages
                if shared:
                    self.pool.decref(shared)
                return
            with self._cond:
                self._pending.popleft()
            reused = len(shared) * self.block_size
            req.prefix_tokens_reused = reused
            if req.preemptions == 0:
                # hit-rate counts cross-request reuse only
                self.prefix_tokens_seen += len(ctx)
                self.prefix_tokens_matched += reused
                self.prefix_hit_blocks += len(shared)
                if self.metrics and reused:
                    self.metrics.prefix_tokens_reused.incr(reused)
                if self.metrics and shared:
                    self.metrics.kv_hits_hbm.incr(len(shared))
            self._place(req, slot, shared + private, ctx, len(shared))

    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting LRU zero-ref cached blocks to
        make room before giving up (cold cache yields to live work)."""
        if n <= 0:
            return []
        got = self.pool.alloc(n)
        if got is not None or self.prefix_cache is None:
            return got
        evicted = self.prefix_cache.evict(n - self.pool.num_free,
                                          self.pool.refcount)
        if not evicted:
            return None
        self.pool.free(evicted)
        self.prefix_evictions += len(evicted)
        if self.metrics:
            self.metrics.prefix_cache_evictions.incr(len(evicted))
        return self.pool.alloc(n)

    def _place(self, req: GenRequest, slot: int, blocks: List[int],
               ctx: List[int], shared_blocks: int) -> None:
        req.state = RUNNING
        req._slot = slot
        req._blocks = blocks
        req._ctx = ctx
        req._prefill_pos = shared_blocks * self.block_size
        req._admit_seq = next(self._admit_counter)
        self._slots[slot] = req
        row = np.zeros((self.blocks_per_seq,), np.int64)
        row[:len(blocks)] = blocks
        self._tables[slot] = row
        self._seq_lens[slot] = 0
        self._active[slot] = False
        self._last_tokens[slot] = 0
        self._push_slot(slot, req)
        sp = self.tracer.span("serving.admit", parent=req.trace_ctx)
        sp.add_kv("request", str(req.id))
        sp.add_kv("prompt_tokens", str(len(ctx)))
        sp.add_kv("prefix_tokens_reused", str(req.prefix_tokens_reused))
        sp.finish()

    def _ensure_blocks(self) -> None:
        """Every decoding slot must own the page its next token lands
        in; allocate at block boundaries (evicting cold cache first),
        preempting the youngest request when everything is dry."""
        for slot, req in enumerate(self._slots):
            if req is None or req._prefill_pos is not None:
                continue     # prefilling slots pre-allocated at admit
            need = int(self._seq_lens[slot]) // self.block_size + 1
            while req._slot is not None and len(req._blocks) < need:
                got = self._try_alloc(1)
                if got is not None:
                    self._append_block(slot, req, got[0])
                    continue
                # pool and cache dry: evict the youngest running
                # request — which may be this one (then its slot
                # empties and the loop ends; it resumes by recompute)
                victim = max((r for r in self._slots if r is not None),
                             key=lambda r: r._admit_seq)
                self._preempt(victim)

    def _append_block(self, slot: int, req: GenRequest,
                      block: int) -> None:
        """One new page for a decoding slot: host mirror + the device
        table entry (a page-growth event, once per block_size tokens)."""
        idx = len(req._blocks)
        self._tables[slot][idx] = block
        req._blocks.append(block)
        self._dstate["tables"][slot, idx] = block

    def _preempt(self, victim: GenRequest) -> None:
        """Recompute preemption: drop the request's page refs and
        requeue it at the front; re-admission prefills prompt + tokens
        generated so far (warm when its prompt blocks survive)."""
        self._release_slot(victim)
        victim.state = QUEUED
        victim.preemptions += 1
        with self._cond:
            self._pending.appendleft(victim)
        if self.metrics:
            self.metrics.preemptions.incr()
        psp = self.tracer.span("serving.preempt", parent=victim.trace_ctx)
        psp.add_kv("request", str(victim.id))
        psp.finish()

    def _reset_device_state(self) -> None:
        """Zero the K/V pools and clear every lane of the step state, in
        place: the captured graphs go on reading the same tensors."""
        self._kp.zero_()
        self._vp.zero_()
        for name, value in self._fresh_dstate().items():
            self._dstate[name].copy_(value)

    def _fresh_dstate(self) -> dict:
        """Zeroed device-resident step state, every lane cleared."""
        mb, dev = self.max_batch, self.device

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "tables": zeros(mb, self.blocks_per_seq),
            "positions": zeros(mb),
            "last": zeros(mb),
            "active": zeros(mb, dtype=torch.bool),
            "temps": zeros(mb, dtype=torch.float32),
            "topks": zeros(mb),
            "outc": zeros(mb),
            "maxn": zeros(mb),
            "stopt": torch.full((mb,), -1, dtype=torch.int64, device=dev),
        }

    def _push_slot(self, slot: int, req: Optional[GenRequest]) -> None:
        """Write one slot's whole lane state to the device copy
        (``req=None`` clears the lane)."""
        st = self._dstate
        if req is None:
            vals = dict(positions=0, last=0, active=False, temps=0.0,
                        topks=0, outc=0, maxn=0, stopt=-1)
        else:
            sp = req.sampling
            vals = dict(positions=int(self._seq_lens[slot]),
                        last=int(self._last_tokens[slot]),
                        active=bool(self._active[slot]),
                        temps=float(sp.temperature), topks=int(sp.top_k),
                        outc=len(req.out_tokens), maxn=sp.max_new_tokens,
                        stopt=-1 if sp.stop_token is None
                        else int(sp.stop_token))
        st["tables"][slot] = torch.from_numpy(self._tables[slot]).to(
            self.device)
        for name, value in vals.items():
            st[name][slot] = value

    def _finish_request(self, req: GenRequest, state: str = FINISHED,
                        error: str = None) -> None:
        """Complete a request and wake anyone waiting on the scheduler
        condition (``stop(drain=True)`` parks there)."""
        req._finish(state, error)
        with self._cond:
            self._cond.notify_all()

    def _release_slot(self, req: GenRequest) -> None:
        slot = req._slot
        if slot is None:
            return
        released = self.pool.decref(req._blocks)
        if self.prefix_cache is not None:
            # zero-ref pages registered in the radix index stay
            # resident as reusable cache; the rest return to the pool
            drop = [b for b in released
                    if not self.prefix_cache.contains_block(b)]
        else:
            drop = released
        self.pool.free(drop)
        req._blocks = []
        req._ctx = []
        req._prefill_pos = None
        req._slot = None
        self._slots[slot] = None
        self._active[slot] = False
        self._seq_lens[slot] = 0
        self._tables[slot] = 0
        self._last_tokens[slot] = 0
        self._push_slot(slot, None)    # release event: clear the lane

    def _run_step(self) -> int:
        # oldest still-prefilling request gets this step's chunk budget
        pre: Optional[GenRequest] = None
        for r in self._slots:
            if r is not None and r._prefill_pos is not None:
                if pre is None or r._admit_seq < pre._admit_seq:
                    pre = r
        if pre is None and not self._active.any():
            return 0
        n_valid = 0
        fused = pre is not None
        B = self.max_batch
        t0 = time.monotonic()
        if fused:
            c = self.prefill_chunk
            start = pre._prefill_pos
            n_valid = min(c, len(pre._ctx) - start)
            chunk = np.zeros((c + 3,), np.int64)
            chunk[:n_valid] = pre._ctx[start:start + n_valid]
            chunk[c:] = (pre._slot, start, n_valid)
            self._chunk_in.copy_(torch.from_numpy(chunk))
        self._row_counts["fused" if fused else "decode"].add(
            B + self.prefill_chunk if fused else B)
        # the ONE device→host read of the step
        flat = self._launch_step(fused).cpu().numpy()
        packed = flat[:B * 4].reshape(B, 4)
        self.steps += 1
        self._chunk_fill = n_valid
        emitted = 0
        self.occupancy_log.append(self.num_active)
        if len(self.occupancy_log) > 100_000:
            del self.occupancy_log[:50_000]
        step_exemplar = None   # any sampled request names this step
        for slot, req in enumerate(self._slots):
            if req is None or not self._active[slot]:
                continue
            if step_exemplar is None and req.trace_ctx is not None \
                    and req.trace_ctx.sampled:
                step_exemplar = req.trace_ctx.trace_id
            n = int(packed[slot, 1])
            if n <= 0:
                continue
            toks = packed[slot, :n]
            # mirrors advance with the device state
            self._seq_lens[slot] += n
            self._last_tokens[slot] = int(toks[-1])
            emitted += self._deliver_burst(req, toks)
            if packed[slot, 2] or self._exhausted(req):
                self._release_slot(req)
                self._finish_request(req, FINISHED)
        if pre is not None:
            pre._prefill_pos += n_valid
            if pre._prefill_pos >= len(pre._ctx):
                # the chunk's last valid row sat at the final context
                # position — its sample is the first output token
                self._finish_prefill(pre, int(flat[B * 4]))
                emitted += 1
        self.tokens_generated += emitted
        if self.metrics:
            self.metrics.tokens_out.incr(emitted)
            step_s = time.monotonic() - t0
            self.metrics.decode_step.add(step_s)
            self.metrics.decode_step_hist.add(
                step_s, exemplar_trace=step_exemplar)
        return emitted

    def _deliver_burst(self, req: GenRequest, toks) -> int:
        """Deliver a step's tokens in order, never past
        ``max_new_tokens`` and nothing past a ``stop_token`` hit."""
        sp = req.sampling
        n = 0
        for t in toks:
            if len(req.out_tokens) >= sp.max_new_tokens:
                break
            tok = int(t)
            req._deliver(tok)
            n += 1
            if sp.stop_token is not None and tok == sp.stop_token:
                break
        return n

    @staticmethod
    def _exhausted(req: GenRequest) -> bool:
        sp = req.sampling
        return len(req.out_tokens) >= sp.max_new_tokens or \
            (sp.stop_token is not None and req.out_tokens and
             req.out_tokens[-1] == sp.stop_token)

    def _finish_prefill(self, req: GenRequest, tok: int) -> None:
        """Prompt fully cached: flip the slot to a decode lane, publish
        the fully-filled prompt blocks into the prefix index, deliver
        the first token, and arm the device lane."""
        slot = req._slot
        ctx_len = len(req._ctx)
        req._prefill_pos = None
        self._seq_lens[slot] = ctx_len
        self._last_tokens[slot] = tok
        self._active[slot] = True
        if self.prefix_cache is not None:
            full = ctx_len // self.block_size
            if full:
                self.prefix_inserted_blocks += self.prefix_cache.insert(
                    req._ctx[:full * self.block_size], req._blocks[:full])
        first = req.first_token_at is None
        req._deliver(tok)
        if first:
            ttft = req.first_token_at - req.submitted_at
            if self.metrics:
                self.metrics.ttft.add(ttft)
                # a slow TTFT bucket's exemplar is this request's trace
                self.metrics.ttft_hist.add(
                    ttft, exemplar_trace=req.trace_ctx.trace_id
                    if req.trace_ctx is not None and req.trace_ctx.sampled
                    else None)
            fsp = self.tracer.span("serving.first_token",
                                   parent=req.trace_ctx)
            fsp.add_kv("request", str(req.id))
            fsp.add_kv("ttft_s", f"{ttft:.6f}")
            fsp.finish()
        self._maybe_finish(req, tok)
        if req._slot is not None:
            self._push_slot(slot, req)

    def _maybe_finish(self, req: GenRequest, tok: int) -> None:
        sp = req.sampling
        if len(req.out_tokens) >= sp.max_new_tokens or \
                (sp.stop_token is not None and tok == sp.stop_token):
            self._release_slot(req)
            self._finish_request(req, FINISHED)

    def _publish_metrics(self) -> None:
        """Per-step gauges, from the host mirrors."""
        if not self.metrics:
            return
        m = self.metrics
        with self._cond:
            depth = len(self._pending)
        m.queue_depth.set(depth)
        m.batch_occupancy.set(self.num_active)
        used = self.pool.num_usable - self.pool.num_free
        m.kv_blocks_in_use.set(used)
        m.kv_block_utilization.set(used / max(1, self.pool.num_usable))
        stats = self.cache_stats()
        m.prefix_cache_hit_rate.set(round(stats["hit_rate"], 4))
        m.prefix_cached_blocks.set(stats["cached_blocks"])
        m.chunk_occupancy.set(self._chunk_fill / self.prefill_chunk)
        m.prefill_backlog.set(self.prefill_backlog)

    # --------------------------------------------------- replica lifecycle

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run_loop,
                                        name="decode-engine", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = False, timeout: float = 30.0) -> None:
        """``drain=True``: keep decoding until every queued and running
        request completes, then stop. Requests still in flight after
        that fail with "engine stopped"."""
        if drain and self._thread is not None:
            deadline = time.monotonic() + timeout
            with self._cond:
                while not self.idle:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        # a stopped engine's pool must not haunt the HBM ledger
        hbm_ledger().unregister_prefix(self._hbm_owner)
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None
        # only touch slot/pool state under the scheduler lock — a step
        # still running past the join timeout must not race a
        # double-free of its KV pages
        locked = self._sched_lock.acquire(timeout=5.0)
        try:
            for req in [r for r in self._slots if r]:
                if not req.done.is_set():
                    if locked:
                        self._release_slot(req)
                    self._finish_request(req, FAILED, "engine stopped")
            while True:
                with self._cond:
                    if not self._pending:
                        break
                    req = self._pending.popleft()
                if not req.done.is_set():
                    self._finish_request(req, FAILED, "engine stopped")
        finally:
            if locked:
                self._sched_lock.release()

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                while self.idle and not self._stop.is_set():
                    self._cond.wait(0.05)
            if self._stop.is_set():
                return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — fail requests, not
                # the thread: a poisoned request must not wedge the
                # replica with clients blocked on .done forever
                log.exception("decode step failed")
                with self._sched_lock:
                    # the failed step may have left the pools and lane
                    # state half written: rebuild them before the
                    # release path writes lane-clear events
                    self._reset_device_state()
                    for req in [r for r in self._slots if r]:
                        self._release_slot(req)
                        self._finish_request(req, FAILED,
                                             f"decode failed: {e}")
                    # the radix indexed pages that died with the pools
                    if self.prefix_cache is not None:
                        self.pool.free(self.prefix_cache.evict(
                            len(self.prefix_cache), self.pool.refcount))
                    while True:
                        with self._cond:
                            if not self._pending:
                                break
                            req = self._pending.popleft()
                        self._finish_request(req, FAILED,
                                             f"decode failed: {e}")

    # ------------------------------------------------------------- offline

    def generate(self, prompts: List[List[int]],
                 sampling: Optional[SamplingParams] = None,
                 ) -> List[List[int]]:
        """Offline batch API: submit everything, step until done."""
        reqs = [self.submit(p, sampling) for p in prompts]
        while not all(r.done.is_set() for r in reqs):
            self.step()
        return [r.wait(0) for r in reqs]
