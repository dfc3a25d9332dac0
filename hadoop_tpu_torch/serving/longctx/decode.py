"""Working-set decode over a tier-resident context.

The counterpart of ``hadoop_tpu/serving/longctx/decode.py``. The
engine's fused step gathers each lane's whole context out of the block
pool, which a long-context request cannot have. This decoder keeps the
context where the CP prefill streamed it (the host ring / DFS tiers,
chain-digest keyed) and pages it through a fixed-shape device window:
per generated token, per layer, the query merges online-softmax partials
(``ops.attention.chunk_attention`` + ``merge_attention``, the ring's
math run across time) over

- a device-resident TAIL buffer holding the prompt's partial last block
  plus every generated token's K/V, written in as they are computed, and
- a sliding WINDOW of ``serving.longctx.decode.window.blocks`` full
  blocks paged in from the host-resident chain.

So the device holds window + tail, a working set, while the context
lives a tier down. The chain is assembled once per request with
``TieredKVCache.read_chain`` (host probe, then the DFS tier in
``serving.kv.fetch.window``-sized windows).

Two decode loops share that contract:

- the PIPELINED path (``serving.longctx.decode.pipeline``, the default):
  the per-token op chain in four fixed-shape pieces (``fstart``,
  ``fadvance``, ``fwin``, ``ffinish``/``fhead``). The transfer unit is a
  SLAB of ``serving.longctx.decode.fetch.windows`` consecutive windows of
  one layer, packed into one page-locked host tensor per request. On a
  CUDA device each slab is copied on a side stream (``non_blocking``
  from page-locked memory, so the copy is asynchronous) into one of two
  device buffers, and the compute stream waits on that copy's event
  before its ``fwin``: the next slab is in flight while the current one
  computes, and a buffer is written again only after an event the
  compute stream records behind the ``fwin`` that read it. ``fwin``
  takes a slab's windows as one masked partial (the reference scans them
  one window at a time; the sum is the same, its rounding is not). The
  pieces read and write only one request state (``_state``: the tail,
  the slab buffers, the running h, q, o, lse and logits, the position
  scalars), so on a CUDA device each is one CUDA graph, captured at its
  first call after an eager warm-up (``fadvance`` once per layer, whose
  weights it bakes in; ``fwin`` once per slab buffer and slab index):
  a token is some 165 launch calls instead of some 10,000 kernel
  launches. With the default slab depth (= ``n_layers``) host-to-device
  traffic per token is O(chain / window) slab transfers, and dispatches
  per token are ``n_layers * n_slabs + n_layers + 1``. The kernels'
  launch counters (``norms``, ``weightplane``) count the warm-up and the
  capture, not the replays. Sampling runs on the device by default
  (``serving.longctx.decode.sampler=device``: the engine's
  ``_mask_and_scale`` and a Gumbel-max draw from a ``torch.Generator``
  seeded with the request's seed and the position; one int64 comes back
  per token), the host sampler (``_host_sample``) as the fallback. An
  int8 weight-plane tree serves directly: the pieces run its matmuls
  through ``qdot`` on each layer's ``{"q", "s"}`` slices, a quantized
  embedding through ``qrows`` and a quantized head through ``qhead``.
- the LEGACY path (``pipeline=false``): the per-(layer, window) loop,
  each window a pageable host slice copied to the device and merged on
  its own: the reference's arithmetic order, and the A-B reference for
  the pipelined path.

The reference jits each piece once per layout family. ``trace_counts()``
keeps the reference's name and counts, per piece and family, the
distinct input shapes the piece ran at: 1 when the fixed shapes hold,
the compile-once contract's counterpart. ``dispatch_counts()`` counts
the pieces' calls.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import _norm, head_matrix, layer_slices
from hadoop_tpu_torch.ops import apply_rope, gelu, rope_frequencies, swiglu
from hadoop_tpu_torch.ops.attention import (_repeat_kv, chunk_attention,
                                            merge_attention)
from hadoop_tpu_torch.serving.engine import (_from_host, _gumbel_argmax,
                                             _mask_and_scale)
from hadoop_tpu_torch.serving.weightplane import (is_qtensor,
                                                  is_quantized_tree, qdot,
                                                  qhead, qrows)

_NEG_INF = -1e30
_FAR = 1 << 30     # a kv position no query position ever reaches
_REQUESTED = "requested_bytes.all.current"      # torch.cuda.memory_stats

_SHAPES: Dict[str, set] = {}                # guarded-by: _LOCK
_DISPATCHES: Dict[str, int] = {}            # guarded-by: _LOCK
_LOCK = threading.Lock()


def trace_counts() -> Dict[str, int]:
    """Per decode piece (``name@family``): the distinct input shapes it
    ran at, the counterpart of the reference's traces (1 per family when
    the fixed shapes hold)."""
    with _LOCK:
        return {name: len(keys) for name, keys in _SHAPES.items()}


def dispatch_counts() -> Dict[str, int]:
    """Calls per decode piece (name → count), the number the
    per-token dispatch budget is audited against."""
    with _LOCK:
        return dict(_DISPATCHES)


def _count(name: str, *args) -> None:
    """Note the input shapes piece ``name`` runs at."""
    key = tuple((tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor)
                else type(a).__name__ for a in args)
    with _LOCK:
        _SHAPES.setdefault(name, set()).add(key)


def _family(cfg: ModelConfig, *parts) -> str:
    """The family name of a piece set: everything its shapes depend on
    (the full config by its hash, as the reference keys its counters)."""
    return ":".join([cfg.family, *map(str, parts),
                     f"{hash(cfg) & 0xffffff:x}"])


def _host_sample(logits: np.ndarray, temperature: float, top_k: int,
                 rng: np.random.Generator) -> int:
    """The engine's mask-then-scale sampling transform, host-side:
    greedy when temperature <= 0; top-k keeps values >= the k-th largest
    (ties included, matching ``engine._mask_and_scale``)."""
    if temperature <= 0:
        return int(np.argmax(logits))
    lg = np.asarray(logits, np.float64).copy()
    if top_k > 0:
        kth = np.sort(lg)[max(0, lg.size - top_k)]
        lg[lg < kth] = _NEG_INF
    lg = lg / max(temperature, 1e-6)
    lg -= lg.max()
    p = np.exp(lg)
    p /= p.sum()
    return int(rng.choice(lg.size, p=p))


def _host_tensor(a, dtype: torch.dtype) -> torch.Tensor:
    """A tier payload (numpy in the storage dtype, bf16 as uint16 bits)
    or a host tensor, as a host tensor of ``dtype``."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype)
    return _from_host(a, dtype)


class WorkingSetDecoder:
    """Decode one long-context request with device memory bounded by
    window + tail, the context streamed from the cold tiers."""

    def __init__(self, params, cfg: ModelConfig, store, *,
                 block_size: int, window_blocks: int = 4,
                 tail_tokens: int = 128, pipeline: bool = True,
                 sampler: str = "device", fetch_windows: int = 0,
                 metrics=None):
        if sampler not in ("device", "host"):
            raise ValueError(
                f"serving.longctx.decode.sampler must be 'device' or "
                f"'host', got {sampler!r}")
        quantized = is_quantized_tree(params)
        if quantized and not pipeline:
            raise ValueError(
                "int8-resident longctx weights need the pipelined "
                "decode path (serving.longctx.decode.pipeline=true): "
                "the legacy loop serves the checkpoint-dtype view only")
        if cfg.is_moe:
            raise NotImplementedError("longctx serves dense decoders "
                                      "only (same as the engine)")
        self.params = params
        self.cfg = cfg
        self.store = store
        self.block_size = int(block_size)
        self.win = int(window_blocks) * self.block_size
        self.tail_cap = int(tail_tokens)
        self.pipeline = bool(pipeline)
        self.sampler = sampler
        self.relaxed_qweights = quantized
        # slab depth: windows shipped per transfer. The auto default (=
        # n_layers) makes per-token transfers equal the legacy loop's
        # per-LAYER window count, and the two in-flight slabs together
        # cost exactly 2 windows of per-token working-set bytes
        self.fetch_windows = int(fetch_windows) or cfg.n_layers
        if self.fetch_windows < 1:
            raise ValueError("serving.longctx.decode.fetch.windows "
                             "must be >= 1")
        embed = params["embed"]
        self.device = (embed["q"] if is_qtensor(embed) else embed).device
        self._layers = layer_slices(params["layers"], cfg.n_layers)
        self._cos, self._sin = rope_frequencies(
            cfg.head_dim, cfg.max_seq, cfg.rope_theta, device=self.device)
        tier = "q8" if quantized else "f32"
        self.family = (_family(cfg, self.win, self.tail_cap,
                               f"s{self.fetch_windows}", tier)
                       if self.pipeline
                       else _family(cfg, self.win, self.tail_cap))
        self._gen = torch.Generator(device=self.device)
        # the slab copies' side stream, and per slab buffer the event
        # behind the last fwin that read it (a CUDA device only)
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._freed = [None, None]
        # the pipelined path's request state (``_state``) and, on a CUDA
        # device, the pieces' graphs (``_run``)
        self._st = None
        self._graphs: Dict[tuple, "torch.cuda.CUDAGraph"] = {}
        self._graph_stream = None
        self._graph_pool = None
        self.metrics = metrics
        self.window_fetches = 0     # host->device window transfers
        self.tokens_decoded = 0
        self.dispatches = 0         # piece calls on the decode hot path
        self.last_alloc_bytes = 0   # bytes the working set requested
        # the last request's host-clock seconds: read_chain, the slab
        # packing, the token loop (pipelined path)
        self.last_timing: Dict[str, float] = {}

    # ------------------------------------------------------- accounting

    @property
    def _per_tok_bytes(self) -> int:
        item = self.cfg.torch_dtype.itemsize
        return 2 * self.cfg.n_layers * self.cfg.n_kv_heads * \
            self.cfg.head_dim * item

    @property
    def slab_bytes(self) -> int:
        """One transferred slab: ``fetch_windows`` windows of ONE layer's
        K+V."""
        return self.fetch_windows * self.win * \
            (self._per_tok_bytes // self.cfg.n_layers)

    @property
    def hbm_window_bytes(self) -> int:
        """Device bytes the window paging keeps in flight: both slabs of
        the double buffer when pipelining, one window's worth on the
        legacy loop."""
        if self.pipeline:
            return 2 * self.slab_bytes
        return self.win * self._per_tok_bytes

    @property
    def sampler_state_bytes(self) -> int:
        """Device-resident sampler state (device sampling only): the
        sampled int64 token (the generator's seed and offset live on the
        host)."""
        if self.pipeline and self.sampler == "device":
            return 8
        return 0

    @property
    def hbm_working_set_bytes(self) -> int:
        """What this decoder keeps device-resident per request: the
        in-flight window slabs + the tail buffers + sampler state."""
        return self.hbm_window_bytes + \
            self.tail_cap * self._per_tok_bytes + \
            self.sampler_state_bytes

    @property
    def dispatches_per_token(self) -> float:
        return self.dispatches / max(1, self.tokens_decoded)

    def _disp(self, name: str) -> None:
        self.dispatches += 1
        with _LOCK:
            _DISPATCHES[name] = _DISPATCHES.get(name, 0) + 1

    def _note_fetch(self) -> None:
        self.window_fetches += 1
        if self.metrics:
            self.metrics.longctx_window_fetches.incr()

    # ------------------------------------------------------- the pieces
    # Positions, tail slots and token ids are ints on the legacy loop and
    # 1-element long tensors of the pipelined state; ``_t`` takes both.

    def _t(self, x):
        if isinstance(x, torch.Tensor):
            return x
        return torch.full((1,), x, dtype=torch.long, device=self.device)

    def _mm(self, x, w):
        return qdot(x, w) if is_qtensor(w) else x @ w

    def _layer_in(self, l: int, h, pos):
        cfg = self.cfg
        lp = self._layers[l]
        hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        x = _norm(h, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg)
        q = self._mm(x, lp["wq"]).reshape(1, 1, hq, dh)
        k = self._mm(x, lp["wk"]).reshape(1, 1, hkv, dh)
        v = self._mm(x, lp["wv"]).reshape(1, 1, hkv, dh)
        if cfg.use_rope:
            p = self._t(pos)
            q = apply_rope(q, self._cos, self._sin, p)
            k = apply_rope(k, self._cos, self._sin, p)
        return q, k[0, 0], v[0, 0]          # q [1,1,Hq,Dh]; k/v [Hkv,Dh]

    def _layer_out(self, l: int, h, o):
        cfg = self.cfg
        lp = self._layers[l]
        h = h + self._mm(o.to(h.dtype).reshape(1, 1, -1), lp["wo"])
        x = _norm(h, lp["mlp_norm_w"], lp.get("mlp_norm_b"), cfg)
        if cfg.use_swiglu:
            mlp = self._mm(swiglu(self._mm(x, lp["w_gate"]),
                                  self._mm(x, lp["w_up"])), lp["w_down"])
        else:
            mlp = self._mm(gelu(self._mm(x, lp["w_in"]) + lp["b_in"]),
                           lp["w_out"]) + lp["b_out"]
        return h + mlp.to(h.dtype)

    def _partial(self, q, kc, vc, pos, kvpos):
        """q's online-softmax partial against K/V rows ``kc``/``vc``
        [T, Hkv, Dh] at positions ``kvpos`` [T]."""
        nrep = self.cfg.n_heads // self.cfg.n_kv_heads
        return chunk_attention(
            q, _repeat_kv(kc[None], nrep).float(),
            _repeat_kv(vc[None], nrep).float(),
            1.0 / (self.cfg.head_dim ** 0.5), self._t(pos), kvpos)

    def _tail_partial(self, q, ktail, vtail, l: int, pos, base, n_tail):
        j = torch.arange(self.tail_cap, device=self.device)
        kvpos = torch.where(j < n_tail, base + j, _FAR)
        return self._partial(q, ktail[l], vtail[l], pos, kvpos)

    def _embed(self, tok, pos):
        cfg, params = self.cfg, self.params
        emb = params["embed"]
        if is_qtensor(emb):
            h = qrows(emb, self._t(tok), cfg.torch_dtype)[None]
        else:
            h = emb[self._t(tok)][None]
        if not cfg.use_rope:
            h = h + params["pos_embed"][
                torch.clamp(self._t(pos), 0, cfg.max_seq - 1)]
        return h                                        # [1, 1, D]

    def _logits(self, h):
        cfg = self.cfg
        row = _norm(h, self.params["final_norm_w"],
                    self.params.get("final_norm_b"), cfg)[0, 0]
        head = self.params["embed"] if cfg.tie_embeddings \
            else self.params.get("lm_head")
        if is_qtensor(head):
            return qhead(self.params, row, cfg).float()
        return (row @ head_matrix(self.params, cfg, row.dtype)).float()

    # pipelined pieces: each reads and writes only the request state
    # ``st`` (``_state``), so on a CUDA device each is one CUDA graph

    def _write_tail(self, st, l: int, q, k, v):
        """This token's K/V into tail slot ``idx`` of layer ``l``, then
        the tail partial into the state's (q, o, lse)."""
        st["ktail"][l, st["idx"]] = k.to(st["ktail"].dtype)
        st["vtail"][l, st["idx"]] = v.to(st["vtail"].dtype)
        o, lse = self._tail_partial(q, st["ktail"], st["vtail"], l,
                                    st["pos"], st["base"], st["idx"] + 1)
        st["q"].copy_(q)
        st["o"].copy_(o)
        st["lse"].copy_(lse)

    def _fstart(self, st):
        """Embed + layer 0's q/k/v and rope + tail write + tail partial."""
        h = self._embed(st["tok"], st["pos"])
        q, k, v = self._layer_in(0, h, st["pos"])
        st["h"].copy_(h)
        self._write_tail(st, 0, q, k, v)

    def _fadvance(self, st, l: int):
        """Layer l-1's exit (wo, MLP) + layer l's entry + tail write +
        tail partial."""
        h = self._layer_out(l - 1, st["h"], st["o"])
        q, k, v = self._layer_in(l, h, st["pos"])
        st["h"].copy_(h)
        self._write_tail(st, l, q, k, v)

    def _fwin(self, st, slab, slab0: int):
        """Merge one slab ([2, slab_tokens, Hkv, Dh], K then V, its first
        position ``slab0``) into the running (o, lse): one masked partial
        over the slab's windows (positions past the chain are masked; an
        all-masked slab is the merge identity)."""
        j = slab0 + torch.arange(slab.shape[1], device=self.device)
        kvpos = torch.where(j < st["chain"], j, _FAR)
        ow, lw = self._partial(st["q"], slab[0], slab[1], st["pos"], kvpos)
        o, lse = merge_attention(st["o"], st["lse"], ow, lw)
        st["o"].copy_(o)
        st["lse"].copy_(lse)

    def _ffinal(self, st):
        """The last layer's exit, the final norm and the head: float32
        logits [V] into the state."""
        st["logits"].copy_(self._logits(
            self._layer_out(self.cfg.n_layers - 1, st["h"], st["o"])))

    def _run(self, key, name: str, fn, *shapes) -> None:
        """One piece: ``fn()`` on the CPU; on a CUDA device the replay of
        its graph, captured at its first call after an eager run on the
        capture stream (the warm-up, whose results stand)."""
        _count(name, *shapes)
        self._disp(name)
        if self.device.type != "cuda":
            fn()
            return
        graph = self._graphs.get(key)
        if graph is not None:
            graph.replay()
            return
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        side = self._graph_stream
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # the pieces never run at once and share one memory pool: each
        # reads only the state and its slab, never another's temporaries
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=side,
                              capture_error_mode="thread_local"):
            fn()
        self._graphs[key] = graph

    # ------------------------------------------------------------ decode

    def paged_decode(self, tokens: List[int], first_token: int,
                     sampling, *, tail_k=None, tail_v=None,
                     deliver: Callable[[int], None],
                     stop: Optional[Callable[[], bool]] = None,
                     seed: int = 0, rng=None, parent_ctx=None) -> int:
        """Generate up to ``sampling.max_new_tokens - 1`` tokens after
        ``first_token`` (which prefill already delivered), paging the
        prompt's KV chain in windows. Relaxed-tier entry point. Returns
        the tokens emitted here."""
        cfg = self.cfg
        bs = self.block_size
        s = len(tokens)
        n_full = s // bs
        tail_len = s - n_full * bs
        if tail_len + sampling.max_new_tokens > self.tail_cap:
            raise ValueError(
                f"prompt tail ({tail_len}) + max_new "
                f"({sampling.max_new_tokens}) exceeds the longctx tail "
                f"budget {self.tail_cap} "
                f"(serving.longctx.decode.tail.tokens)")
        # the chain pages back from the tiers (host probe, DFS windows),
        # not into the engine's pool: it lands host-resident and visits
        # the device one window (or slab) at a time
        t0 = time.monotonic()
        hits = self.store.read_chain(tokens, n_full, parent_ctx=parent_ctx)
        self.last_timing = {"chain_s": time.monotonic() - t0}
        if len(hits) < n_full:
            raise RuntimeError(
                f"longctx KV chain has a gap: {len(hits)}/{n_full} "
                f"blocks recoverable from the host/DFS tiers (host ring "
                f"too small without the DFS tier?)")
        chain_len = n_full * bs
        if rng is None:
            rng = np.random.default_rng(seed)
        if self.pipeline:
            return self._decode_fused(hits, tokens, first_token, chain_len,
                                      tail_k, tail_v, tail_len, sampling,
                                      seed, rng, deliver, stop)
        # legacy per-(layer, window) loop: one pageable host buffer at the
        # window-padded shape, hits written in place
        padded = chain_len + ((-chain_len) % self.win)
        shape = (cfg.n_layers, padded, cfg.n_kv_heads, cfg.head_dim)
        kh = torch.zeros(shape, dtype=cfg.torch_dtype)
        vh = torch.zeros(shape, dtype=cfg.torch_dtype)
        for i, hit in enumerate(hits):
            kh[:, i * bs:(i + 1) * bs] = _host_tensor(hit.k, cfg.torch_dtype)
            vh[:, i * bs:(i + 1) * bs] = _host_tensor(hit.v, cfg.torch_dtype)
        tshape = (cfg.n_layers, self.tail_cap, cfg.n_kv_heads, cfg.head_dim)
        ktail = torch.zeros(tshape, dtype=cfg.torch_dtype,
                            device=self.device)
        vtail = torch.zeros_like(ktail)
        self._fill_tail(ktail, vtail, tail_k, tail_v, tail_len)
        base, n_tail = chain_len, tail_len
        cur, pos, out_count, emitted = first_token, s, 1, 0
        sp = sampling
        while out_count < sp.max_new_tokens and \
                (sp.stop_token is None or cur != sp.stop_token) and \
                (stop is None or not stop()):
            logits = self._token(cur, pos, kh, vh, chain_len, ktail, vtail,
                                 base, n_tail)
            n_tail += 1
            nxt = _host_sample(logits, sp.temperature, sp.top_k, rng)
            deliver(nxt)
            emitted += 1
            out_count += 1
            cur = nxt
            pos += 1
        self.tokens_decoded += emitted
        return emitted

    def _fill_tail(self, ktail, vtail, tail_k, tail_v, tail_len: int):
        """The prompt's partial block into the tail's first slots."""
        if tail_len:
            ktail[:, :tail_len] = torch.as_tensor(tail_k).to(
                device=self.device, dtype=ktail.dtype)
            vtail[:, :tail_len] = torch.as_tensor(tail_v).to(
                device=self.device, dtype=vtail.dtype)

    def _state(self):
        """The pipelined path's device state, allocated at the first
        request and kept for the decoder's life (its CUDA graphs read
        these addresses): the tail buffers, the two slab buffers and the
        sampled token on a CUDA device (the working set: the bytes they
        request of the allocator are ``last_alloc_bytes``), then the
        running h, q, o, lse and
        logits of one token and its scalars (token, position, tail slot,
        chain base and length)."""
        if self._st is not None:
            return self._st
        cfg, dev = self.cfg, self.device
        cuda = dev.type == "cuda"
        if cuda:
            # requested bytes: the tensors' own sizes, not the cached
            # blocks the allocator hands out for them
            before = torch.cuda.memory_stats(dev)[_REQUESTED]
        tshape = (cfg.n_layers, self.tail_cap, cfg.n_kv_heads, cfg.head_dim)
        st = {"ktail": torch.zeros(tshape, dtype=cfg.torch_dtype,
                                   device=dev)}
        st["vtail"] = torch.zeros_like(st["ktail"])
        st["bufs"] = None
        if cuda:
            # written on the copy stream: the allocator must not hand
            # their memory on before its copies end
            st["bufs"] = [torch.empty(
                (2, self.fetch_windows * self.win, cfg.n_kv_heads,
                 cfg.head_dim), dtype=cfg.torch_dtype, device=dev)
                for _ in range(2)]
            for buf in st["bufs"]:
                buf.record_stream(self._copy_stream)
            if self.sampler == "device":
                st["token"] = torch.zeros((), dtype=torch.long, device=dev)
            self.last_alloc_bytes = \
                torch.cuda.memory_stats(dev)[_REQUESTED] - before
        hq, dh = cfg.n_heads, cfg.head_dim
        st.update(
            h=torch.zeros((1, 1, cfg.d_model), dtype=cfg.torch_dtype,
                          device=dev),
            q=torch.zeros((1, 1, hq, dh), dtype=cfg.torch_dtype, device=dev),
            o=torch.zeros((1, 1, hq, dh), dtype=torch.float32, device=dev),
            lse=torch.zeros((1, 1, hq), dtype=torch.float32, device=dev),
            logits=torch.zeros((cfg.vocab_size,), dtype=torch.float32,
                               device=dev),
            **{name: torch.zeros((1,), dtype=torch.long, device=dev)
               for name in ("tok", "pos", "idx", "base", "chain")})
        self._st = st
        return st

    def _pack_chain(self, hits, chain_len: int):
        """The chain as one host tensor of transfer units, [L, n_slabs, 2,
        slab_tokens, Hkv, Dh] (a block never straddles a slab): page-locked
        on a CUDA device, so each slab's copy is asynchronous."""
        cfg = self.cfg
        bs = self.block_size
        st = self.fetch_windows * self.win
        n_slabs = -(-chain_len // st)
        pin = self.device.type == "cuda"
        kv = torch.zeros((cfg.n_layers, n_slabs, 2, st, cfg.n_kv_heads,
                          cfg.head_dim), dtype=cfg.torch_dtype,
                         pin_memory=pin)
        if pin and not kv.is_pinned():
            raise RuntimeError("the longctx slab buffer is not page-locked: "
                               "its copies would be synchronous")
        for i, hit in enumerate(hits):
            sl, off = divmod(i * bs, st)
            kv[:, sl, 0, off:off + bs] = _host_tensor(hit.k, cfg.torch_dtype)
            kv[:, sl, 1, off:off + bs] = _host_tensor(hit.v, cfg.torch_dtype)
        return kv

    def _decode_fused(self, hits, tokens, cur: int, chain_len: int, tail_k,
                      tail_v, tail_len: int, sp, seed: int, rng, deliver,
                      stop) -> int:
        """The pipelined loop: pack the chain into per-(layer, slab)
        transfer units, then per token run the pieces with the next slab
        always in flight behind the current one."""
        t0 = time.monotonic()
        kvh = self._pack_chain(hits, chain_len)
        self.last_timing["pack_s"] = time.monotonic() - t0
        st = self._state()
        st["ktail"].zero_()
        st["vtail"].zero_()
        self._fill_tail(st["ktail"], st["vtail"], tail_k, tail_v, tail_len)
        st["base"].fill_(chain_len)
        st["chain"].fill_(chain_len)
        n_tail, pos = tail_len, len(tokens)
        out_count, emitted = 1, 0
        t0 = time.monotonic()
        while out_count < sp.max_new_tokens and \
                (sp.stop_token is None or cur != sp.stop_token) and \
                (stop is None or not stop()):
            res = self._token_fused(st, cur, pos, kvh, n_tail, sp, seed)
            if self.sampler == "device":
                nxt = int(res)          # the one readback per token
            else:
                nxt = _host_sample(res.cpu().numpy(), sp.temperature,
                                   sp.top_k, rng)
            n_tail += 1
            deliver(nxt)
            emitted += 1
            out_count += 1
            cur = nxt
            pos += 1
        # each token ends in a readback, so the host clock holds the
        # device's work
        self.last_timing["tokens_s"] = time.monotonic() - t0
        self.last_timing["tokens"] = emitted
        self.tokens_decoded += emitted
        return emitted

    def _token_fused(self, st, tok: int, pos: int, kvh, n_tail: int,
                     sampling, seed: int):
        """One token through the pieces. Per (layer, slab) the NEXT slab's
        copy is issued before the current slab's ``fwin``. Dispatches: 1
        fstart + (L-1) fadvance + L*n_slabs fwin + 1 ffinish/fhead."""
        fam = self.family
        nl = self.cfg.n_layers
        n_slabs, slab_tokens = kvh.shape[1], kvh.shape[3]
        order = [(l, s) for l in range(nl) for s in range(n_slabs)]
        pager = _SlabPager(self, kvh, st["bufs"])
        st["tok"].fill_(tok)
        st["pos"].fill_(pos)
        st["idx"].fill_(n_tail)
        if order:
            pager.issue(0, *order[0])         # under the embed + layer 0
        state = (st["h"], st["o"], st["ktail"])
        self._run(("fstart",), f"fstart@{fam}", lambda: self._fstart(st),
                  *state)
        done = 1
        for i, (l, s) in enumerate(order):
            if s == 0 and l > 0:
                self._run(("fadvance", l), f"fadvance@{fam}",
                          lambda: self._fadvance(st, l), *state)
                done = l + 1
            if i + 1 < len(order):
                pager.issue(i + 1, *order[i + 1])
            slab = pager.take(i)
            self._run(("fwin", i % 2, s), f"fwin@{fam}",
                      lambda: self._fwin(st, slab, s * slab_tokens),
                      st["o"], st["lse"], slab)
            pager.release(i)
        for l in range(done, nl):        # a chain shorter than one block
            self._run(("fadvance", l), f"fadvance@{fam}",
                      lambda: self._fadvance(st, l), *state)
        if self.sampler == "host":
            self._run(("final",), f"fhead@{fam}", lambda: self._ffinal(st),
                      *state)
            return st["logits"]
        self._run(("final",), f"ffinish@{fam}", lambda: self._ffinal(st),
                  *state)
        # the engine's sampler on the device: greedy when temperature <=
        # 0, else top-k mask + temperature + a Gumbel-max draw seeded
        # with (seed, pos)
        logits = st["logits"]
        if sampling.temperature <= 0:
            out = torch.argmax(logits)
        else:
            self._gen.manual_seed((int(seed) << 32) + int(pos))
            scaled = _mask_and_scale(
                logits[None],
                torch.full((1,), sampling.temperature, device=self.device),
                torch.full((1,), sampling.top_k, dtype=torch.long,
                           device=self.device))
            out = _gumbel_argmax(scaled, self._gen)[0]
        if "token" in st:
            st["token"].copy_(out)
            return st["token"]
        return out

    def _token(self, tok: int, pos: int, kh, vh, chain_len: int, ktail,
               vtail, base: int, n_tail: int) -> np.ndarray:
        """One full forward for one token (legacy loop): per layer, write
        its K/V into the tail, then merge attention partials over the
        tail and over the chain paged through the fixed window, one
        pageable (layer, window) slice at a time. ``kh``/``vh`` arrive
        padded to a window multiple; ``chain_len`` is the context length
        the positions mask against."""
        fam = self.family
        h = self._embed(tok, pos)
        _count(f"embed@{fam}", h)
        self._disp(f"embed@{fam}")
        n_win = kh.shape[1] // self.win
        idx = n_tail            # this token's tail slot
        for l in range(self.cfg.n_layers):
            q, k, v = self._layer_in(l, h, pos)
            _count(f"layer_in@{fam}", h)
            self._disp(f"layer_in@{fam}")
            ktail[l, idx] = k.to(ktail.dtype)
            vtail[l, idx] = v.to(vtail.dtype)
            _count(f"tail_set@{fam}", ktail, vtail)
            self._disp(f"tail_set@{fam}")
            o, lse = self._tail_partial(q, ktail, vtail, l, pos, base,
                                        idx + 1)
            _count(f"tail@{fam}", q, ktail)
            self._disp(f"tail@{fam}")
            for w in range(n_win):
                w0 = w * self.win
                kw = kh[l, w0:w0 + self.win].to(self.device)
                vw = vh[l, w0:w0 + self.win].to(self.device)
                j = torch.arange(self.win, device=self.device)
                n_valid = min(chain_len - w0, self.win)
                kvpos = torch.where(j < n_valid, w0 + j, _FAR)
                ow, lw = self._partial(q, kw, vw, pos, kvpos)
                _count(f"win@{fam}", q, kw)
                self._disp(f"win@{fam}")
                o, lse = merge_attention(o, lse, ow, lw)
                _count(f"merge@{fam}", o, ow)
                self._disp(f"merge@{fam}")
                # every window slices and copies one (layer, window)
                # piece of the host chain: this loop's transfer unit
                self._note_fetch()
            h = self._layer_out(l, h, o)
            _count(f"layer_out@{fam}", h, o)
            self._disp(f"layer_out@{fam}")
        logits = self._logits(h)
        _count(f"head@{fam}", h)
        self._disp(f"head@{fam}")
        return logits.cpu().numpy()


class _SlabPager:
    """The double buffer of one token's slab walk. On a CUDA device slab
    i is copied into ``bufs[i % 2]`` on the decoder's side stream, after
    the event the compute stream recorded behind the last ``fwin`` that
    read that buffer, and ``take`` makes the compute stream wait for the
    copy's event. On the CPU a slab is its host view."""

    def __init__(self, dec: WorkingSetDecoder, kvh, bufs):
        self.dec, self.kvh, self.bufs = dec, kvh, bufs
        self.pending: Dict[int, object] = {}

    def issue(self, i: int, l: int, s: int) -> None:
        self.dec._note_fetch()
        if self.bufs is None:
            self.pending[i] = self.kvh[l, s]
            return
        stream = self.dec._copy_stream
        freed = self.dec._freed[i % 2]
        with torch.cuda.stream(stream):
            if freed is not None:
                stream.wait_event(freed)
            self.bufs[i % 2].copy_(self.kvh[l, s], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        self.pending[i] = done

    def take(self, i: int):
        got = self.pending.pop(i)
        if self.bufs is None:
            return got
        torch.cuda.current_stream(self.dec.device).wait_event(got)
        return self.bufs[i % 2]

    def release(self, i: int) -> None:
        if self.bufs is not None:
            freed = torch.cuda.Event()
            freed.record(torch.cuda.current_stream(self.dec.device))
            self.dec._freed[i % 2] = freed
