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
  row meets the same op shapes in every step and, in a dense model, a
  request's tokens do not depend on the rest of the batch (in bf16 on
  the GPU, a lane's rounding otherwise changed with the step shape that
  carried it). A preempted request's tokens, recomputed as prompt rows,
  may still round otherwise. The chunk's rows, all of one request,
  gather that request's paged context once, not once per row. In each
  layer both groups scatter their K/V, lanes first, before either
  gathers: the reference's scatter-all-then-gather order over its one
  batch.
- **MoE** (``models/moe.py``): a MoE layer routes the step's rows once,
  lanes then chunk, as the reference's one batch is routed: the
  capacity ``capacity(T)`` of the step's T rows (``moe_capacity_factor``
  overrides the config's) and the token-major slot order decide which
  tokens drop, inactive rows (empty lanes, draft rows past their
  length, chunk padding) taking slots as in the reference. So in a MoE
  model a lane's expert output depends on the step's rows, as it does
  in the reference; the dense layers keep their per-group shapes.
  ``moe_shards`` resolves against the engine's ranks (one for an engine
  in one process): more than one splits the stacks on their expert
  dimension across them (below).
- **The weight plane** (``serving/weightplane.py``): a params tree whose
  matmul leaves are int8 qtensors (``serving.parity=relaxed``) has each
  layer's dense weights (and a quantized head) dequantized once per step
  through ``weightplane.dequant`` (the dequantize kernel on the GPU) and
  every row group multiplies that one tensor, the bits ``qdot`` gives;
  the expert stacks go through ``qedot``, a quantized embedding through
  ``qrows``; with ``moe_a2a_codec`` int8 the expert payloads take the
  reference's int8 round trip. The int8 stacks and scales are
  engine-lifetime parameters; the dequantized weights live in the
  graph's pool (shared by the two shapes).
  ``hbm_bytes`` sizes the KV pool, and the lanes when ``max_batch`` is
  unset (capped by ``max_lanes``), against the measured resident weight
  bytes; ``weight_plane()`` reports the reference's keys, and the HBM
  ledger carries the expert stacks as ``moe_experts`` beside
  ``weights``.
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
  scan runs on the device and the host reads back one packed bundle
  ``[B, k+4]`` (tokens | emit count | finished | accept length) per
  step.
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

- **Tiered fleet-wide cache** (``serving/kvstore``): zero-ref pages the
  radix evicts demote to a host-RAM ring (``kv_host_bytes``; page-locked
  on a CUDA device), hot shared prefixes persist to a DFS store
  (``kv_store_fs``, any ``FileSystemLike``) on a background writer, and a
  radix miss at admission walks host, then DFS, along the prefix chain
  before it prefills. The page movers copy one page out (``.cpu()``,
  which synchronises before the tier reads the copy) or into the pools
  in place (``copy_``: the captured graphs keep their addresses), on the
  scheduler thread between steps. ``persist_cache``, the drain persist of
  ``stop(drain=True)`` and ``prefill_to_store`` (the prefill half of
  prefill/decode disaggregation) ship resident prefixes to the store.
  The chain digests and the block files are the reference's byte for
  byte, so one store serves both packages.
- **Speculative decoding** (``speculate_k``): a host-side n-gram index
  over each request's history (``serving/speculate.py``) proposes up to
  k drafts per lane; each lane becomes a group of k+1 rows (its last
  token plus the drafts at consecutive positions) that share one gather
  of the lane's paged context, and the same captured step verifies them:
  greedy lanes accept by argmax equality, sampled lanes by rejection
  against the target (``u < p(draft)``; a rejection redraws from the
  target with that draft removed), so the output law is the target's.
  The drafts and their lengths sit in one static device buffer the host
  writes only on steps that carry proposals (``spec_uploads``); the two
  step shapes are ``[B(k+1)]`` and ``[B(k+1)] + C`` rows, one capture
  each. A possibly-rejected draft never evicts a cached page: the drafts
  are clamped to the pages a lane owns. Rejected rows' K/V lands beyond
  the accepted tip and is rewritten before anything attends to it; the
  radix only ever sees accepted, block-aligned tokens. ``speculate_k=0``
  is exactly the step without speculation.

- **Long-context lane.** With a ``serving/longctx`` plane attached
  (``attach_longctx``, under ``serving.parity=relaxed`` only: the CP
  softmax reassociation is not bitwise), prompts of at least
  ``serving.longctx.min.tokens`` bypass the fused step: ``submit`` and
  ``prefill_to_store`` route them to the plane, ``idle`` and
  ``stop(drain=)`` wait for it, ``longctx_stats`` reports it.

- **Ranks: a tensor-parallel plan and expert shards.** The reference
  is one process whose placement GSPMD partitions; here each rank is a
  process of a ``torch.distributed`` world and the engine is built on
  every one of them. ``plan=MeshPlan(tp=n[, dp=m])`` (``mesh``:
  ``make_mesh(plan)``, made when not passed) places the weights by
  ``param_specs`` (column-parallel q/k/v and gate/up/in, row-parallel
  o/down/out, the vocabulary split in the embedding and the head, the
  MoE stacks split on their FFN dimension) and the K/V pool on its head
  dimension; ``params`` is the full tree (the engine keeps its shards)
  or this rank's shards (``load_serving_params(mesh=, specs=)``), told
  apart by shape. Without a plan, ``mesh=make_mesh(MeshPlan(dp=k))``
  makes the ranks a group that the expert stacks split over
  (``moe_shards`` > 1), payload and scales together; dense leaves stay
  whole. The step's math is the unsharded graph's: the embedding sums
  this rank's rows over tp, each row-parallel product is this rank's
  float32 partial summed over tp (``spmd.psum_raw``, in rank order, so
  every rank holds the same bits) and rounded once, as the single
  device's product is, before gpt2's ``b_out`` is added once; the
  head's vocabulary columns are gathered before sampling. A MoE layer
  routes the step's rows on every rank; under tp each expert's product
  over this rank's d_ff slice is summed likewise before the combine,
  and over expert shards each rank combines its experts' outputs and
  the float32 partial combines are summed once. Position 0 of the mesh
  drives: it alone schedules (admission, the radix, the tiers,
  speculation's drafts) and, each step, broadcasts the step's inputs
  (the device step state, the chunk, the drafts, the step count and
  shape) in one message; every other rank runs ``follow()``, which
  executes what the driver sends (a step, a page injected or gathered,
  fresh pools after a failed step) until it stops. A driver that stops,
  or whose ``step()`` raises outside the step's collectives, releases
  its followers. Over gloo a collective cannot sit in a CUDA graph (it
  moves through host memory), so a multi-rank engine runs the eager
  step (``mesh_stats()["path"]``). Sizes and reports (``weight_bytes``,
  ``num_blocks``, ``weight_plane()``) are the reference's global ones;
  the HBM ledger holds this rank's own bytes.

Attention in the step is torch ops (the reference's is plain jnp too) —
the flash kernel does not take paged, offset rows.

Refused as the reference refuses: a plan with pp, sp or ep above 1
(``ValueError``) and an int8 tree with a plan (``NotImplementedError``).
Refused with ``NotImplementedError`` naming its ROADMAP item: the
long-context plane on a multi-rank engine (A 6 item 5).
``prefill_to_store`` raises the reference's ``ValueError`` for an engine
without a DFS tier.
"""

from __future__ import annotations

import dataclasses
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
# MoE serving shares models/moe.py's dispatch math: the capacity padding
# keeps the step's shapes fixed
from hadoop_tpu_torch.models.moe import _expert_ffn, route
from hadoop_tpu_torch.models.moe import capacity as moe_capacity
from hadoop_tpu_torch.obs.hbm import hbm_ledger
from hadoop_tpu_torch.ops import gelu, rope_frequencies, swiglu
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.mesh import (MeshPlan, make_mesh,
                                            param_specs_for, shard_params)
from hadoop_tpu_torch.parallel.lowp.quant import (moe_combine_quantized,
                                                  moe_dispatch_quantized)
from hadoop_tpu_torch.serving import weightplane
from hadoop_tpu_torch.serving.kvstore import BlockPool, TieredKVCache
from hadoop_tpu_torch.serving.speculate import NgramProposer
from hadoop_tpu_torch.serving.weightplane import (describe_tree,
                                                  expert_shard_count,
                                                  expert_weight_bytes,
                                                  is_qtensor,
                                                  is_quantized_tree, qedot,
                                                  qrows,
                                                  resident_weight_bytes,
                                                  shard_expert_stacks)
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
    _proposer: Optional[Any] = None   # n-gram draft index (speculation)
    _blocks: List[int] = field(default_factory=list)
    _shared_blocks: int = 0           # leading blocks mapped from cache
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


def _gumbel_argmax(scores, generator: torch.Generator):
    """One categorical draw per row of ``scores`` (logits), Gumbel-max."""
    u = torch.rand(scores.shape, generator=generator, device=scores.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20)))
    return torch.argmax(scores + gumbel, dim=-1)


def _sample(logits, temps, topks, generator: torch.Generator):
    """logits [T, V] float32; per-row temperature/top-k; greedy when
    temperature <= 0, else a Gumbel-max draw from the scaled logits."""
    greedy = torch.argmax(logits, dim=-1)
    sampled = _gumbel_argmax(_mask_and_scale(logits, temps, topks),
                             generator)
    return torch.where(temps <= 0, greedy, sampled)


def _remove_draft(p, draft, rejected):
    """The target ``p`` [B, V] with each rejected lane's draft token
    removed and the rest renormalised (lanes not rejected keep ``p``)."""
    vocab = torch.arange(p.shape[-1], device=p.device)
    adj = torch.where(rejected[:, None] & (vocab[None, :] == draft[:, None]),
                      torch.zeros_like(p), p)
    return adj / torch.clamp(adj.sum(-1, keepdim=True), min=1e-30)


def _verify(logits, drafts, draft_lens, temps, topks,
            generator: torch.Generator):
    """Verify each lane's drafts against its own rows' logits.

    ``logits`` [B, G, V] float32 are the lane groups' rows (last token,
    then the G-1 drafts at consecutive positions), ``drafts`` [B, G-1],
    ``draft_lens`` [B]. Greedy lanes (temperature <= 0) accept a draft
    while it equals the argmax; sampled lanes accept it with probability
    p(draft) under the target (``_mask_and_scale``'s transform, softmax),
    and at the first rejection redraw from the target with that draft
    removed, so a lane's output law is the target's. Returns ``out``
    [B, G] (the accepted drafts, then the bonus token, in every later
    column) and ``accept`` [B], the number of drafts accepted."""
    B, G, V = logits.shape
    S = G - 1
    greedy_tok = torch.argmax(logits, dim=-1)                    # [B, G]
    scaled = _mask_and_scale(logits, temps[:, None].expand(B, G),
                             topks[:, None].expand(B, G))
    probs = torch.softmax(scaled, dim=-1)                        # [B, G, V]
    u = torch.rand((B, S), generator=generator, device=logits.device)
    p_draft = torch.gather(probs[:, :S], 2, drafts[..., None])[..., 0]
    greedy_lane = temps <= 0
    ok = torch.where(greedy_lane[:, None], drafts == greedy_tok[:, :S],
                     u < p_draft)
    ok = ok & (torch.arange(S, device=logits.device)[None, :]
               < draft_lens[:, None])
    accept = torch.cumprod(ok.long(), dim=1).sum(dim=1)          # [B]
    p_a = torch.gather(probs, 1, accept[:, None, None].expand(B, 1, V))[:, 0]
    g_a = torch.gather(greedy_tok, 1, accept[:, None])[:, 0]
    d_a = torch.gather(drafts, 1, torch.clamp(accept, max=S - 1)[:, None])[:, 0]
    adj = _remove_draft(p_a, d_a, accept < draft_lens)
    samp_a = _gumbel_argmax(torch.log(torch.clamp(adj, min=1e-38)),
                            generator)
    final = torch.where(greedy_lane, g_a, samp_a)                # [B]
    draft_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    gj = torch.arange(G, device=logits.device)
    out = torch.where(gj[None, :] < accept[:, None], draft_pad,
                      final[:, None])
    return out, accept


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the KV tiers hold it: numpy, bf16 as uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``_to_host`` (copies, so a read-only buffer is fine)."""
    a = np.array(a)
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported to the PyTorch engine "
                              f"yet (ROADMAP Queue A {item})")


def _engine_mesh(plan, mesh):
    """The mesh an engine's ranks form (``make_mesh(plan)`` when only a
    plan is given), or None for an engine in one process alone."""
    if mesh is None:
        if plan is None or plan.n_devices == 1:
            return None
        mesh = make_mesh(plan)
    elif plan is not None and mesh.plan != plan:
        raise ValueError(f"plan={plan} differs from the mesh's {mesh.plan}")
    elif plan is None and mesh.plan.n_devices != mesh.plan.dp:
        raise ValueError("a mesh without a plan is a group for the expert "
                         "stacks, MeshPlan(dp=k); pass plan= for tp")
    return mesh if len(mesh.ranks) > 1 else None


def _spread_bytes(tree, specs, sizes) -> int:
    """The bytes of the whole tree whose shards ``tree`` holds: each
    leaf's bytes times the ranks that split it (``param_specs``)."""
    if isinstance(tree, dict):
        return sum(_spread_bytes(tree[k], specs[k], sizes) for k in tree)
    ways = 1
    for name in specs:
        if name is not None:
            ways *= sizes[name]
    return tree.numel() * tree.element_size() * ways


# the driver's commands to its followers (a message's first element)
_STEP, _INJECT, _EXTRACT, _RESET, _STOP = range(1, 6)
_HEAD = 4                   # command, step count, fused, argument


# ----------------------------------------------------------------- engine

class DecodeEngine:
    """Continuous-batching decode over a fixed slot batch and a paged KV
    pool, with prefix reuse and step-fused chunked prefill. Drive it
    with the background scheduler thread (``start``/``submit``/``stop``)
    or by calling ``step()`` directly (tests, offline runs)."""

    def __init__(self, params, cfg: ModelConfig, *,
                 max_batch: Optional[int] = None, block_size: int = 8,
                 num_blocks: Optional[int] = None,
                 max_context: Optional[int] = None,
                 prefill_chunk: int = 16,
                 prefix_cache: bool = True,
                 device=None,
                 kv_host_bytes: int = 0,
                 kv_store_fs=None, kv_store_dir: str = "/kvcache",
                 kv_dfs_min_refs: int = 1, kv_codec: str = "raw",
                 kv_fetch_window: int = 4,
                 speculate_k: int = 0, speculate_ngram: int = 3,
                 admission_queue=None, drain_persist: bool = True,
                 hbm_bytes: int = 0, max_lanes: int = 16,
                 quantize_seconds: float = 0.0,
                 moe_capacity_factor: float = 0.0, moe_shards: int = 0,
                 moe_a2a_codec: str = "int8",
                 plan=None, mesh=None, metrics=None, tracer=None):
        self.device = resolve_device(device)
        check_on(params["embed"]["q"] if is_qtensor(params["embed"])
                 else params["embed"], self.device, "params")
        self.cfg = cfg
        # the expert plane: every row of a step routes through
        # models/moe.py's capacity-padded dispatch, together
        if moe_a2a_codec not in ("int8", "none"):
            raise ValueError(f"serving.moe.a2a.codec={moe_a2a_codec!r} "
                             "(choices: int8, none)")
        self._moe_a2a_codec = moe_a2a_codec
        self._moe_cfg = cfg
        if cfg.is_moe and moe_capacity_factor:
            self._moe_cfg = dataclasses.replace(
                cfg, capacity_factor=float(moe_capacity_factor))
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
        # the weight plane: under serving.parity=relaxed the matmul
        # leaves are int8 + scales, and the measured resident bytes
        # decide the KV budget
        self._relaxed_weights = is_quantized_tree(params)
        self._q_embed = is_qtensor(params.get("embed"))
        self._q_head = is_qtensor(params["embed"]) if cfg.tie_embeddings \
            else is_qtensor(params.get("lm_head"))
        if self._relaxed_weights and plan is not None:
            raise NotImplementedError(
                "tp sharding of int8 resident weights is not wired yet "
                "(serving.parity=relaxed serves single-chip replicas)")
        if plan is not None and (plan.pp != 1 or plan.sp != 1 or
                                 plan.ep != 1):
            raise ValueError("serving shards over tp (and dp) only; "
                             f"got plan={plan}")
        self._mesh = _engine_mesh(plan, mesh)
        self.plan = self._mesh.plan if self._mesh is not None else MeshPlan()
        # the engine's ranks: a mesh's, or this process alone (one
        # device, whatever the host holds)
        n_ranks = len(self._mesh.ranks) if self._mesh is not None else 1
        self.expert_shards = expert_shard_count(
            cfg.n_experts, int(moe_shards), n_ranks) if cfg.is_moe else 0
        params = self._place_params(params, plan)
        self.quantize_seconds = quantize_seconds
        self.hbm_bytes = int(hbm_bytes or 0)
        self.block_nbytes = (2 * cfg.n_layers * block_size * cfg.n_kv_heads
                             * cfg.head_dim * cfg.torch_dtype.itemsize)
        if self.hbm_bytes:
            # capacity = budget minus what the weights measurably occupy;
            # lanes sized so that each can hold a full context
            kv_budget = self.hbm_bytes - self.weight_bytes
            min_blocks = self.blocks_per_seq + 2  # one lane + scratch
            if kv_budget < min_blocks * self.block_nbytes:
                raise ValueError(
                    f"serving.kv.hbm.bytes={self.hbm_bytes} leaves "
                    f"{kv_budget} bytes of KV after {self.weight_bytes} "
                    f"bytes of resident weights — below one "
                    f"{self.s_max}-token lane "
                    f"({min_blocks * self.block_nbytes} bytes)")
            if num_blocks is None:
                num_blocks = int(kv_budget // self.block_nbytes)
            if max_batch is None:
                max_batch = max(1, min(int(max_lanes),
                                       (num_blocks - 1)
                                       // self.blocks_per_seq))
        if max_batch is None:
            max_batch = 4
        self.max_batch = max_batch
        if num_blocks is None:
            num_blocks = max_batch * self.blocks_per_seq + 1
        self.pool = BlockPool(num_blocks, block_size)
        # the pool holds this rank's K/V heads
        pool_shape = (cfg.n_layers, num_blocks, block_size, self._hkv,
                      cfg.head_dim)
        self._kp = torch.zeros(pool_shape, dtype=cfg.torch_dtype,
                               device=self.device)
        self._vp = torch.zeros_like(self._kp)
        self.metrics = metrics
        if metrics:
            metrics.weight_bytes.set(self.weight_bytes)
        self.tracer = tracer or global_tracer()
        # the tier manager owns the radix index and the cold tiers; the
        # engine stays the device owner (the page movers below)
        self.kvstore = TieredKVCache(
            self.pool, layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, dtype=cfg.torch_dtype,
            enabled=prefix_cache, host_bytes=kv_host_bytes,
            fs=kv_store_fs, dfs_dir=kv_store_dir,
            dfs_min_refs=kv_dfs_min_refs, codec=kv_codec,
            fetch_window=kv_fetch_window, metrics=metrics,
            tracer=self.tracer, extract=self._extract_block,
            pin=self.device.type == "cuda")
        self.prefix_cache = self.kvstore.radix
        # the HBM ledger (obs/hbm.py): the weights (the expert stacks as
        # their own component) and the K/V pool sized beside them,
        # unregistered in stop(). The providers return numbers, so an
        # engine never stopped pins no tensor there.
        # (this rank's bytes: its shards and its heads of the pool)
        kv_pool_bytes = num_blocks * self.block_nbytes // self.plan.tp
        # trailing separator: unregister_prefix("engine@123") must not
        # also match a coexisting "engine@1234..." owner
        self._hbm_owner = f"engine@{id(self)}."
        led = hbm_ledger()
        expert_bytes = expert_weight_bytes(params, cfg)
        dense_bytes = resident_weight_bytes(params) - expert_bytes
        led.register(f"{self._hbm_owner}weights", "weights",
                     lambda: dense_bytes)
        if cfg.is_moe:
            led.register(f"{self._hbm_owner}experts", "moe_experts",
                         lambda: expert_bytes)
        led.register(f"{self._hbm_owner}kv", "kv_pool",
                     lambda: kv_pool_bytes)
        self._layers = layer_slices(params["layers"], cfg.n_layers)
        self._cos, self._sin = (rope_frequencies(
            cfg.head_dim, cfg.max_seq, cfg.rope_theta, device=self.device)
            if cfg.use_rope else (None, None))
        self._gen = torch.Generator(device=self.device)

        # speculation lane: k draft tokens per decode lane, verified by
        # the same step (0 = off: every lane is one row, the step without
        # speculation)
        self.spec_k = max(0, int(speculate_k))
        self.spec_ngram = max(1, int(speculate_ngram))
        self.spec_proposed = 0
        self.spec_accepted = 0
        self.spec_uploads = 0        # host→device writes of the drafts
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
        # per-step draft proposals: host-filled, then written to the
        # static device buffer (drafts [B, k], then lengths) only on steps
        # that carry proposals; a step without proposals zeroes it on the
        # device, so an idle speculation lane uploads nothing
        self._draft_tokens = np.zeros((max_batch, self.spec_k), np.int64)
        self._draft_lens = np.zeros((max_batch,), np.int64)
        self._spec_in = torch.zeros(max_batch, self.spec_k + 1,
                                    dtype=torch.int64, device=self.device)
        # per shape (fused or not): the captured graph and its output
        self._graphs: Dict[bool, "torch.cuda.CUDAGraph"] = {}
        self._graph_out: Dict[bool, torch.Tensor] = {}
        self._graph_stream = None
        self._graph_pool = None

        # the admission seam: a deque, or any deque-shaped queue
        # (append/appendleft/popleft/len/[0]) such as the door's QoS
        # FairAdmissionQueue
        self._pending = admission_queue if admission_queue is not None \
            else deque()                        # guarded-by: _cond
        self.drain_persist = drain_persist
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
        self.prefix_tokens_seen = 0
        self.prefix_tokens_matched = 0
        self.prefix_evictions = 0
        self.prefix_inserted_blocks = 0
        # the long-context plane (serving/longctx), attached after
        # construction (it reads this engine's kvstore) and only under
        # serving.parity=relaxed: the CP softmax reassociation is not
        # bitwise
        self._relaxed_longctx = None

    def _place_params(self, params, plan):
        """This rank's placement of ``params`` and the engine's ranks: the
        tp axis and this rank's heads, the expert group whose partial
        combines a MoE layer sums, the driver's channel. Sets the weight
        figures, the reference's global ones. Returns this rank's tree."""
        cfg, mesh = self.cfg, self._mesh
        tp = self.plan.tp
        self._tp_axis = mesh.axis("tp") if mesh is not None else None
        self._tp_index = spmd.axis_index(self._tp_axis)
        self._hq, self._hkv = cfg.n_heads // tp, cfg.n_kv_heads // tp
        self._moe_axis, self._expert_index = None, 0
        self._channel = None
        self._driver = mesh is None or mesh.rank == 0
        self._released = False   # the followers were sent _STOP, or lost
        desc = describe_tree(params)
        expert_bytes = expert_weight_bytes(params, cfg)
        if mesh is not None and plan is not None:
            # the reference's placement (param_specs); the tree is whole
            # or this rank's shards
            self.plan.validate(cfg, self.plan.dp, 1)
            rows = params["embed"].shape[0]
            if tp > 1 and rows == cfg.vocab_size:
                params = shard_params(params, self.plan, mesh)
            elif rows != cfg.vocab_size // tp:
                raise ValueError(f"embed has {rows} rows: neither the "
                                 f"vocabulary nor its 1/{tp}")
            specs = param_specs_for(params, self.plan)
            desc["weight_bytes"] = _spread_bytes(params, specs,
                                                 self.plan.sizes)
            layers = params["layers"]
            expert_bytes = sum(
                _spread_bytes(layers[k], specs["layers"][k], self.plan.sizes)
                for k in weightplane.EXPERT_STACKS
                if k in layers) if cfg.is_moe else 0
        elif mesh is not None and self.expert_shards > 1:
            # the ranks are the expert group: each holds its experts
            s, n = self.expert_shards, len(mesh.ranks)
            if n % s:
                raise ValueError(f"serving.moe.shards={s} does not divide "
                                 f"the engine's {n} ranks")
            self._expert_index = mesh.rank % s
            self._moe_axis = mesh.axis("dp") if s == n else spmd.new_groups(
                "moe", [list(mesh.ranks[g:g + s]) for g in range(0, n, s)],
                members_only=mesh.group is not None)
            stack = params["layers"]["w_gate"]
            if (stack["q"] if is_qtensor(stack) else stack).shape[1] \
                    == cfg.n_experts:
                params = shard_expert_stacks(params, s, self._expert_index)
            local = expert_weight_bytes(params, cfg)
            expert_bytes = local * s
            desc = describe_tree(params)
            desc["weight_bytes"] += expert_bytes - local
        if mesh is not None:
            self._channel = spmd.new_groups(
                "engine", [list(mesh.ranks)],
                members_only=mesh.group is not None)
        if self._tp_axis is not None and cfg.torch_dtype != torch.float32:
            # the row-parallel weights in float32, once: this rank's
            # partial product stays float32 until the tp sum, which rounds
            # once, as one device's product does (the HBM ledger counts
            # them at this size; the weight figures stay the reference's)
            layers = dict(params["layers"])
            for name in ("wo", "w_down", "w_out"):
                if name in layers:
                    layers[name] = layers[name].float()
            params = dict(params, layers=layers)
        # fixed at construction: health scrapes read it from a handler
        # thread and touch no tensor
        self._weight_desc = desc
        self.weight_bytes = desc["weight_bytes"]
        self.expert_bytes = expert_bytes
        self.params = params
        return params

    def mesh_stats(self) -> Dict[str, Any]:
        """The engine's ranks: their count, tp, dp, the expert shards,
        whether this rank drives, and which step runs (``"graph"``: the
        captured CUDA graphs; ``"eager"``: op by op, on the CPU and on a
        multi-rank engine)."""
        return {"ranks": 1 if self._mesh is None else len(self._mesh.ranks),
                "tp": self.plan.tp, "dp": self.plan.dp,
                "expert_shards": self.expert_shards,
                "driver": self._driver,
                "path": "graph" if self.device.type == "cuda" and
                        self._channel is None else "eager"}

    def attach_longctx(self, plane) -> None:
        """Wire the long-context plane (``serving/longctx``): prompts at
        least ``plane.min_tokens`` long route to it from ``submit``
        instead of the fused step. The caller is the relaxed-tier gate
        (``longctx_plane_from_conf`` re-validates)."""
        if self._channel is not None:
            _refuse("the long-context plane on a multi-rank (tp or "
                    "expert-sharded) engine", "6 item 5")
        self._relaxed_longctx = plane

        def wake() -> None:
            # a drain parked on `idle` in stop() waits on the scheduler
            # condition: a completion on the plane's worker wakes it
            with self._cond:
                self._cond.notify_all()

        plane.on_done = wake

    @property
    def decode_compiles(self) -> int:
        """Distinct row counts of decode-only steps (1 when shapes hold)."""
        return len(self._row_counts["decode"])

    @property
    def prefill_compiles(self) -> int:
        """Distinct row counts of fused steps (1 when shapes hold)."""
        return len(self._row_counts["fused"])

    # ------------------------------------------------- tier page movers

    def _extract_block(self, blk: int):
        """One page's (K, V) payload ``[L, bs, Hkv, Dh]`` as host numpy
        (bf16 as uint16 bits) — the demotion and persistence copy. The
        copy to the host synchronises, so the tier reads finished bytes.
        Under tp the ranks' heads are gathered (a command)."""
        if self._tp_axis is not None:
            self._command(_EXTRACT, blk)
        kv = self._gather_page(blk).cpu()
        return _to_host(kv[0]), _to_host(kv[1])

    def _gather_page(self, blk: int) -> torch.Tensor:
        """Page ``blk``'s [2, L, bs, Hkv, Dh], every head (gathered over
        tp)."""
        kv = torch.stack([self._kp[:, blk], self._vp[:, blk]])
        return spmd.all_gather_raw(kv, self._tp_axis, 3)

    def _inject_block(self, blk: int, k, v) -> None:
        """Write a cold-tier payload into pool page ``blk``, in place: the
        captured graphs keep reading the same pool tensors. On a
        multi-rank engine the payload goes to every rank (a command)."""
        kv = torch.stack([_from_host(k, self._kp.dtype),
                          _from_host(v, self._vp.dtype)]).to(self.device)
        if self._channel is not None:
            self._command(_INJECT, blk)
            spmd.broadcast_raw(kv, self._channel)
        self._write_page(blk, kv)

    def _write_page(self, blk: int, kv: torch.Tensor) -> None:
        """This rank's heads of a whole page payload [2, L, bs, Hkv, Dh]
        into page ``blk``."""
        kv = kv.narrow(3, self._tp_index * self._hkv, self._hkv)
        self._kp[:, blk].copy_(kv[0])
        self._vp[:, blk].copy_(kv[1])

    # ------------------------------------------------- driver and followers

    def _message(self, cmd: int, fused: bool = False, arg: int = 0
                 ) -> torch.Tensor:
        """The driver's one message: the command, the step count, the
        step's shape and an argument, then (a step) its inputs: the
        device step state, the chunk and the drafts, as int64 (the
        temperatures' float32 bits)."""
        head = torch.tensor([cmd, self.steps, int(fused), arg],
                            dtype=torch.int64, device=self.device)
        if cmd != _STEP:
            return torch.cat([head, torch.zeros(
                self._body_len, dtype=torch.int64, device=self.device)])
        st = self._dstate
        return torch.cat([head] + [
            st[k].view(torch.int32).long() if k == "temps" else
            st[k].long().reshape(-1) for k in st] + [
            self._chunk_in, self._spec_in.reshape(-1)])

    @property
    def _body_len(self) -> int:
        return sum(t.numel() for t in self._dstate.values()) \
            + self._chunk_in.numel() + self._spec_in.numel()

    def _command(self, cmd: int, arg: int = 0, fused: bool = False) -> None:
        """Send one command to the followers (the driver's side)."""
        if self._released:
            raise RuntimeError("the engine's followers were released")
        spmd.broadcast_raw(self._message(cmd, fused, arg), self._channel)

    def _take_step(self, msg: torch.Tensor) -> bool:
        """A follower's copy of the driver's step inputs; returns the
        step's shape (fused)."""
        body = msg[_HEAD:]
        at = 0
        for k, t in list(self._dstate.items()) + [
                ("chunk", self._chunk_in), ("spec", self._spec_in)]:
            piece = body[at:at + t.numel()].view(t.shape)
            at += t.numel()
            if k == "temps":
                piece = piece.int().view(torch.float32)
            t.copy_(piece.to(t.dtype))
        self.steps = int(msg[1])
        return bool(msg[2])

    def follow(self) -> None:
        """Run what the driver (mesh position 0) sends until it stops:
        each step on the driver's inputs, pages injected or gathered,
        fresh pools when the driver resets. Returns on the driver's stop. A
        step that fails here raises: the other ranks may be inside the
        step's collectives, which fail once this process's connections
        close; a driver that is gone raises from the collective."""
        if self._channel is None or self._driver:
            raise RuntimeError("follow() runs on a follower rank of a "
                               "multi-rank engine")
        template = self._message(_STOP)
        try:
            while True:
                msg = spmd.broadcast_raw(template, self._channel)
                cmd, arg = int(msg[0]), int(msg[3])
                if cmd == _STOP:
                    return
                if cmd == _STEP:
                    self._step_eager(self._take_step(msg))
                    self.steps += 1          # the driver's count
                elif cmd == _INJECT:
                    kv = spmd.broadcast_raw(torch.empty(
                        (2, self.cfg.n_layers, self.block_size,
                         self.cfg.n_kv_heads, self.cfg.head_dim),
                        dtype=self._kp.dtype, device=self.device),
                        self._channel)
                    self._write_page(arg, kv)
                elif cmd == _EXTRACT:
                    self._gather_page(arg)
                elif cmd == _RESET:
                    self._reset_local()
                else:
                    raise RuntimeError(f"unknown command {cmd}")
        finally:
            hbm_ledger().unregister_prefix(self._hbm_owner)
            self.kvstore.close()

    def _release_followers(self) -> None:
        """Send the followers _STOP, once."""
        if self._channel is not None and self._driver and \
                not self._released:
            self._command(_STOP)
            self._released = True

    def _require_driver(self) -> None:
        if not self._driver:
            raise RuntimeError("a follower rank takes no requests: mesh "
                               "position 0 drives, the others follow()")

    # ----------------------------------------------------------- the step

    def _layer_weights(self, lp):
        """This layer's weights for the step, each dense matmul operand as
        ``[in, out]`` of ``x @ w``. Under ``serving.parity=relaxed`` each
        int8 dense weight is dequantized once (``weightplane.dequant``, in
        the model's dtype, the activations' own) and every row group
        multiplies that one tensor: the bits ``qdot`` would give each
        group, for one dequantize instead of one per group. The MoE expert
        stacks stay int8 (``_moe_mlp`` routes the step's rows once)."""
        if not self._relaxed_weights:
            return lp
        names = weightplane.LAYER_MATMULS
        if self.cfg.is_moe:
            names = names - weightplane.EXPERT_STACKS
        out = dict(lp)
        for name in names:
            if name in lp and is_qtensor(lp[name]):
                out[name] = weightplane.dequant(lp[name],
                                                self.cfg.torch_dtype).t()
        return out

    def _mlp(self, x, lw):
        """This rank's part of the dense MLP, before the tp sum (and
        before gpt2's ``b_out``, which ``_rows`` adds once after it)."""
        if self.cfg.use_swiglu:
            w = lw["w_down"]
            return swiglu(x @ lw["w_gate"], x @ lw["w_up"]).to(w.dtype) @ w
        w = lw["w_out"]
        return gelu(x @ lw["w_in"] + lw["b_in"]).to(w.dtype) @ w

    def _tp_sum(self, parts: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each row group's row-parallel product summed over tp, in one
        collective for the groups (rank order: every rank gets the same
        bits); the parts themselves without tp."""
        if self._tp_axis is None:
            return parts
        total = spmd.psum_raw(torch.cat(parts), self._tp_axis)
        return list(total.split([p.shape[0] for p in parts]))

    def _moe_mlp(self, x, lp):
        """The routed expert MLP over every row of the step, ``x`` [T,
        D] (the lanes, then the chunk), through models/moe.py's
        capacity-padded dispatch: T is fixed per step shape, so the
        capacity is too. A token past its expert's capacity (inactive
        rows take slots like any other) gets a zero combine row. Under
        the relaxed tier the expert products run against the int8 stacks
        (``qedot``) and, with ``moe_a2a_codec`` int8, both exchange legs
        take the int8 round trip the reference's single-device replica
        takes."""
        dispatch, combine = route(x, lp["router"], self._moe_cfg)
        if self._moe_axis is not None:
            # this rank's experts: every rank routed the same rows
            e = lp["router"].shape[-1] // self.expert_shards
            lo = self._expert_index * e
            dispatch = dispatch[:, lo:lo + e]
            combine = combine[:, lo:lo + e]
        xe = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), x)
        codec = self._relaxed_weights and self._moe_a2a_codec != "none"
        if codec:
            xe = moe_dispatch_quantized(xe)
        if self._relaxed_weights:
            ye = qedot(swiglu(qedot(xe, lp["w_gate"]),
                              qedot(xe, lp["w_up"])), lp["w_down"])
        else:
            # under tp every expert's product over this rank's d_ff slice
            # (float32, as w_down is), summed over tp and rounded once
            ye = spmd.psum_raw(_expert_ffn(xe, lp, self._moe_cfg),
                               self._tp_axis).to(x.dtype)
        if codec:
            ye = moe_combine_quantized(ye)
        # this rank's part of the combine (its experts), summed once in
        # float32 over the expert group
        part = torch.einsum("tec,ecd->td", combine, ye.float())
        return spmd.psum_raw(part, self._moe_axis).to(x.dtype)

    def _group(self, tokens, positions, active, tables, group: int = 1,
               one_context: bool = False) -> Dict[str, Any]:
        """One row group's fixed inputs, each row "one token at one
        position": its embedded rows, the page and offset its K/V lands
        in (block 0 for inactive rows), its visibility mask. ``tables``
        [n, blocks_per_seq] holds one table for each run of ``group``
        consecutive rows (a speculating lane's k+1 rows), whose context
        is gathered once and shared; ``one_context``: every row belongs to
        one request, whose table ([1, blocks_per_seq]) is gathered once."""
        cfg, params = self.cfg, self.params
        t = tokens.shape[0]
        pos = torch.clamp(positions, max=self.s_max - 1)
        if self._relaxed_weights and self._q_embed:
            h = qrows(params["embed"], tokens, cfg.torch_dtype)
        elif self._tp_axis is not None:
            # vocab-parallel: this rank's rows, the rest zero, summed
            # over tp (one term is non-zero: exact)
            embed = params["embed"]
            vl = embed.shape[0]
            local = tokens - self._tp_index * vl
            ok = (local >= 0) & (local < vl)
            h = spmd.psum_raw(torch.where(
                ok[:, None], embed[local.clamp(0, vl - 1)],
                torch.zeros((), dtype=embed.dtype, device=embed.device)),
                self._tp_axis)
        else:
            h = params["embed"][tokens]
        if not cfg.use_rope:
            h = h + params["pos_embed"][torch.clamp(pos, 0, cfg.max_seq - 1)]
        if one_context:
            blk = torch.gather(tables.expand(t, -1), 1,
                               (pos // self.block_size)[:, None])[:, 0]
        else:
            blk = torch.gather(tables, 1, (pos // self.block_size).view(
                tables.shape[0], group)).reshape(t)
        blk = torch.where(active, blk, torch.zeros_like(blk))
        off = pos % self.block_size
        src = None
        if cfg.is_moe:
            # inactive rows share block 0's slots; on CUDA, which of the
            # rows scattering to one slot lands is a race. Routing couples
            # a MoE step's rows (the inactive rows that read block 0 take
            # expert slots ahead of live ones), so there each slot takes
            # its last writer's row, as a serial scatter does
            slot = blk * self.block_size + off
            rows = torch.arange(t, device=self.device)
            src = torch.where(slot[:, None] == slot[None, :], rows[None, :],
                              -1).amax(dim=1)
        visible = torch.arange(self.s_max, device=self.device)[None, :] \
            <= pos[:, None]                                  # [t, S_max]
        return {"h": h, "pos": pos, "blk": blk, "off": off, "src": src,
                "tables": tables, "group": group,
                "one_context": one_context, "visible": visible}

    def _attend(self, g, q, kc, vc) -> torch.Tensor:
        """Attention of a group's rows ``q`` [t, Hq, Dh] over their paged
        context, gathered back through the tables: rows that share a
        table (a one-request chunk, a speculating lane's group) share its
        single view. Returns [t, Hq * Dh] (this rank's heads)."""
        t = q.shape[0]
        hq, hkv, dh = self._hq, self._hkv, self.cfg.head_dim
        rep = hq // hkv
        kctx = kc[g["tables"]].reshape(-1, self.s_max, hkv, dh)
        vctx = vc[g["tables"]].reshape(-1, self.s_max, hkv, dh)
        qs, ctx = "tgrd", "tkgd"
        qr = q.reshape(t, hkv, rep, dh)
        if g["one_context"]:
            kctx, vctx, ctx = kctx[0], vctx[0], "kgd"
        elif g["group"] > 1:
            qs, ctx = "njgrd", "nkgd"
            qr = q.reshape(-1, g["group"], hkv, rep, dh)
        ps = qs[:-1] + "k"
        logits = torch.einsum(f"{qs},{ctx}->{ps}", qr.float(),
                              kctx.float()) * (1.0 / (dh ** 0.5))
        logits = logits.reshape(t, hkv, rep, self.s_max).masked_fill(
            ~g["visible"][:, None, None, :], _NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(vctx.dtype)
        attn = torch.einsum(f"{ps},{ctx}->{qs}",
                            probs.reshape(qr.shape[:-1] + (-1,)), vctx)
        return attn.reshape(t, hq * dh)

    def _rows(self, groups: List[Dict[str, Any]]) -> List[torch.Tensor]:
        """Float32 logits [t, V] of each row group (``_group``), run
        through the layers together. In each layer every group's K/V is
        scattered, in row order (the lanes, then the chunk), before any
        group gathers its context back: the reference's
        scatter-all-then-gather over one batch, so earlier rows' K/V are
        visible to later positions and the mask ``kpos <= pos`` does the
        rest. Attention and the dense matmuls run per group, each at its
        own fixed size; a MoE layer routes the step's rows once, in the
        reference's row order, and splits the result back."""
        cfg = self.cfg
        hq, hkv, dh = self._hq, self._hkv, cfg.head_dim
        sizes = [g["h"].shape[0] for g in groups]
        for li, lp in enumerate(self._layers):
            kc, vc = self._kp[li], self._vp[li]
            lw = self._layer_weights(lp)
            qs = []
            for g in groups:
                t = g["h"].shape[0]
                x = _norm(g["h"], lp["attn_norm_w"], lp.get("attn_norm_b"),
                          cfg)
                q = (x @ lw["wq"]).reshape(t, hq, dh)
                k = (x @ lw["wk"]).reshape(t, hkv, dh)
                v = (x @ lw["wv"]).reshape(t, hkv, dh)
                if cfg.use_rope:
                    q = _rope_at(q, self._cos, self._sin, g["pos"])
                    k = _rope_at(k, self._cos, self._sin, g["pos"])
                if g["src"] is not None:
                    k, v = k[g["src"]], v[g["src"]]
                kc[g["blk"], g["off"]] = k.to(kc.dtype)
                vc[g["blk"], g["off"]] = v.to(vc.dtype)
                qs.append(q)
            wo = lw["wo"]
            outs = self._tp_sum([self._attend(g, q, kc, vc).to(wo.dtype) @ wo
                                 for g, q in zip(groups, qs)])
            for g, o in zip(groups, outs):
                g["h"] = g["h"] + o.to(g["h"].dtype)
            xs = [_norm(g["h"], lp["mlp_norm_w"], lp.get("mlp_norm_b"), cfg)
                  for g in groups]
            if cfg.is_moe:
                ys = self._moe_mlp(torch.cat(xs), lw).split(sizes)
            else:
                ys = self._tp_sum([self._mlp(x, lw) for x in xs])
                if not cfg.use_swiglu:
                    ys = [y + lw["b_out"] for y in ys]
            for g, y in zip(groups, ys):
                g["h"] = g["h"] + y.to(g["h"].dtype)
        if self._relaxed_weights and self._q_head:
            # the quantized head, dequantized once for every group
            leaf = self.params["embed"] if cfg.tie_embeddings \
                else self.params["lm_head"]
            head = weightplane.dequant(leaf, cfg.torch_dtype).t()
        else:
            head = head_matrix(self.params, cfg, cfg.torch_dtype)
        out = [_norm(g["h"], self.params["final_norm_w"],
                     self.params.get("final_norm_b"), cfg) @ head
               for g in groups]
        if self._tp_axis is not None:
            # this rank's vocabulary columns: every rank samples from the
            # whole row
            out = list(spmd.all_gather_raw(torch.cat(out), self._tp_axis,
                                           -1).split(sizes))
        return [o.float() for o in out]

    @torch.no_grad()
    def _step_impl(self, fused: bool) -> torch.Tensor:
        """One step over the decode lanes plus, when ``fused``, one prompt
        chunk, read from ``_chunk_in``. The lanes ([B (k+1)] rows: each
        lane's last token, then its k drafts from ``_spec_in`` when
        speculating) and the chunk ([C] rows) are two row groups
        (``_rows``), each always at its own size, so every dense op a
        row goes through has the same shape in every step: in a dense
        model a request's tokens do not depend on what else the batch
        holds or on which step shape carried it. A MoE layer routes both
        groups' rows together, as the reference does, so there a lane's
        expert output depends on the step's rows, as in the reference.
        A lane's rows share one gather of its context, and so do the
        chunk's. Returns the packed readback, flat int64: per lane k+1
        tokens | emit count | finished | accept length ([B (k+4)]),
        then, when fused, the chunk's first sampled token. It reads only
        tensors that live as long as the engine and writes the step
        state in place, so one call can be captured as a CUDA graph."""
        st = self._dstate
        B, S = self.max_batch, self.spec_k
        G = S + 1
        gj = torch.arange(G, device=self.device)
        if S == 0:
            groups = [self._group(st["last"], st["positions"], st["active"],
                                  st["tables"])]
        else:
            drafts, dlens = self._spec_in[:, :S], self._spec_in[:, S]
            tokens = torch.cat([st["last"][:, None], drafts], dim=1)
            positions = st["positions"][:, None] + gj[None, :]
            active = st["active"][:, None] & (gj[None, :] <= dlens[:, None])
            groups = [self._group(tokens.reshape(B * G),
                                  positions.reshape(B * G),
                                  active.reshape(B * G), st["tables"],
                                  group=G)]
        if fused:
            C = self.prefill_chunk
            c_tok, c_slot = self._chunk_in[:C], self._chunk_in[C:C + 1]
            c_start, c_n = self._chunk_in[C + 1:C + 2], self._chunk_in[C + 2:]
            cj = torch.arange(C, device=self.device)
            groups.append(self._group(c_tok, c_start + cj, cj < c_n,
                                      st["tables"].index_select(0, c_slot),
                                      one_context=True))
        logits = self._rows(groups)
        if S == 0:
            out = _sample(logits[0], st["temps"], st["topks"],
                          self._gen)[:, None]
            accept = torch.zeros_like(st["last"])
        else:
            out, accept = _verify(logits[0].view(B, G, -1), drafts, dlens,
                                  st["temps"], st["topks"], self._gen)

        # on-device stop-condition scan over each lane's group: budget
        # clamp, stop_token cut, lane retirement — the host reads the
        # verdict, it does not compute it
        outc, maxn, stopt = st["outc"], st["maxn"], st["stopt"]
        act = st["active"]
        n_emit = torch.minimum(accept + 1, torch.clamp(maxn - outc, min=0))
        stop_hits = (out == stopt[:, None]) & (stopt >= 0)[:, None]
        first_stop = torch.where(stop_hits, gj[None, :],
                                 torch.full_like(out, G + 1)).min(dim=1).values
        n_emit = torch.minimum(n_emit, first_stop + 1)
        n_emit = torch.where(act, n_emit, torch.zeros_like(n_emit))
        finished = act & ((outc + n_emit >= maxn) | (first_stop < n_emit))
        last_idx = torch.clamp(n_emit - 1, min=0)
        last = torch.where(act, torch.gather(out, 1, last_idx[:, None])[:, 0],
                           st["last"])
        packed = torch.cat([out, n_emit[:, None], finished.long()[:, None],
                            accept[:, None]], dim=1).flatten()
        st["last"].copy_(last)
        st["positions"].add_(n_emit)
        st["outc"].add_(n_emit)
        st["active"].copy_(act & ~finished)
        if fused:
            c_out = _sample(logits[1],
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
        (captured at the shape's first step), else eager. A multi-rank
        engine sends the step's inputs to its followers and runs eager
        (a gloo collective cannot sit in a CUDA graph)."""
        if self._channel is not None:
            self._command(_STEP, fused=fused)
            try:
                return self._step_eager(fused)
            except BaseException:
                # the followers may be inside the step's collectives: no
                # command reaches them now (they fail as this process's
                # connections close), and no later step may start
                self._released = True
                raise
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
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        # thread_local: other threads (the caller's, a door's) may use the
        # device while the scheduler thread captures. The two shapes share
        # one memory pool: they never run at once, and each step's output
        # is read before the other shape replays
        with torch.cuda.graph(graph, pool=self._graph_pool, stream=side,
                              capture_error_mode="thread_local"):
            static_out = self._step_impl(fused)
        self._graphs[fused] = graph
        self._graph_out[fused] = static_out
        return out

    # -------------------------------------------------------- public face

    def submit(self, prompt: List[int],
               sampling: Optional[SamplingParams] = None,
               trace_ctx=None, tenant: str = "") -> GenRequest:
        self._require_driver()
        sampling = sampling or SamplingParams()
        if not prompt:
            raise ValueError("empty prompt")
        if sampling.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill "
                             "always emits the first token)")
        if self._relaxed_longctx is not None and \
                len(prompt) >= self._relaxed_longctx.min_tokens:
            # the long-context lane: CP prefill, KV streamed into the
            # cold tiers, working-set decode; the prompt never has to
            # fit this engine's pool or s_max
            return self._relaxed_longctx.longctx_submit(
                prompt, sampling, trace_ctx=trace_ctx or current_context(),
                tenant=tenant)
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
        """The long-context plane's face (health, the registry record):
        ``{"enabled": False}`` when no plane is attached."""
        lc = self._relaxed_longctx
        return lc.stats() if lc is not None else {"enabled": False}

    def weight_plane(self) -> Dict[str, Any]:
        """The resident-weight policy and the capacity it bought, with the
        reference's keys: dtype, measured weight bytes, quantize-at-load
        seconds, the lanes x context the KV budget admits at those bytes,
        and the expert placement."""
        desc = self._weight_desc
        plane = {
            "parity": "relaxed" if self._relaxed_weights else "bitwise",
            "dtype": desc["dtype"],
            "weight_bytes": self.weight_bytes,
            "quantize_seconds": self.quantize_seconds,
            "quantized_leaves": desc["int8_leaves"],
            "hbm_bytes": self.hbm_bytes,
            "lanes": self.max_batch,
            "max_context": self.s_max,
            "kv_capacity_tokens": self.pool.num_usable * self.block_size,
            "lanes_x_context": self.max_batch * self.s_max,
            "experts": self.cfg.n_experts,
            "expert_shards": self.expert_shards,
            "expert_bytes": self.expert_bytes,
        }
        if self.cfg.is_moe:
            plane["expert_capacity"] = moe_capacity(
                self.max_batch * (self.spec_k + 1), self._moe_cfg)
            plane["a2a_codec"] = self._moe_a2a_codec
        return plane

    @property
    def _local_idle(self) -> bool:
        """Nothing queued and nothing running in the fused step: what the
        scheduler thread waits for."""
        with self._cond:
            has_pending = bool(self._pending)
        return not has_pending and all(r is None for r in self._slots)

    @property
    def idle(self) -> bool:
        """Nothing in flight anywhere (the fused step and the long-context
        plane): the drain/stop predicate."""
        lc = self._relaxed_longctx
        return self._local_idle and (lc is None or lc.idle)

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
            # per-tier traffic: HBM radix hits vs host-ring and DFS
            # recoveries, demotions/promotions/persists
            "tiers": self.kvstore.stats(),
            # speculation lane: draft tokens proposed vs accepted
            "speculate": {
                "k": self.spec_k,
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "accept_rate": (self.spec_accepted / self.spec_proposed)
                               if self.spec_proposed else 0.0,
            },
        }

    # ------------------------------------------------------ the scheduler

    def step(self) -> int:
        """One scheduler iteration: admit waiting requests into free
        slots (mapping any cached prefix, from HBM or a cold tier),
        propose draft tokens for the speculation lane, ensure every
        decoding request has pages for this step's tokens, run the fused
        step, retire finished requests. Returns the number of tokens
        emitted. On a multi-rank engine only the driver steps; a
        ``step()`` that raises outside the scheduler thread releases the
        followers (the scheduler thread's recovery resets them instead),
        unless the step itself raised: then they are lost."""
        self._require_driver()
        with self._sched_lock:
            try:
                self._admit()
                self._propose_drafts()
                self._ensure_blocks()
                emitted = self._run_step()
            except BaseException:
                if threading.current_thread() is not self._thread:
                    self._release_quietly()
                raise
            self._publish_metrics()
            return emitted

    def _release_quietly(self) -> None:
        """Release the followers on the way out of an error, which stays
        the error raised."""
        try:
            self._release_followers()
        except Exception:  # noqa: BLE001 — the first error is the one
            log.exception("releasing the followers failed")

    def _propose_drafts(self) -> None:
        """Fill the per-lane draft buffers from each running request's
        n-gram index, clamped so speculation can never out-emit the
        request's remaining token budget (each step emits at most
        draft_len + 1 tokens; the last budgeted token must come from a
        verified sample, so a lane with 1 token left proposes none)."""
        if self.spec_k == 0:
            return
        self._draft_lens[:] = 0
        for slot, req in enumerate(self._slots):
            if req is None or req._prefill_pos is not None or \
                    not self._active[slot]:
                continue
            budget = min(self.spec_k,
                         req.sampling.max_new_tokens
                         - len(req.out_tokens) - 1)
            if budget <= 0:
                continue
            toks = req._proposer.propose(budget)
            if toks:
                self._draft_tokens[slot, :len(toks)] = toks
                self._draft_lens[slot] = len(toks)

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
            nodes = []
            cold = []
            limit = 0
            if self.prefix_cache is not None:
                # cap the match below the full context: the last token
                # must always be prefilled so its logits exist to
                # sample the first output token from
                limit = (len(ctx) - 1) // self.block_size
                nodes = self.prefix_cache.match_nodes(ctx)[:limit]
                if nodes:
                    shared = [n.block for n in nodes]
                    # pin before any eviction this admission might do
                    self.pool.incref(shared)
            need = -(-(len(ctx) + 1) // self.block_size) - len(shared)
            private = self._try_alloc(need)
            if private is None:
                # running requests outrank waiting ones: wait for
                # retirements to return pages (the cold walk has not run
                # yet, so a saturated pool reads no cold tier)
                if shared:
                    self.pool.decref(shared)
                return
            if self.prefix_cache is not None:
                # a radix miss consults host RAM, then the DFS store, for
                # the next chunks of the chain — only the still-uncached
                # tail falls back to prefill; the matched node's digest
                # seeds the walk
                cold = self.kvstore.fetch_cold(
                    ctx, len(nodes), limit, parent_ctx=req.trace_ctx,
                    start_digest=nodes[-1].digest if nodes else None)
            with self._cond:
                self._pending.popleft()
            if cold:
                # cold payloads land in the first of the freshly
                # allocated pages (ref 1, owned by this request) and
                # re-register in the radix so siblings share them from
                # HBM; an eviction above could only have taken OTHER
                # zero-ref pages — the shared span is pinned
                cold_pages = private[:len(cold)]
                for page, hit in zip(cold_pages, cold):
                    self._inject_block(page, hit.k, hit.v)
                span = shared + cold_pages
                self.prefix_cache.insert(
                    ctx[:len(span) * self.block_size], span)
                self.kvstore.mark_promoted(cold, cold_pages)
            self.kvstore.note_match(nodes, parent_ctx=req.trace_ctx,
                                    count=req.preemptions == 0)
            reused = (len(shared) + len(cold)) * self.block_size
            req.prefix_tokens_reused = reused
            if req.preemptions == 0:
                # hit-rate counts cross-request reuse only
                self.prefix_tokens_seen += len(ctx)
                self.prefix_tokens_matched += reused
                if self.metrics and reused:
                    self.metrics.prefix_tokens_reused.incr(reused)
            self._place(req, slot, shared + private, ctx,
                        len(shared) + len(cold))

    def _try_alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages, evicting LRU zero-ref cached blocks to
        make room before giving up (cold cache yields to live work).
        Victims demote to the host-RAM ring on their way out (the
        ``on_evict`` hook copies the payload while the page is still
        valid)."""
        if n <= 0:
            return []
        got = self.pool.alloc(n)
        if got is not None or self.prefix_cache is None:
            return got
        evicted = self.prefix_cache.evict(n - self.pool.num_free,
                                          self.pool.refcount,
                                          on_evict=self.kvstore.demote)
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
        req._shared_blocks = shared_blocks
        req._ctx = ctx
        req._prefill_pos = shared_blocks * self.block_size
        req._admit_seq = next(self._admit_counter)
        if self.spec_k:
            req._proposer = NgramProposer(ctx, max_n=self.spec_ngram)
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
        preempting the youngest request when everything is dry. Draft
        rows scatter K/V too, so a speculating lane best-effort
        allocates through its furthest draft position — and on a dry
        pool the drafts are CLAMPED to the owned pages rather than
        evicting or preempting anything: speculation degrades first."""
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
            lens = int(self._draft_lens[slot]) if self.spec_k else 0
            if req._slot is None or not lens:
                continue
            want = (int(self._seq_lens[slot]) + lens) \
                // self.block_size + 1
            while len(req._blocks) < want:
                # pool.alloc, NOT _try_alloc: a possibly-rejected draft
                # page must never evict a cached prefix
                got = self.pool.alloc(1)
                if got is None:
                    break
                self._append_block(slot, req, got[0])
            self._draft_lens[slot] = min(
                lens, len(req._blocks) * self.block_size
                - int(self._seq_lens[slot]) - 1)

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
        place: the captured graphs go on reading the same tensors. The
        followers do the same (a command)."""
        if self._channel is not None and not self._released:
            self._command(_RESET)
        self._reset_local()

    def _reset_local(self) -> None:
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
        req._shared_blocks = 0
        req._ctx = []
        req._prefill_pos = None
        req._slot = None
        self._slots[slot] = None
        self._active[slot] = False
        self._seq_lens[slot] = 0
        self._tables[slot] = 0
        self._last_tokens[slot] = 0
        self._draft_lens[slot] = 0     # stale drafts must not dispatch
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
        B, G = self.max_batch, self.spec_k + 1
        proposed = int(self._draft_lens.sum())
        if proposed:
            # the step's only draft upload: tokens and lengths at once
            self._spec_in.copy_(torch.from_numpy(np.concatenate(
                [self._draft_tokens, self._draft_lens[:, None]], axis=1)))
            self.spec_uploads += 1
        elif self.spec_k:
            self._spec_in.zero_()           # on the device: no upload
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
            B * G + self.prefill_chunk if fused else B * G)
        # the ONE device→host read of the step: [B, G+3] =
        # tokens | emit count | finished | accept length
        flat = self._launch_step(fused).cpu().numpy()
        packed = flat[:B * (G + 3)].reshape(B, G + 3)
        self.steps += 1
        self._chunk_fill = n_valid
        emitted = 0
        self.occupancy_log.append(self.num_active)
        if len(self.occupancy_log) > 100_000:
            del self.occupancy_log[:50_000]
        accepted = 0
        spec_parent = None
        step_exemplar = None   # any sampled request names this step
        for slot, req in enumerate(self._slots):
            if req is None or not self._active[slot]:
                continue
            if step_exemplar is None and req.trace_ctx is not None \
                    and req.trace_ctx.sampled:
                step_exemplar = req.trace_ctx.trace_id
            n = int(packed[slot, G])
            if n <= 0:
                continue
            toks = packed[slot, :n]
            if self.spec_k:
                # the verifier's accept count, not the delivered n-1: a
                # stop-token or budget clamp truncates the burst but must
                # not read as the proposer guessing wrong
                acc = int(packed[slot, G + 2])
                accepted += acc
                if self._draft_lens[slot]:
                    if self.metrics:
                        self.metrics.spec_accept_len.add(acc)
                    if spec_parent is None:
                        spec_parent = req.trace_ctx
            # mirrors advance with the device state
            self._seq_lens[slot] += n
            self._last_tokens[slot] = int(toks[-1])
            emitted += self._deliver_burst(req, toks)
            if packed[slot, G + 1] or self._exhausted(req):
                self._release_slot(req)
                self._finish_request(req, FINISHED)
        if proposed:
            self.spec_proposed += proposed
            self.spec_accepted += accepted
            if self.metrics:
                self.metrics.spec_proposed.incr(proposed)
                if accepted:
                    self.metrics.spec_accepted.incr(accepted)
            # joins a speculating request's trace (a root span per step
            # would flood the collector with one-span traces)
            ssp = self.tracer.span("serving.speculate", parent=spec_parent)
            ssp.add_kv("proposed", str(proposed))
            ssp.add_kv("accepted", str(accepted))
            ssp.finish()
        if pre is not None:
            pre._prefill_pos += n_valid
            if pre._prefill_pos >= len(pre._ctx):
                # the chunk's last valid row sat at the final context
                # position — its sample is the first output token
                self._finish_prefill(pre, int(flat[B * (G + 3)]))
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
        """Deliver a step's accepted tokens in order, never past
        ``max_new_tokens`` and nothing past a ``stop_token`` hit (the
        step already truncates; this is the host's check on it)."""
        sp = req.sampling
        n = 0
        for t in toks:
            if len(req.out_tokens) >= sp.max_new_tokens:
                break
            tok = int(t)
            req._deliver(tok)
            if req._proposer is not None:
                req._proposer.append(tok)
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
        if req._proposer is not None:
            req._proposer.append(tok)
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
        self._require_driver()
        self._stop.clear()
        self._thread = threading.Thread(target=self._run_loop,
                                        name="decode-engine", daemon=True)
        self._thread.start()

    def stop(self, drain: bool = False, timeout: float = 30.0) -> None:
        """``drain=True``: keep decoding until every queued and running
        request completes, then (with ``drain_persist`` and a DFS tier)
        persist every resident cached prefix to the store, so another
        replica maps them instead of prefilling; then stop. Requests
        still in flight after that fail with "engine stopped"."""
        if drain and self._thread is not None:
            deadline = time.monotonic() + timeout
            with self._cond:
                while not self.idle:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            if self.drain_persist and self.kvstore.dfs_enabled:
                self.persist_cache(
                    timeout=max(1.0, deadline - time.monotonic()))
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
            if locked:
                # a step still running holds the lock: its collectives
                # and the stop message must not interleave
                self._release_followers()
        finally:
            if locked:
                self._sched_lock.release()
        if self._relaxed_longctx is not None:
            # the drain above waited for the plane through `idle`; this
            # stops its worker and fails anything queued
            self._relaxed_longctx.stop(drain=drain, timeout=timeout)
        self.kvstore.close()

    def persist_cache(self, timeout: float = 30.0) -> int:
        """Force-persist every resident cached block (HBM radix + host
        ring) to the DFS tier and wait for durability — the drain half
        of affinity-aware scale-in. Returns the number of blocks
        enqueued; best-effort on timeout (whatever went durable is
        durable, the rest is recomputable)."""
        if not self.kvstore.dfs_enabled:
            return 0
        with self._sched_lock:
            n = self.kvstore.persist_resident()
            watermark = self.kvstore.persists_enqueued
        if n and not self.kvstore.flush(timeout, up_to=watermark):
            log.warning("drain persist did not finish in %.1fs "
                        "(%d blocks enqueued)", timeout, n)
        return n

    # ------------------------------------------------ disaggregation face

    def prefill_to_store(self, prompt: List[int],
                         timeout: float = 60.0) -> int:
        """Prefill ``prompt`` and force-persist its full-block KV span to
        the DFS tier — the prefill half of prefill/decode disaggregation:
        the decode replica's admission maps the span back and prefills
        only the tail. Returns the number of tokens durable on return,
        re-verified against the radix after the flush, so a refused write
        is never reported as a persisted handoff. Raises ``ValueError``
        without a DFS tier and ``RuntimeError`` when nothing went
        durable."""
        if not self.kvstore.dfs_enabled:
            raise ValueError("DFS KV tier disabled (set "
                             "serving.kv.dfs.enable for prefill-role "
                             "replicas)")
        if self._relaxed_longctx is not None and \
                len(prompt) >= self._relaxed_longctx.min_tokens:
            # a long handoff: CP prefill + streamed tier ingest; the radix
            # never sees these blocks, so the radix-walking persist below
            # would report 0 durable tokens for a chain that is durable
            return self._relaxed_longctx.prefill_to_store(prompt, timeout)
        req = self.submit(prompt, SamplingParams(max_new_tokens=1))
        if self._thread is None:
            # offline/test mode: no scheduler thread, drive it here
            deadline = time.monotonic() + timeout
            while not req.done.is_set():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"prefill {req.id} not done")
                self.step()
        req.wait(timeout)
        with self._sched_lock:
            blocks = self.kvstore.persist_prefix(prompt,
                                                 parent_ctx=req.trace_ctx)
            # flush to THIS handoff's watermark, not the queue's tail
            watermark = self.kvstore.persists_enqueued
        if not self.kvstore.flush(timeout, up_to=watermark):
            raise TimeoutError("DFS KV persist did not drain in "
                               f"{timeout}s")
        with self._sched_lock:
            durable = self.kvstore.persisted_span(prompt)
        if blocks and not durable:
            raise RuntimeError(
                f"handoff persist failed: 0/{blocks} blocks durable")
        return durable * self.block_size

    def _run_loop(self) -> None:
        while not self._stop.is_set():
            with self._cond:
                # _local_idle, not idle: a busy long-context plane must
                # not spin the fused step
                while self._local_idle and not self._stop.is_set():
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
                    # the requests this failure fails: those in the slots
                    # and those pending now, taken BEFORE any is finished.
                    # A client that a FAILED wakes may submit at once;
                    # its request joined no failed step and waits for the
                    # next loop iteration (the contract the reference's
                    # comment states; its drain fails it instead)
                    doomed = []
                    with self._cond:
                        while self._pending:
                            doomed.append(self._pending.popleft())
                    # the failed step may have left the pools and lane
                    # state half written: rebuild them before the
                    # release path writes lane-clear events
                    self._reset_device_state()
                    for req in [r for r in self._slots if r]:
                        self._release_slot(req)
                        self._finish_request(req, FAILED,
                                             f"decode failed: {e}")
                    # the radix indexed pages that died with the pools:
                    # purge it without demotion (the bytes are gone; the
                    # host/DFS copies are digest-keyed and survive)
                    if self.prefix_cache is not None:
                        self.pool.free(self.prefix_cache.evict(
                            len(self.prefix_cache), self.pool.refcount))
                    for req in doomed:
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
