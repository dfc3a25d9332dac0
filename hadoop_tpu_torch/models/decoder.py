"""Functional decoder-only transformer core.

The counterpart of ``hadoop_tpu/models/decoder.py``: the same
layer-stacked parameter tree (every per-layer weight one tensor with a
leading ``n_layers`` dim), here a plain dict of tensors walked by a
Python loop. Families llama, gpt2 and mixtral (MoE, ``models/moe.py``).
``ParallelCtx`` carries the axes the run is under (``parallel/spmd.py``)
and the relaxed tier's quantized weights. Under a context-parallel ctx
each rank holds a sequence shard, RoPE and learned positions take each
rank's absolute offset, and attention is ring attention or Ulysses
(``ctx.sp_mode``); on a folded ring (all ranks on one device) the
activations are ``[R*B, S_local, ...]`` with rank r's shard on rows
r*B..(r+1)*B-1, and a MoE layer routes each rank's tokens on their own,
as each rank of the reference's ``shard_map`` does. Under a tp axis (a
process group, one rank per process) the weights are this rank's
shards: column-parallel q/k/v and gate/up, row-parallel out and down
projections reduced by ``ops/collective_matmul.py``, a vocab-parallel
embedding and head; with ``megatron_sp`` the activations between blocks
are sequence shards, gathered before each block and reduce-scattered
after it. Where the reference's vma tracking inserts the gradient sum
of a value every tp rank holds, here ``spmd.copy_to`` does. With
``relaxed_qweights`` a matmul whose leaf is a weight-plane qtensor
(``serving/weightplane.py``) runs through ``qdot``, and a quantized
embedding through ``qrows``. A MoE layer under an ``ep`` axis exchanges
its expert batches with ``all_to_all`` (``models/moe.py``); under tp its
experts' d_ff is sharded and its output is a partial sum that the
row-parallel reduce completes, as the dense down-projection's.

Attention goes through ``ops.attention.causal_attention``, which takes
the flash kernel on a CUDA device for shapes it supports; ``attn_impl``
forces either path ("flash" or "ref") so a run can compare the two.
``remat`` recomputes layers in the backward, as the reference's
``jax.checkpoint`` modes do.

Under the relaxed parity tier (``parallel/lowp``) the ctx also names the
tp reduce's wire codec, the chunked tp matmul and the per-layer sync
schedule (``relaxed_sync``, resolved by ``lowp/syncpolicy.py``): each
block then takes its layer's ``SiteSync`` pair, and ``run_layers`` with
``sync_state`` threads the stale layers' corrections through the step
(``[n_stale, 2, *x.shape]`` in, the same out).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from hadoop_tpu_torch.device import check_on, resolve_device
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.moe import moe_mlp
from hadoop_tpu_torch.ops import (apply_rope, causal_attention, gelu,
                                  layer_norm, rms_norm, rope_frequencies,
                                  swiglu)
from hadoop_tpu_torch.ops.collective_matmul import (reduce_row_parallel,
                                                    row_parallel_project)
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel import ring_attention as ring_module
from hadoop_tpu_torch.parallel.ulysses import ulysses_attention
from hadoop_tpu_torch.serving.weightplane import is_qtensor, qdot, qrows


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The axes the current run is under (None = single device), whether
    quantized weights may be contracted, and the relaxed tier's knobs.

    ring:      name of the context-parallel axis (the reference's
        ``ring_axis``), e.g. "sp".
    ring_size: ranks on it.
    ring_group: the axis as a process group (``spmd.Axis``); None: the
        ranks are folded into the batch on one device.
    sp_mode:   "ring" or "ulysses" (``parallel/ulysses.py``).
    tp:        the tensor-parallel axis, a process group (``spmd.Axis``).
    megatron_sp: sequence parallelism on the tp axis.
    ep:        the expert-parallel axis, a process group (``spmd.Axis``):
        MoE layers hold its rank's experts.
    relaxed_qweights: the relaxed tier's opt-in (``serving.parity``):
        matmul leaves that are weight-plane qtensors route through the
        dequantizing matmul. False (the bitwise tier): a qtensor leaf
        fails at its first use.
    tp_overlap_chunks: the chunks of a relaxed tp reduce (1 without tp).
    relaxed_codec: the relaxed tier's tp reduce wire ("int8", "fp8"),
        None: the exact reduce.
    relaxed_chunk_matmul: the relaxed tier's chunked tp matmul.
    relaxed_sync: the per-layer sync modes ("sync", "skip", "stale"),
        None: every layer syncs. All three are None/False without tp.
    """
    ring: Optional[str] = None
    ring_size: int = 1
    sp_mode: str = "ring"
    relaxed_qweights: bool = False
    ring_group: Optional[spmd.Axis] = None
    tp: Optional[spmd.Axis] = None
    megatron_sp: bool = False
    ep: Optional[spmd.Axis] = None
    tp_overlap_chunks: int = 1
    relaxed_codec: Optional[str] = None
    relaxed_chunk_matmul: bool = False
    relaxed_sync: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"sp_mode={self.sp_mode!r} (ring | ulysses)")
        if self.ring_size < 1 or (self.ring is None and self.ring_size != 1):
            raise ValueError(f"ring={self.ring!r}, ring_size={self.ring_size}")
        if self.ring_group is not None and (
                self.ring != self.ring_group.name or
                self.ring_size != self.ring_group.size):
            raise ValueError(f"ring {self.ring!r}/{self.ring_size} is not "
                             f"its group {self.ring_group}")
        if self.megatron_sp and self.tp is None:
            raise ValueError("megatron_sp needs a tp axis")
        for name in ("tp", "ep"):
            axis = getattr(self, name)
            if axis is not None and axis.folded:
                raise ValueError(f"{name} {axis}: needs a process group")

    @property
    def ring_axis(self) -> Optional[spmd.Axis]:
        """The context-parallel axis: its group, or the folded ranks."""
        if self.ring is None:
            return None
        return self.ring_group or spmd.folded(self.ring, self.ring_size)

    @property
    def tp_size(self) -> int:
        return 1 if self.tp is None else self.tp.size


SINGLE = ParallelCtx()


def _ring_positions(ctx: ParallelCtx, seq: int, device) -> torch.Tensor:
    """Absolute positions [R, S_local] of the shards of the ring ranks
    this process holds (all R of a folded ring, its own of a group):
    ``rank * S_local + arange(S_local)``."""
    rank = spmd.local_ranks(ctx.ring_axis, device)[:, None]
    return rank * seq + torch.arange(seq, device=device)


def _tp_enter(h: torch.Tensor, ctx: ParallelCtx) -> torch.Tensor:
    """A block's normed input where it meets the tp-sharded weights: the
    whole sequence gathered under Megatron-SP (whose backward
    reduce-scatters), else marked with ``copy_to`` so its gradient sums
    every tp rank's part."""
    if ctx.megatron_sp:
        return spmd.all_gather(h, ctx.tp, 1)
    return spmd.copy_to(h, ctx.tp)


# ----------------------------------------------------------------- params

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, keep: Optional[Callable[
                    [Tuple[str, ...], torch.Tensor], torch.Tensor]] = None
                ) -> Dict[str, Any]:
    """Initialize the full parameter tree on ``device`` (default: the
    GPU) from ``generator``, which must live on the same device type.
    Leaf names, shapes and fan-in scaling follow the JAX package.

    ``keep(path, leaf)``, e.g. ``(("layers", "wq"), tensor)``, runs on
    each leaf as it is drawn and the tree holds what it returns: a
    rank's shard, so that no more than one full leaf is ever held (the
    draws, and so the values, are the same)."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    D, L, F, V = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    where: Tuple[str, ...] = ()

    def put(name, t):
        return keep(where + (name,), t) if keep is not None else t

    def winit(name, shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return put(name, w.mul_(fan_in ** -0.5).to(dt))

    def ones(name, *shape):
        return put(name, torch.ones(shape, dtype=dt, device=dev))

    def zeros(name, *shape):
        return put(name, torch.zeros(shape, dtype=dt, device=dev))

    where = ("layers",)
    layers: Dict[str, torch.Tensor] = {
        "attn_norm_w": ones("attn_norm_w", L, D),
        "wq": winit("wq", (L, D, Hq * Dh), D),
        "wk": winit("wk", (L, D, Hkv * Dh), D),
        "wv": winit("wv", (L, D, Hkv * Dh), D),
        "wo": winit("wo", (L, Hq * Dh, D), Hq * Dh),
        "mlp_norm_w": ones("mlp_norm_w", L, D),
    }
    if not cfg.use_rmsnorm:
        layers["attn_norm_b"] = zeros("attn_norm_b", L, D)
        layers["mlp_norm_b"] = zeros("mlp_norm_b", L, D)
    if cfg.is_moe:
        E = cfg.n_experts
        layers["router"] = winit("router", (L, D, E), D)
        layers["w_gate"] = winit("w_gate", (L, E, D, F), D)
        layers["w_up"] = winit("w_up", (L, E, D, F), D)
        layers["w_down"] = winit("w_down", (L, E, F, D), F)
    elif cfg.use_swiglu:
        layers["w_gate"] = winit("w_gate", (L, D, F), D)
        layers["w_up"] = winit("w_up", (L, D, F), D)
        layers["w_down"] = winit("w_down", (L, F, D), F)
    else:
        layers["w_in"] = winit("w_in", (L, D, F), D)
        layers["b_in"] = zeros("b_in", L, F)
        layers["w_out"] = winit("w_out", (L, F, D), F)
        layers["b_out"] = zeros("b_out", L, D)

    where = ()
    params: Dict[str, Any] = {
        "embed": winit("embed", (V, D), D),
        "layers": layers,
        "final_norm_w": ones("final_norm_w", D),
    }
    if not cfg.use_rmsnorm:
        params["final_norm_b"] = zeros("final_norm_b", D)
    if not cfg.use_rope:
        params["pos_embed"] = winit("pos_embed", (cfg.max_seq, D), D)
    if not cfg.tie_embeddings:
        params["lm_head"] = winit("lm_head", (D, V), D)
    return params


# ------------------------------------------------------------------ blocks

def _norm(x, w, b, cfg: ModelConfig):
    if cfg.use_rmsnorm:
        return rms_norm(x, w, cfg.norm_eps)
    return layer_norm(x, w, b, cfg.norm_eps)


def _relaxed_qready(w, ctx: ParallelCtx) -> bool:
    """Does this matmul take the weight plane's dequantizing route? Only
    when the run opted in and the leaf is a qtensor; never under tp (a
    qtensor is the whole weight)."""
    if not (ctx.relaxed_qweights and is_qtensor(w)):
        return False
    if ctx.tp is not None:
        raise NotImplementedError(
            "quantized resident weights compose with tp-free runs only; "
            "shard the float view under tensor parallelism")
    return True


def _dot(h, w, ctx: ParallelCtx):
    """``h @ w``, or ``qdot`` for a qtensor under the relaxed tier."""
    return qdot(h, w) if _relaxed_qready(w, ctx) else h @ w


def _down(x, w, ctx: ParallelCtx, bias=None, relaxed_sync=None):
    """A row-parallel projection, ``x @ w (+ bias)``: reduced over tp
    (``ops/collective_matmul.py``) under a tp axis, in the site's
    scheduled mode (``relaxed_sync``)."""
    if ctx.tp is not None:
        return row_parallel_project(x, w, ctx, bias, relaxed_sync)
    y = _dot(x, w, ctx)
    return y if bias is None else y + bias


def _split_stale(out, relaxed_sync):
    """A reduce's output and its new stale correction (None unless the
    site's mode is stale)."""
    if relaxed_sync is not None and relaxed_sync.mode == "stale":
        return out
    return out, None


def _attention_block(x, lp, cfg: ModelConfig, cos, sin,
                     attn_impl: str = "auto", ctx: ParallelCtx = SINGLE,
                     return_kv: bool = False, relaxed_sync=None):
    """Pre-norm attention with residual. x: [B, S, D] ([R*B, S_local, D]
    under a ring ctx). ``return_kv=True`` also returns this layer's
    post-RoPE ``(k, v)`` [B, S, Hkv, Dh], the rows the long-context
    prefill streams out. ``relaxed_sync`` (a ``SiteSync``): the block
    returns ``(y, corr)``, ``corr`` the new stale correction or None."""
    resid = x
    h = _tp_enter(_norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg),
                  ctx)
    B, S, _ = h.shape
    hq, hkv = cfg.n_heads // ctx.tp_size, cfg.n_kv_heads // ctx.tp_size
    q = _dot(h, lp["wq"], ctx).reshape(B, S, hq, cfg.head_dim)
    k = _dot(h, lp["wk"], ctx).reshape(B, S, hkv, cfg.head_dim)
    v = _dot(h, lp["wv"], ctx).reshape(B, S, hkv, cfg.head_dim)
    if cfg.use_rope:
        positions = None if ctx.ring is None else \
            _ring_positions(ctx, S, h.device)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    if ctx.ring is not None and ctx.sp_mode == "ulysses":
        attn = ulysses_attention(q, k, v, ctx.ring_axis, impl=attn_impl)
    elif ctx.ring is not None:
        attn = ring_module.ring_attention(
            q, k, v, ctx.ring_group or ctx.ring_size, impl=attn_impl)
    else:
        attn = causal_attention(q, k, v, impl=attn_impl)
    out, corr = _split_stale(
        _down(attn.reshape(B, S, hq * cfg.head_dim), lp["wo"], ctx,
              relaxed_sync=relaxed_sync), relaxed_sync)
    y = resid + out.to(resid.dtype)
    if return_kv:
        return y, (k, v)
    return (y, corr) if relaxed_sync is not None else y


def _mlp_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx = SINGLE,
               relaxed_sync=None):
    resid = x
    h = _tp_enter(_norm(x, lp["mlp_norm_w"], lp.get("mlp_norm_b"), cfg),
                  ctx)
    if cfg.is_moe:
        # each rank routes its own B*S_local tokens, at the capacity of
        # that count: a folded ring holds every rank's rows; under tp the
        # result is a partial sum over the d_ff shards
        ranks = ctx.ring_size if ctx.ring_group is None else 1
        out = moe_mlp(h, lp, cfg, ctx) if ranks == 1 else torch.cat(
            [moe_mlp(hr, lp, cfg, ctx) for hr in h.chunk(ranks, dim=0)])
        out = reduce_row_parallel(out, ctx, relaxed_sync)
    elif cfg.use_swiglu:
        out = _down(swiglu(_dot(h, lp["w_gate"], ctx),
                           _dot(h, lp["w_up"], ctx)), lp["w_down"], ctx,
                    relaxed_sync=relaxed_sync)
    else:
        out = _down(gelu(_dot(h, lp["w_in"], ctx) + lp["b_in"]), lp["w_out"],
                    ctx, lp["b_out"], relaxed_sync)
    out, corr = _split_stale(out, relaxed_sync)
    y = resid + out.to(resid.dtype)
    return (y, corr) if relaxed_sync is not None else y


def layer_forward(x, lp, cfg: ModelConfig, cos, sin,
                  attn_impl: str = "auto", ctx: ParallelCtx = SINGLE,
                  relaxed_sync=None):
    """One transformer block. lp: this layer's weights (no leading L dim).
    ``relaxed_sync``: an ``(attn, mlp)`` pair of ``SiteSync``; the block
    then returns ``(x, (attn_corr, mlp_corr))``, the corrections None
    except in stale mode."""
    if relaxed_sync is None:
        x = _attention_block(x, lp, cfg, cos, sin, attn_impl, ctx)
        return _mlp_block(x, lp, cfg, ctx)
    a_sync, m_sync = relaxed_sync
    x, ca = _attention_block(x, lp, cfg, cos, sin, attn_impl, ctx,
                             relaxed_sync=a_sync)
    x, cm = _mlp_block(x, lp, cfg, ctx, relaxed_sync=m_sync)
    return x, (ca, cm)


def layer_forward_kv(x, lp, cfg: ModelConfig, cos, sin,
                     attn_impl: str = "auto", ctx: ParallelCtx = SINGLE):
    """One transformer block, also returning the layer's post-RoPE
    ``(k, v)``."""
    x, kv = _attention_block(x, lp, cfg, cos, sin, attn_impl, ctx,
                             return_kv=True)
    return _mlp_block(x, lp, cfg, ctx), kv


# matmul outputs, the ops "dots" keeps (the counterpart of JAX's
# dots_with_no_batch_dims_saveable); the flash kernel is not one of them
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default]


def _layer_fn(remat):
    """The layer body for a remat mode: False/None — save every
    activation; True/"full" — one non-reentrant checkpoint per layer,
    recomputed whole in the backward; "dots" — selective: save the matmul
    outputs, recompute the rest."""
    if not remat:
        return layer_forward
    if remat is True or remat == "full":
        return functools.partial(checkpoint, layer_forward,
                                 use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, layer_forward, use_reentrant=False,
            context_fn=functools.partial(
                create_selective_checkpoint_contexts, _DOTS))
    raise ValueError(f"remat={remat!r} (choices: False, True, 'full', "
                     f"'dots')")


def _unbind(leaf):
    """A stacked leaf's per-layer views; a qtensor's payload and scales
    unbind together (the reference's ``qslice`` pairing)."""
    if is_qtensor(leaf):
        return [{"q": q, "s": s}
                for q, s in zip(leaf["q"].unbind(0), leaf["s"].unbind(0))]
    return leaf.unbind(0)


def layer_slices(layers, n_layers: int):
    """Each layer's weights, as views of the stacked ``[L, ...]`` leaves:
    every leaf is unbound once, so the backward of a stack is one
    ``stack`` of its layers' gradients (the reference's ``lax.scan``
    writes each layer's slice once), where taking ``w[i]`` in each layer
    would add up L zero-filled full-size gradients."""
    names = list(layers)
    views = zip(*(_unbind(layers[name]) for name in names))
    slices = [dict(zip(names, ws)) for ws in views]
    if len(slices) != n_layers:
        raise ValueError(f"stacked leaves hold {len(slices)} layers, "
                         f"expected {n_layers}")
    return slices


def run_layers(x, layers, cfg: ModelConfig, cos, sin,
               attn_impl: str = "auto", remat=False,
               ctx: ParallelCtx = SINGLE, sync_state=None):
    """Run the stacked layers over x, one layer slice at a time.

    Under a sync schedule (``ctx.relaxed_sync`` with tp) each layer takes
    its mode; ``sync_state`` (needed iff the schedule has stale layers):
    ``[n_stale, 2, *x.shape]``, the previous step's corrections, one
    (attention, MLP) pair a stale layer in layer order. With
    ``sync_state`` the result is ``(out, new_sync_state)``."""
    body = _layer_fn(remat)
    sched = ctx.relaxed_sync if ctx.tp is not None else None
    if sched is not None and all(m == "sync" for m in sched):
        sched = None
    if sched is None:
        for lp in layer_slices(layers, cfg.n_layers):
            x = body(x, lp, cfg, cos, sin, attn_impl, ctx)
        return (x, sync_state) if sync_state is not None else x
    from hadoop_tpu_torch.parallel.lowp.syncpolicy import SiteSync
    slices = layer_slices(layers, cfg.n_layers)
    if len(sched) != len(slices):
        raise ValueError(
            f"sync schedule names {len(sched)} layers but this run has "
            f"{len(slices)} (per-layer schedules compose with the flat "
            f"layer stack only)")
    if "stale" in sched and sync_state is None:
        raise ValueError("stale sync schedule needs sync_state (the "
                         "previous step's corrections)")
    corrs = []
    for mode, lp in zip(sched, slices):
        if mode == "stale":
            prev = sync_state[len(corrs)]
            pair = (SiteSync("stale", prev[0]), SiteSync("stale", prev[1]))
        else:
            pair = (SiteSync(mode), SiteSync(mode))
        x, (ca, cm) = body(x, lp, cfg, cos, sin, attn_impl, ctx, pair)
        if mode == "stale":
            corrs.append(torch.stack([ca, cm]))
    if sync_state is None:
        return x
    return x, (torch.stack(corrs) if corrs else sync_state)


@torch.no_grad()
def run_layers_kv(x, layers, cfg: ModelConfig, cos, sin,
                  ctx: ParallelCtx = SINGLE, attn_impl: str = "auto"):
    """Run the stacked layers over x, collecting every layer's post-RoPE
    K/V. Returns ``(h, (k, v))`` with k/v ``[L, B, S, Hkv, Dh]``
    (``[L, R*B, S_local, Hkv, Dh]`` under a ring ctx): the prefill side
    of the long-context plane. Inference only: records no gradient."""
    ks = vs = None
    for i, lp in enumerate(layer_slices(layers, cfg.n_layers)):
        x, (k, v) = layer_forward_kv(x, lp, cfg, cos, sin, attn_impl, ctx)
        if ks is None:
            ks = k.new_empty((cfg.n_layers, *k.shape))
            vs = v.new_empty((cfg.n_layers, *v.shape))
        ks[i], vs[i] = k, v
    return x, (ks, vs)


# ------------------------------------------------------------- embeddings

def embed_tokens(params, tokens, cfg: ModelConfig,
                 ctx: ParallelCtx = SINGLE):
    """Token (+ learned position) embedding. tokens: [B, S] integer
    ([R*B, S_local] under a folded ring, each rank's positions offset).
    Vocab-parallel under tp: this rank's rows of the table, the rest
    zero, summed over tp in float32 (reduce-scattered over the sequence
    under Megatron-SP)."""
    embed = params["embed"]
    if ctx.tp is not None:
        vl = embed.shape[0]
        local_ids = tokens - spmd.axis_index(ctx.tp) * vl
        ok = (local_ids >= 0) & (local_ids < vl)
        h = torch.where(ok[..., None], embed[local_ids.clamp(0, vl - 1)],
                        0).float()
        h = (spmd.psum_scatter(h, ctx.tp, 1) if ctx.megatron_sp
             else spmd.psum(h, ctx.tp)).to(embed.dtype)
    elif _relaxed_qready(embed, ctx):
        h = qrows(embed, tokens, cfg.torch_dtype)
    else:
        h = embed[tokens]
    if not cfg.use_rope:
        seq = tokens.shape[1]
        if ctx.ring is not None:
            pos = params["pos_embed"][_ring_positions(ctx, seq,
                                                      tokens.device)]
            return h + pos.repeat_interleave(h.shape[0] // pos.shape[0],
                                             dim=0)
        if ctx.megatron_sp:
            sl = seq // ctx.tp_size
            lo = spmd.axis_index(ctx.tp) * sl
            return h + params["pos_embed"][lo:lo + sl][None]
        h = h + params["pos_embed"][:seq][None]
    return h


def final_hidden(params, h, cfg: ModelConfig, ctx: ParallelCtx = SINGLE):
    """Final norm: the hidden states the LM head consumes (the whole
    sequence again under Megatron-SP: the exit gather)."""
    return _tp_enter(_norm(h, params["final_norm_w"],
                           params.get("final_norm_b"), cfg), ctx)


def head_matrix(params, cfg: ModelConfig, dtype=None):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(dtype) if dtype is not None else head


def lm_logits(params, h, cfg: ModelConfig):
    """Final norm + LM head."""
    h = final_hidden(params, h, cfg)
    return h @ head_matrix(params, cfg, h.dtype)


# ---------------------------------------------------------------- forward

def forward_hidden(params, tokens, cfg: ModelConfig,
                   attn_impl: str = "auto", remat=False,
                   ctx: ParallelCtx = SINGLE, sync_state=None):
    """Embed + layer stack (everything before the LM head); with
    ``sync_state``, ``(h, new_sync_state)`` (``run_layers``)."""
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=params["embed"].device)
    h = embed_tokens(params, tokens, cfg, ctx)
    if sync_state is not None:
        return run_layers(h, params["layers"], cfg, cos, sin, attn_impl,
                          remat, ctx, sync_state=sync_state)
    return run_layers(h, params["layers"], cfg, cos, sin, attn_impl, remat,
                      ctx)


def forward(params, tokens, cfg: ModelConfig, *,
            device: Optional[Any] = None,
            attn_impl: str = "auto", remat=False) -> torch.Tensor:
    """Full forward to logits [B, S, V] on ``device`` (default: the GPU;
    the parameters must already lie there). ``tokens``: [B, S] integers
    as a tensor, array or nested list."""
    dev = resolve_device(device)
    check_on(params["embed"], dev, "params")
    tokens = torch.as_tensor(tokens, device=dev).long()
    h = forward_hidden(params, tokens, cfg, attn_impl, remat)
    return lm_logits(params, h, cfg)
