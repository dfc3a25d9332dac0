"""Functional decoder-only transformer core.

The counterpart of ``hadoop_tpu/models/decoder.py``: the same
layer-stacked parameter tree (every per-layer weight one tensor with a
leading ``n_layers`` dim), here a plain dict of tensors walked by a
Python loop. Families llama, gpt2 and mixtral (MoE, ``models/moe.py``).
``ParallelCtx`` carries the context-parallel ring and the relaxed tier's
quantized weights: under a ring ctx the activations are ``[R*B, S_local,
...]`` with rank r's sequence shard on rows r*B..(r+1)*B-1 (all ranks on
one device, ``parallel/ring_attention.py``), RoPE and learned positions
take each rank's absolute offset, attention is ring attention, and a MoE
layer routes each rank's tokens on their own, as each rank of the
reference's ``shard_map`` does. With ``relaxed_qweights`` a matmul whose
leaf is a weight-plane qtensor (``serving/weightplane.py``) runs through
``qdot``, and a quantized embedding through ``qrows``. Tensor and expert
parallelism come with multi-GPU parallelism (ROADMAP Queue A 6).

Attention goes through ``ops.attention.causal_attention``, which takes
the flash kernel on a CUDA device for shapes it supports; ``attn_impl``
forces either path ("flash" or "ref") so a run can compare the two.
``remat`` recomputes layers in the backward, as the reference's
``jax.checkpoint`` modes do.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from hadoop_tpu_torch.device import check_on, resolve_device
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.moe import moe_mlp
from hadoop_tpu_torch.ops import (apply_rope, causal_attention, gelu,
                                  layer_norm, rms_norm, rope_frequencies,
                                  swiglu)
from hadoop_tpu_torch.serving.weightplane import is_qtensor, qdot, qrows


@dataclasses.dataclass(frozen=True)
class ParallelCtx:
    """The context-parallel ring the current run is under (None =
    single device), and whether quantized weights may be contracted.
    The tensor, expert and wire-codec fields come with multi-GPU
    parallelism (ROADMAP Queue A 6), and naming one is a TypeError.

    ring:      name of the context-parallel axis (the reference's
        ``ring_axis``), e.g. "sp".
    ring_size: ranks on the ring.
    sp_mode:   "ring" only; "ulysses" needs an all-to-all and comes with
        multi-GPU parallelism (ROADMAP Queue A 6).
    relaxed_qweights: the relaxed tier's opt-in (``serving.parity``):
        matmul leaves that are weight-plane qtensors route through the
        dequantizing matmul. False (the bitwise tier): a qtensor leaf
        fails at its first use.
    """
    ring: Optional[str] = None
    ring_size: int = 1
    sp_mode: str = "ring"
    relaxed_qweights: bool = False

    def __post_init__(self):
        if self.sp_mode != "ring":
            raise NotImplementedError(
                f"sp_mode={self.sp_mode!r}: only ring attention is ported "
                f"(ulysses: ROADMAP Queue A 6)")
        if self.ring_size < 1 or (self.ring is None and self.ring_size != 1):
            raise ValueError(f"ring={self.ring!r}, ring_size={self.ring_size}")


SINGLE = ParallelCtx()


def _ring_positions(ctx: ParallelCtx, seq: int, device) -> torch.Tensor:
    """Absolute positions [R, S_local] of each rank's shard:
    ``rank * S_local + arange(S_local)``."""
    rank = torch.arange(ctx.ring_size, device=device)[:, None]
    return rank * seq + torch.arange(seq, device=device)


# ----------------------------------------------------------------- params

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Initialize the full parameter tree on ``device`` (default: the
    GPU) from ``generator``, which must live on the same device type.
    Leaf names, shapes and fan-in scaling follow the JAX package."""
    dev = resolve_device(device)
    dt = cfg.torch_dtype
    D, L, F, V = cfg.d_model, cfg.n_layers, cfg.d_ff, cfg.vocab_size
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def winit(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=dev)
        return (w * fan_in ** -0.5).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    layers: Dict[str, torch.Tensor] = {
        "attn_norm_w": ones(L, D),
        "wq": winit((L, D, Hq * Dh), D),
        "wk": winit((L, D, Hkv * Dh), D),
        "wv": winit((L, D, Hkv * Dh), D),
        "wo": winit((L, Hq * Dh, D), Hq * Dh),
        "mlp_norm_w": ones(L, D),
    }
    if not cfg.use_rmsnorm:
        layers["attn_norm_b"] = zeros(L, D)
        layers["mlp_norm_b"] = zeros(L, D)
    if cfg.is_moe:
        E = cfg.n_experts
        layers["router"] = winit((L, D, E), D)
        layers["w_gate"] = winit((L, E, D, F), D)
        layers["w_up"] = winit((L, E, D, F), D)
        layers["w_down"] = winit((L, E, F, D), F)
    elif cfg.use_swiglu:
        layers["w_gate"] = winit((L, D, F), D)
        layers["w_up"] = winit((L, D, F), D)
        layers["w_down"] = winit((L, F, D), F)
    else:
        layers["w_in"] = winit((L, D, F), D)
        layers["b_in"] = zeros(L, F)
        layers["w_out"] = winit((L, F, D), F)
        layers["b_out"] = zeros(L, D)

    params: Dict[str, Any] = {
        "embed": winit((V, D), D),
        "layers": layers,
        "final_norm_w": ones(D),
    }
    if not cfg.use_rmsnorm:
        params["final_norm_b"] = zeros(D)
    if not cfg.use_rope:
        params["pos_embed"] = winit((cfg.max_seq, D), D)
    if not cfg.tie_embeddings:
        params["lm_head"] = winit((D, V), D)
    return params


# ------------------------------------------------------------------ blocks

def _norm(x, w, b, cfg: ModelConfig):
    if cfg.use_rmsnorm:
        return rms_norm(x, w, cfg.norm_eps)
    return layer_norm(x, w, b, cfg.norm_eps)


def _relaxed_qready(w, ctx: ParallelCtx) -> bool:
    """Does this matmul take the weight plane's dequantizing route? Only
    when the run opted in and the leaf is a qtensor."""
    return ctx.relaxed_qweights and is_qtensor(w)


def _dot(h, w, ctx: ParallelCtx):
    """``h @ w``, or ``qdot`` for a qtensor under the relaxed tier."""
    return qdot(h, w) if _relaxed_qready(w, ctx) else h @ w


def _attention_block(x, lp, cfg: ModelConfig, cos, sin,
                     attn_impl: str = "auto", ctx: ParallelCtx = SINGLE,
                     return_kv: bool = False):
    """Pre-norm attention with residual. x: [B, S, D] ([R*B, S_local, D]
    under a ring ctx). ``return_kv=True`` also returns this layer's
    post-RoPE ``(k, v)`` [B, S, Hkv, Dh], the rows the long-context
    prefill streams out."""
    resid = x
    h = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg)
    B, S, _ = h.shape
    q = _dot(h, lp["wq"], ctx).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = _dot(h, lp["wk"], ctx).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = _dot(h, lp["wv"], ctx).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        positions = None if ctx.ring is None else \
            _ring_positions(ctx, S, h.device)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    if ctx.ring is not None:
        from hadoop_tpu_torch.parallel.ring_attention import ring_attention
        attn = ring_attention(q, k, v, ctx.ring_size, impl=attn_impl)
    else:
        attn = causal_attention(q, k, v, impl=attn_impl)
    out = _dot(attn.reshape(B, S, cfg.n_heads * cfg.head_dim), lp["wo"],
               ctx)
    y = resid + out.to(resid.dtype)
    return (y, (k, v)) if return_kv else y


def _mlp_block(x, lp, cfg: ModelConfig, ctx: ParallelCtx = SINGLE):
    resid = x
    h = _norm(x, lp["mlp_norm_w"], lp.get("mlp_norm_b"), cfg)
    if cfg.is_moe:
        if ctx.ring is None:
            out = moe_mlp(h, lp, cfg)
        else:
            # each rank routes its own B*S_local tokens, at the capacity
            # of that count, never the folded batch's
            out = torch.cat([moe_mlp(hr, lp, cfg)
                             for hr in h.chunk(ctx.ring_size, dim=0)])
    elif cfg.use_swiglu:
        out = _dot(swiglu(_dot(h, lp["w_gate"], ctx),
                          _dot(h, lp["w_up"], ctx)), lp["w_down"], ctx)
    else:
        out = _dot(gelu(_dot(h, lp["w_in"], ctx) + lp["b_in"]), lp["w_out"],
                   ctx) + lp["b_out"]
    return resid + out.to(resid.dtype)


def layer_forward(x, lp, cfg: ModelConfig, cos, sin,
                  attn_impl: str = "auto"):
    """One transformer block. lp: this layer's weights (no leading L dim)."""
    x = _attention_block(x, lp, cfg, cos, sin, attn_impl)
    return _mlp_block(x, lp, cfg)


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
               attn_impl: str = "auto", remat=False):
    """Run the stacked layers over x, one layer slice at a time."""
    body = _layer_fn(remat)
    for lp in layer_slices(layers, cfg.n_layers):
        x = body(x, lp, cfg, cos, sin, attn_impl)
    return x


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
    ([R*B, S_local] under a ring ctx, each rank's positions offset)."""
    if _relaxed_qready(params["embed"], ctx):
        h = qrows(params["embed"], tokens, cfg.torch_dtype)
    else:
        h = params["embed"][tokens]
    if not cfg.use_rope:
        seq = tokens.shape[1]
        if ctx.ring is None:
            return h + params["pos_embed"][:seq][None]
        pos = params["pos_embed"][_ring_positions(ctx, seq, tokens.device)]
        h = h + pos.repeat_interleave(tokens.shape[0] // ctx.ring_size,
                                      dim=0)
    return h


def final_hidden(params, h, cfg: ModelConfig):
    """Final norm: the hidden states the LM head consumes."""
    return _norm(h, params["final_norm_w"], params.get("final_norm_b"), cfg)


def head_matrix(params, cfg: ModelConfig, dtype=None):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(dtype) if dtype is not None else head


def lm_logits(params, h, cfg: ModelConfig):
    """Final norm + LM head."""
    h = final_hidden(params, h, cfg)
    return h @ head_matrix(params, cfg, h.dtype)


# ---------------------------------------------------------------- forward

def forward_hidden(params, tokens, cfg: ModelConfig,
                   attn_impl: str = "auto", remat=False):
    """Embed + layer stack (everything before the LM head)."""
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=params["embed"].device)
    h = embed_tokens(params, tokens, cfg)
    return run_layers(h, params["layers"], cfg, cos, sin, attn_impl, remat)


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
