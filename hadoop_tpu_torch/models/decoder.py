"""Functional decoder-only transformer core, single device.

The counterpart of ``hadoop_tpu/models/decoder.py`` on its single-device
context (``SINGLE``): the same layer-stacked parameter tree (every
per-layer weight one tensor with a leading ``n_layers`` dim), here a
plain dict of tensors walked by a Python loop. Families llama and gpt2.
MoE, tensor/sequence/ring parallelism and the quantized weight seams come
in later slices.

Attention goes through ``ops.attention.causal_attention``, which takes
the flash kernel on a CUDA device for shapes it supports; ``attn_impl``
forces either path ("flash" or "ref") so a run can compare the two.
``remat`` recomputes layers in the backward, as the reference's
``jax.checkpoint`` modes do.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from hadoop_tpu_torch.device import check_on, resolve_device
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.ops import (apply_rope, causal_attention, gelu,
                                  layer_norm, rms_norm, rope_frequencies,
                                  swiglu)


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError("MoE models are not ported yet")


# ----------------------------------------------------------------- params

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Initialize the full parameter tree on ``device`` (default: the
    GPU) from ``generator``, which must live on the same device type.
    Leaf names, shapes and fan-in scaling follow the JAX package."""
    _check_dense(cfg)
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
    if cfg.use_swiglu:
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


def _attention_block(x, lp, cfg: ModelConfig, cos, sin,
                     attn_impl: str = "auto"):
    """Pre-norm attention with residual. x: [B, S, D]."""
    resid = x
    h = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"), cfg)
    B, S, _ = h.shape
    q = (h @ lp["wq"]).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    attn = causal_attention(q, k, v, impl=attn_impl)
    out = attn.reshape(B, S, cfg.n_heads * cfg.head_dim) @ lp["wo"]
    return resid + out.to(resid.dtype)


def _mlp_block(x, lp, cfg: ModelConfig):
    resid = x
    h = _norm(x, lp["mlp_norm_w"], lp.get("mlp_norm_b"), cfg)
    if cfg.use_swiglu:
        out = swiglu(h @ lp["w_gate"], h @ lp["w_up"]) @ lp["w_down"]
    else:
        out = gelu(h @ lp["w_in"] + lp["b_in"]) @ lp["w_out"] + lp["b_out"]
    return resid + out.to(resid.dtype)


def layer_forward(x, lp, cfg: ModelConfig, cos, sin,
                  attn_impl: str = "auto"):
    """One transformer block. lp: this layer's weights (no leading L dim)."""
    x = _attention_block(x, lp, cfg, cos, sin, attn_impl)
    return _mlp_block(x, lp, cfg)


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


def run_layers(x, layers, cfg: ModelConfig, cos, sin,
               attn_impl: str = "auto", remat=False):
    """Run the stacked layers over x, one layer slice at a time."""
    body = _layer_fn(remat)
    for i in range(cfg.n_layers):
        lp = {name: w[i] for name, w in layers.items()}
        x = body(x, lp, cfg, cos, sin, attn_impl)
    return x


# ------------------------------------------------------------- embeddings

def embed_tokens(params, tokens, cfg: ModelConfig):
    """Token (+ learned position) embedding. tokens: [B, S] integer."""
    h = params["embed"][tokens]
    if not cfg.use_rope:
        h = h + params["pos_embed"][:tokens.shape[1]][None]
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
    _check_dense(cfg)
    dev = resolve_device(device)
    check_on(params["embed"], dev, "params")
    tokens = torch.as_tensor(tokens, device=dev).long()
    h = forward_hidden(params, tokens, cfg, attn_impl, remat)
    return lm_logits(params, h, cfg)
