"""Causal (grouped-query) attention.

The plain path is a float32 einsum-softmax in PyTorch. On a CUDA tensor
whose shapes ``flash.supported`` accepts, ``causal_attention`` calls the
fused flash kernel (``hadoop_tpu_torch.ops.flash``) instead. This
mirrors the reference's TPU branch (``hadoop_tpu/ops/attention.py``,
the ``jax.default_backend()`` test) on the CUDA backend; note that the
reference excludes ``"gpu"`` there, so on a GPU the JAX package never
reaches its kernel. Both paths are differentiable: the flash path
through ``flash.FlashAttention``, whose backward is the two backward
kernels.

``chunk_attention`` and ``merge_attention`` (the ring-attention
partials) come with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from hadoop_tpu_torch.ops import flash

_NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """Expand KV heads for grouped-query attention: [B,S,Hkv,D] -> [B,S,Hkv*n,D]."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     q_offset: Union[int, torch.Tensor] = 0,
                     kv_offset: Union[int, torch.Tensor] = 0,
                     impl: str = "auto") -> torch.Tensor:
    """Causal self-attention.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] with Hq a multiple of Hkv
    (grouped-query). ``q_offset``/``kv_offset`` are absolute positions of
    the first query/key token. Returns [B, Sq, Hq, D].

    ``impl``: "auto" takes the flash kernel for CUDA tensors whose shapes
    qualify and the plain path otherwise; "flash"/"ref" force.
    """
    if impl not in ("auto", "flash", "ref"):
        raise ValueError(f"impl={impl!r} (choices: auto, flash, ref)")
    if impl == "flash":
        if not flash.supported(q.shape, k.shape, q_offset, kv_offset):
            raise ValueError(
                "impl='flash' forced but the fused kernel does not "
                f"support q={tuple(q.shape)} k={tuple(k.shape)} "
                f"q_offset={q_offset} kv_offset={kv_offset} "
                "(offsets must be static 0)")
        return flash.flash_attention(q, k, v, scale)
    if impl == "auto" and q.is_cuda and \
            flash.supported(q.shape, k.shape, q_offset, kv_offset):
        return flash.flash_attention(q, k, v, scale)
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = q_offset + torch.arange(sq, device=q.device)
    kpos = kv_offset + torch.arange(skv, device=q.device)
    mask = qpos[:, None] >= kpos[None, :]
    logits = logits.masked_fill(~mask, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
