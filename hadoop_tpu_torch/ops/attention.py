"""Causal (grouped-query) attention.

The plain path is a float32 einsum-softmax in PyTorch. On a CUDA tensor
whose shapes ``flash.supported`` accepts, and whose dtype and head dim
the kernels were built for (``flash.kernel_built``), ``causal_attention``
calls the fused flash kernel (``hadoop_tpu_torch.ops.flash``) instead. This
mirrors the reference's TPU branch (``hadoop_tpu/ops/attention.py``,
the ``jax.default_backend()`` test) on the CUDA backend; note that the
reference excludes ``"gpu"`` there, so on a GPU the JAX package never
reaches its kernel. Both paths are differentiable: the flash path
through ``flash.FlashAttention``, whose backward is the two backward
kernels.

Ring attention (``hadoop_tpu_torch.parallel.ring_attention``) builds
on ``chunk_attention`` + ``merge_attention``: each partial result is the
chunk-normalised output plus its per-row log-sum-exp, and two partials
merge by log-add-exp weighting. A row with no visible key has lse -inf,
the merge's identity.
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


def _kernel_takes(q, k, v) -> bool:
    """Whether a flash kernel was built for q's dtype and head dim, with
    k and v of the same dtype: "auto" asks this beside the reference's
    shape predicates, which accept any dtype and any D % 64 == 0."""
    return (k.dtype == q.dtype == v.dtype
            and flash.kernel_built(q.dtype, q.shape[-1]))


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
    qualify (``flash.supported``) and whose dtype and head dim it was
    built for (``flash.kernel_built``), and the plain path otherwise;
    "flash"/"ref" force ("flash" raises on what the kernel does not
    take).
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
    if impl == "auto" and q.is_cuda and _kernel_takes(q, k, v) and \
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


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, q_positions: torch.Tensor,
                    kv_positions: torch.Tensor):
    """Attention of q against one K/V chunk, as an online-softmax partial.

    Shapes: q [B,Sq,H,D]; k,v [B,Sk,H,D] (KV heads already expanded);
    positions [Sq] and [Sk], or [B,Sq] and [B,Sk] for positions per
    batch row (ring ranks folded into the batch). Returns (out
    [B,Sq,H,D] float32, normalised within this chunk; lse [B,Sq,H]
    float32, the log-sum-exp of the visible logits: -inf rows, i.e. rows
    with no visible key, have out 0 and act as the merge identity).
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = q_positions[..., :, None] >= kv_positions[..., None, :]
    logits = logits.masked_fill(~mask.unsqueeze(-3), float("-inf"))
    row_max = logits.amax(dim=-1, keepdim=True)                 # [B,H,Sq,1]
    safe_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    unnorm = torch.exp(logits - safe_max)                       # masked -> 0
    denom = unnorm.sum(dim=-1)                                  # [B,H,Sq]
    out = torch.einsum("bhqk,bkhd->bqhd", unnorm, v.float())
    out = out / denom.clamp_min(1e-30).transpose(1, 2)[..., None]
    lse = torch.where(denom > 0,
                      torch.log(denom.clamp_min(1e-30)) + safe_max[..., 0],
                      float("-inf"))
    return out, lse.transpose(1, 2)                             # [B,Sq,H]


def merge_attention(out_a, lse_a, out_b, lse_b):
    """Merge two (chunk-normalised out, lse) partials into one."""
    lse_new = torch.logaddexp(lse_a, lse_b)
    safe = torch.where(torch.isfinite(lse_new), lse_new, 0.0)
    wa = torch.where(torch.isfinite(lse_a), torch.exp(lse_a - safe), 0.0)
    wb = torch.where(torch.isfinite(lse_b), torch.exp(lse_b - safe), 0.0)
    out = out_a * wa[..., None] + out_b * wb[..., None]
    return out, lse_new
