"""Fused flash attention, forward and backward, and the ring-attention
partial — CUDA C++ kernels for Hopper.

The counterpart of ``hadoop_tpu/ops/flash.py``: the Pallas TPU kernels
``_fwd_kernel`` (causal, and ``causal=False`` for the partial),
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` become ``csrc/flash_fwd.cu``
and ``csrc/flash_bwd.cu``, kernels written
for ``sm_90a`` and called through ``ctypes`` (``ops/_build.py`` compiles
them on first use). The forward streams K/V tiles through shared memory
against a resident Q tile with the softmax kept online, so the [S, S]
score matrix never reaches device memory; the backward recomputes P from
the saved log-sum-exp. Query head ``h`` reads KV head ``h // n_rep`` with
no copied heads. Forward and backward take bf16 at D 64/128 on the
tensor cores (TMA and ``wgmma``, ``csrc/flash_fwd_sm90.cuh`` and
``csrc/flash_bwd_sm90.cuh``) and float32, or bf16 at D 192/256, on the
FMA units; the routing is static, in the C entries.

Numerics as in the reference: scores and softmax statistics in float32,
P cast to the input dtype before P·V and Pᵀ·dO, dS·scale cast to the
input dtype before dSᵀ·Q and dS·K, outputs in the input dtype, the
per-row log-sum-exp in float32. bf16 and float32 inputs.

Dispatch: ``flash_forward`` and ``flash_backward`` launch the kernels for
CUDA tensors, or raise; for CPU tensors they compute
``flash_attention_ref`` and ``flash_attention_bwd_ref``, the plain
PyTorch versions of the same functions. ``FlashAttention`` is the
``torch.autograd.Function`` that joins them; ``flash_attention`` takes it
when a gradient is wanted. ``launches``, ``launches_bwd_dq`` and
``launches_bwd_dkv`` count kernel launches.

``flash_attention_partial`` is ring attention's per-chunk partial:
(chunk-normalised O in float32, lse [B, Sq, Hq]), merged by
``ops.attention.merge_attention``. Its causal form (the diagonal chunk)
is the causal forward kernel, counted in ``launches``; its fully visible
form is the same kernel built without the mask and with Sq ≠ Skv
allowed, counted in ``launches_partial``; it writes what the merge reads,
O as float32 [B, Sq, Hq, D] and lse [B, Sq, Hq], with O rounded to the
input dtype first (the TPU kernel writes O in q's dtype and its wrapper
casts to float32). The partial records no gradient (CP training is a
later slice).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hadoop_tpu_torch.ops import _build

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128, 192, 256)        # head dims the kernels are built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                            # forward kernel launches
launches_bwd_dq = 0                     # dQ kernel launches
launches_bwd_dkv = 0                    # dK/dV kernel launches
launches_partial = 0                    # non-causal partial launches


def _pick_block(seq: int, preferred: int) -> int:
    """The TPU kernel's block size for ``seq``, as the reference picks it
    (the CUDA kernels tile by 64 rows instead)."""
    b = min(preferred, seq)
    while seq % b:
        b //= 2
    return max(b, 1)


def supported(q_shape, k_shape, q_offset, kv_offset) -> bool:
    """Shapes/args the fused kernel handles; callers fall back otherwise."""
    b, sq, hq, d = q_shape
    _, skv, hkv, _ = k_shape
    if not (isinstance(q_offset, int) and isinstance(kv_offset, int)):
        return False
    if q_offset != 0 or kv_offset != 0 or sq != skv:
        return False
    if hq % hkv:
        return False
    # Lane-dim friendliness + at least one full min-tile of rows.
    return d % 64 == 0 and sq % 128 == 0 and sq >= 128


def kernel_built(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether the kernels were built for this dtype and head dim.
    ``supported`` and ``partial_supported`` are the reference's shape
    predicates and accept any dtype and any D % 64 == 0; the "auto"
    dispatchers ask this too, so what no kernel takes goes to the plain
    path instead of raising."""
    return dtype in _DTYPES and head_dim in _HEAD_DIMS


def partial_supported(q_shape, k_shape) -> bool:
    """Shapes the fused ring-attention partial handles."""
    b, sq, hq, d = q_shape
    _, skv, hkv, _ = k_shape
    if hq % hkv:
        return False
    return (d % 64 == 0 and sq % 128 == 0 and skv % 128 == 0
            and sq >= 128 and skv >= 128)


def _head_major(q, k, v):
    """float32 [B,H,S,D] views, K/V heads repeated for their query heads."""
    n_rep = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(n_rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(n_rep, dim=1)
    return qf, kf, vf


def _causal_scores(qf, kf, scale):
    s = qf.shape[2]
    scores = (qf @ kf.transpose(-1, -2)) * scale
    visible = torch.ones(s, s, dtype=torch.bool, device=qf.device).tril()
    return scores.masked_fill(~visible, _NEG_INF)


def _softmax_pv(scores, vf, dtype):
    """(o [B,H,Sq,D] in ``dtype``, lse [B,H,Sq] float32) of float32
    scores. P is the unnormalised exp(s - max) rounded to ``dtype``, as
    in the kernel's single-block case."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(dtype).float() @ vf) / l
    return o.to(dtype), (m + torch.log(l))[..., 0]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: q [B,S,Hq,D], k/v
    [B,S,Hkv,D] → (o [B,S,Hq,D] in q's dtype, lse [B,Hq,S] float32)."""
    qf, kf, vf = _head_major(q, k, v)
    o, lse = _softmax_pv(_causal_scores(qf, kf, scale), vf, q.dtype)
    return o.transpose(1, 2).contiguous(), lse


def flash_attention_partial_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, scale: float, causal: bool
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the partial: q [B,Sq,Hq,D], k/v
    [B,Skv,Hkv,D] → (o [B,Sq,Hq,D] float32, lse [B,Sq,Hq] float32), the
    layout the fully visible kernel writes. It computes what the kernel
    computes: P rounded to the input dtype before P·V, O rounded to the
    input dtype and then cast to float32 (the reference's
    ``_partial_ref`` does neither rounding)."""
    if causal:
        o, lse = flash_attention_ref(q, k, v, scale)
    else:
        qf, kf, vf = _head_major(q, k, v)
        o, lse = _softmax_pv((qf @ kf.transpose(-1, -2)) * scale, vf,
                             q.dtype)
        o = o.transpose(1, 2)
    return o.float().contiguous(), lse.transpose(1, 2).contiguous()


def flash_attention_bwd_ref(q, k, v, o, lse, do, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Plain PyTorch version of the two backward kernels, in the layout of
    ``flash_attention_ref`` (``o``, ``do`` like q; ``lse`` [B,Hq,S]) →
    (dq, dk, dv) in the input dtype. δ = rowsum(dO∘O) in float32; P
    rounded to the input dtype before Pᵀ·dO and dS·scale before dSᵀ·Q and
    dS·K, as the reference rounds; each KV head's dK/dV summed over its
    query heads in float32 and rounded once."""
    b, s, hkv, d = k.shape
    n_rep = q.shape[2] // hkv
    qf, kf, vf = _head_major(q, k, v)
    dof = do.float().transpose(1, 2)
    delta = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
    p = torch.exp(_causal_scores(qf, kf, scale) - lse[..., None])
    dv = p.to(q.dtype).float().transpose(-1, -2) @ dof
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    ds = (ds * scale).to(q.dtype).float()
    dq = ds @ kf
    dk = ds.transpose(-1, -2) @ qf

    def out(x, like, heads):
        x = x.reshape(b, heads, -1, s, d).sum(2)     # GQA group sum, f32
        return x.to(like.dtype).transpose(1, 2).contiguous()

    return out(dq, q, q.shape[2]), out(dk, k, hkv), out(dv, v, hkv)


# ------------------------------------------------------------ the kernels

def _check(q, k, v, *like_q, partial: bool = False):
    """Raise on anything the kernels do not take; ``like_q`` are tensors
    of q's shape and dtype (o, do). ``partial``: the shapes of the
    fully visible partial (Sq ≠ Skv allowed)."""
    tensors = (q, k, v) + like_q
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("flash kernel: inputs must lie on one CUDA device")
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"flash kernel: dtypes "
                         f"{[str(t.dtype) for t in tensors]}; it takes "
                         f"float32 or bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3] \
            or any(t.shape != q.shape for t in like_q):
        raise ValueError(f"flash kernel: shapes {[tuple(t.shape) for t in tensors]}")
    if not (partial_supported(q.shape, k.shape) if partial
            else supported(q.shape, k.shape, 0, 0)):
        raise ValueError(f"flash kernel: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash kernel: inputs must be contiguous")
    if q.shape[3] not in _HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {q.shape[3]} not built "
                         f"(built: {_HEAD_DIMS})")


def _dims(q, k):
    b, s, hq, d = q.shape
    return b, s, hq, k.shape[2], d, _DTYPES[q.dtype]


def _launch(q, k, v, scale: float):
    """The forward kernel: check, allocate, launch on the current stream."""
    global launches
    _check(q, k, v)
    b, s, hq, _, _, _ = _dims(q, k)
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _build.launch("htpu_flash_fwd", q, k, v, o, lse, *_dims(q, k),
                  float(scale))
    launches += 1
    return o, lse


def _launch_partial(q, k, v, scale: float):
    """The fully visible partial kernel → (o float32 [B, Sq, Hq, D], lse
    [B, Sq, Hq]), what the merge reads, as the kernel writes them."""
    global launches_partial
    _check(q, k, v, partial=True)
    b, sq, hq, d = q.shape
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((b, sq, hq), dtype=torch.float32, device=q.device)
    _build.launch("htpu_flash_fwd_partial", q, k, v, o, lse, b, sq,
                  k.shape[1], hq, k.shape[2], d, _DTYPES[q.dtype],
                  float(scale))
    launches_partial += 1
    return o, lse


def _check_lse(q, lse, what="lse"):
    b, s, hq, _ = q.shape
    if lse.dtype != torch.float32 or lse.shape != (b, hq, s) \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash kernel: {what} must be float32 "
                         f"[{b}, {hq}, {s}] contiguous on {q.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")


def _launch_bwd_dq(q, k, v, o, lse, do, scale: float):
    """The dQ kernel → (dq, delta): delta = rowsum(dO∘O) [B,Hq,S] float32,
    which the dK/dV kernel reads."""
    global launches_bwd_dq
    _check(q, k, v, o, do)
    _check_lse(q, lse)
    b, s, hq, _, _, _ = _dims(q, k)
    dq = torch.empty_like(q)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    _build.launch("htpu_flash_bwd_dq", q, k, v, o, lse, do, dq, delta,
                  *_dims(q, k), float(scale))
    launches_bwd_dq += 1
    return dq, delta


def _launch_bwd_dkv(q, k, v, lse, delta, do, scale: float):
    """The dK/dV kernel → (dk, dv), each KV head summed over its group."""
    global launches_bwd_dkv
    _check(q, k, v, do)
    _check_lse(q, lse)
    _check_lse(q, delta, "delta")
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _build.launch("htpu_flash_bwd_dkv", q, k, v, lse, delta, do, dk, dv,
                  *_dims(q, k), float(scale))
    launches_bwd_dkv += 1
    return dk, dv


# ---------------------------------------------------------------- public

def _scale(q, scale):
    return 1.0 / (q.shape[-1] ** 0.5) if scale is None else float(scale)


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention: the kernel for CUDA tensors, the
    plain version for CPU tensors. Layout as ``flash_attention_ref``.
    Records no autograd graph on either device (``flash_attention`` is
    the differentiable entry)."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_ref(q, k, v, scale)
    return _launch(q, k, v, scale)


def flash_backward(q, k, v, o, lse, do, scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of causal attention given the forward's o and lse and
    the output gradient do: the two kernels for CUDA tensors (dQ first,
    which also writes δ, then dK/dV), the plain version for CPU tensors."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
    dq, delta = _launch_bwd_dq(q, k, v, o, lse, do, scale)
    dk, dv = _launch_bwd_dkv(q, k, v, lse, delta, do, scale)
    return dq, dk, dv


def _partial_forward(q, k, v, scale: float, causal: bool):
    if q.device.type == "cpu":
        with torch.no_grad():
            return flash_attention_partial_ref(q, k, v, scale, causal)
    if not causal:
        return _launch_partial(q, k, v, scale)
    o, lse = _launch(q, k, v, scale)
    return o.float(), lse.transpose(1, 2).contiguous()


class FlashAttentionPartial(torch.autograd.Function):
    """The partial with the reference's custom VJP: the kernel forward,
    and a backward that differentiates the plain partial
    (``flash_attention_partial_ref``) on the saved q, k, v: no backward
    kernel, one chunk's scores rematerialised at a time."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool):
        ctx.save_for_backward(q, k, v)
        ctx.args = (scale, causal)
        return _partial_forward(q, k, v, scale, causal)

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            o, lse = flash_attention_partial_ref(*leaves, *ctx.args)
            grads = torch.autograd.grad((o, lse), leaves, (do, dlse),
                                        allow_unused=True)
        return (*(torch.zeros_like(t) if g is None else g
                  for g, t in zip(grads, (q, k, v))), None, None)


def flash_attention_partial(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, scale: float, causal: bool
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring attention's online-softmax partial: (chunk-normalised o
    [B,Sq,Hq,D] float32, lse [B,Sq,Hq] float32), merge-compatible with
    ``ops.attention.merge_attention``. ``causal=True`` is the diagonal
    chunk (Sq == Skv), ``causal=False`` a fully visible chunk. The
    kernels for CUDA tensors (or raise), the plain version for CPU
    tensors. Differentiable through ``FlashAttentionPartial`` when grad
    mode is on and an input requires grad."""
    scale = float(scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionPartial.apply(q, k, v, scale, causal)
    return _partial_forward(q, k, v, scale, causal)


class FlashAttention(torch.autograd.Function):
    """Causal flash attention with the backward kernels as its gradient:
    saves q, k, v, o and the log-sum-exp (no [S, S] matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = flash_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused causal flash attention.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] with Hq % Hkv == 0 (GQA).
    Returns [B, Sq, Hq, D]. Differentiable: when grad mode is on and an
    input requires grad it goes through ``FlashAttention``; otherwise it
    is the bare forward and saves nothing.
    """
    scale = _scale(q, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, scale)
    return flash_forward(q, k, v, scale)[0]
