"""Fused causal flash attention (forward) — a CUDA C++ kernel for Hopper.

The counterpart of ``hadoop_tpu/ops/flash.py``'s causal forward: the
Pallas TPU kernel ``_fwd_kernel`` becomes ``csrc/flash_fwd.cu``, a
kernel written for ``sm_90a`` and called through ``ctypes``
(``ops/_build.py`` compiles it on first use). It streams K/V tiles
through shared memory against a resident Q tile with the softmax kept
online, so the [S, S] score matrix never reaches device memory; query
head ``h`` reads KV head ``h // n_rep`` with no copied heads.

Numerics as in the reference: scores and softmax statistics in float32,
P cast to the input dtype before P·V, O in the input dtype, the per-row
log-sum-exp in float32. bf16 and float32 inputs.

Dispatch: ``flash_forward`` launches the kernel for a CUDA tensor, or
raises; for a CPU tensor it computes ``flash_attention_ref``, the plain
PyTorch version of the same function. ``launches`` counts kernel
launches. The backward kernels come with the training slice: until then
the wrapper refuses inputs that require a gradient.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from hadoop_tpu_torch.ops import _build

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128, 192, 256)        # head dims the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                            # kernel launches, for run records
_fn = None


def _pick_block(seq: int, preferred: int) -> int:
    """The TPU kernel's block size for ``seq``, as the reference picks it
    (the CUDA kernel tiles by 64 rows instead)."""
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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: q [B,S,Hq,D], k/v [B,S,Hkv,D]
    → (o [B,S,Hq,D] in q's dtype, lse [B,Hq,S] float32). P is the
    unnormalised exp(s - max) rounded to the input dtype, as in the
    kernel's single-block case."""
    s = q.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2)                           # [B,Hq,S,D]
    kf = k.float().transpose(1, 2).repeat_interleave(n_rep, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(n_rep, dim=1)
    scores = (qf @ kf.transpose(-1, -2)) * scale
    visible = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~visible, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(v.dtype).float() @ vf) / l
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype).transpose(1, 2).contiguous(), lse


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("flash_fwd").htpu_flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _error_string(err: int) -> str:
    if err < 0:
        return "head dim or dtype the kernel was not built for"
    lib = _build.load("flash_fwd")
    lib.htpu_cuda_error_string.argtypes = [ctypes.c_int]
    lib.htpu_cuda_error_string.restype = ctypes.c_char_p
    return lib.htpu_cuda_error_string(err).decode()


def _launch(q, k, v, scale: float):
    """Check, allocate, launch on the current stream; raise on anything
    the kernel does not take."""
    global launches
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash kernel: q, k, v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel: dtype {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; it takes float32 or bfloat16")
    if q.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash kernel: shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)}")
    if not supported(q.shape, k.shape, 0, 0):
        raise ValueError(f"flash kernel: unsupported shapes "
                         f"q={tuple(q.shape)} k={tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel: q, k, v must be contiguous")
    b, s, hq, d = q.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash kernel: head dim {d} not built "
                         f"(built: {_HEAD_DIMS})")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _kernel()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), b, s, hq, k.shape[2],
                        d, _DTYPES[q.dtype], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash kernel launch failed ({err}): "
                           f"{_error_string(err)}")
    launches += 1
    return o, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of causal attention: the kernel for CUDA tensors, the
    plain version for CPU tensors. Layout as ``flash_attention_ref``."""
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention has no backward yet (training slice): "
            "call it on tensors that do not require grad")
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale)
    return _launch(q, k, v, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused causal flash attention.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D] with Hq % Hkv == 0 (GQA).
    Returns [B, Sq, Hq, D].
    """
    return flash_forward(q, k, v, scale)[0]
