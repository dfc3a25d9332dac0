"""Normalization ops: reduced in float32, cast back to the input dtype.

``rms_norm`` on CUDA tensors is the hand-written kernel pair
``ops/csrc/rmsnorm.cu`` (the forward one pass; the backward one pass
over a fixed grid of about two blocks an SM, ``_bwd_grid``, plus a
finish that sums dw's per-block partials in a fixed order)
through the autograd Function ``RMSNorm``, which keeps x and one float32
1/rms per row for the backward. The reference's norms are jnp that XLA
fuses (``hadoop_tpu/ops/norms.py``); eagerly, the formula would be one
kernel per step with float32 [rows, D] intermediates kept by autograd.
On CPU tensors ``rms_norm`` is the plain formula, differentiated by
autograd. ``rms_norm_ref_fwd``/``rms_norm_ref_bwd`` are the kernels'
plain versions, the same arithmetic written out. ``launches_fwd`` and
``launches_bwd`` count the kernels' launches (the backward's two: its
pass and the dw finish). LayerNorm stays plain.
"""

from __future__ import annotations

import torch

from hadoop_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 8192                       # rmsnorm.cu's widest row
_BWD_BLOCKS_PER_SM = 2              # the backward's resident blocks an SM

launches_fwd = 0
launches_bwd = 0


# ---------------------------------------------------------- plain versions

def rms_norm_ref_fwd(x: torch.Tensor, weight: torch.Tensor,
                     eps: float = 1e-5):
    """RMSNorm's forward: ``(y, r)`` with y = (x · r) · w in x's dtype and
    r = 1/rms(x) [rows...] in float32, reduced in float32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    r = torch.reciprocal(torch.sqrt(var + eps))
    return ((xf * r) * weight.float()).to(x.dtype), r[..., 0]


def rms_norm_ref_bwd(dy: torch.Tensor, x: torch.Tensor,
                     weight: torch.Tensor, r: torch.Tensor):
    """RMSNorm's backward from the forward's r: ``(dx, dw)``, in float32,
    cast to x's and w's dtypes. With g = dy · w: dx = r·g − x·r³·mean(g·x)
    per row; dw = the sum over rows of dy · (x · r)."""
    xf, dyf = x.float(), dy.float()
    r = r[..., None]
    g = dyf * weight.float()
    mean = (g * xf).sum(dim=-1, keepdim=True) / x.shape[-1]
    dx = r * g - xf * (r * r * r * mean)
    dw = (dyf * (xf * r)).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(weight.dtype)


# ------------------------------------------------------------ the kernels

def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (a copy only where
    it is not: the kernels load 16 bytes at a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    d = x.shape[-1]
    if not (x.is_cuda and weight.device == x.device):
        raise ValueError("rms_norm kernel: x and the weight must lie on one "
                         "CUDA device")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise ValueError(
            f"rms_norm kernel: x {x.dtype}, weight {weight.dtype}; it takes "
            f"x of one of {list(_DTYPES)} and a weight of x's dtype")
    vec = 16 // x.element_size()
    if weight.shape != (d,) or d % vec or d > _MAX_D:
        raise ValueError(
            f"rms_norm kernel: x {tuple(x.shape)}, weight "
            f"{tuple(weight.shape)}; it takes a weight [D] with D a "
            f"multiple of {vec} and at most {_MAX_D}")


def _launch_fwd(x, weight, eps: float):
    """The forward kernel: (y like x, x as [rows, D], r float32 [rows])."""
    global launches_fwd
    _check(x, weight)
    d = x.shape[-1]
    x2 = _aligned(x.reshape(-1, d))
    w = _aligned(weight)
    y = torch.empty_like(x2)
    r = torch.empty(x2.shape[0], dtype=torch.float32, device=x.device)
    if x2.shape[0]:
        _build.launch("htpu_rms_norm_fwd", x2, w, y, r, x2.shape[0], d,
                      _DTYPES[x.dtype], float(eps))
        launches_fwd += 1
    return y.view(x.shape), x2, r


def _bwd_grid(rows: int, sms: int):
    """(blocks, rows per block) of the backward pass for rows >= 1 on a
    card of ``sms`` SMs: fixed shares of consecutive rows, about two
    blocks an SM (one wave), no block without rows. The kernel takes the
    share as ceil(rows / blocks), which is the same."""
    per = -(-rows // min(rows, _BWD_BLOCKS_PER_SM * sms))
    return -(-rows // per), per


def _launch_bwd(dy, x2, weight, r):
    """The backward kernel and the dw finish: (dx [rows, D], dw like w)."""
    global launches_bwd
    rows, d = x2.shape
    dy2 = _aligned(dy.reshape(rows, d))
    w = _aligned(weight)
    dx = torch.empty_like(x2)
    dw = torch.empty_like(w)
    if rows == 0:
        return dx, dw.zero_()
    blocks, _ = _bwd_grid(rows, torch.cuda.get_device_properties(
        x2.device).multi_processor_count)
    partials = torch.empty(blocks, d, dtype=torch.float32, device=x2.device)
    _build.launch("htpu_rms_norm_bwd", dy2, x2, w, r, dx, partials, rows, d,
                  blocks, _DTYPES[x2.dtype])
    _build.launch("htpu_rms_norm_dw", partials, dw, blocks, d,
                  _DTYPES[w.dtype])
    launches_bwd += 2
    return dx, dw


class RMSNorm(torch.autograd.Function):
    """RMSNorm through the kernels: saves x (as [rows, D]), the weight and
    the float32 1/rms per row."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, x2, r = _launch_fwd(x, weight, eps)
        ctx.save_for_backward(x2, weight, r)
        return y

    @staticmethod
    def backward(ctx, dy):
        x2, weight, r = ctx.saved_tensors
        dx, dw = _launch_bwd(dy, x2, weight, r)
        return dx.view(dy.shape), dw.view(weight.shape), None


# ---------------------------------------------------------------- public

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5):
    """RMSNorm (Llama-style): x * w / rms(x). Reduction in float32: the
    kernels for CUDA tensors, the plain formula for CPU tensors."""
    if x.is_cuda:
        return RMSNorm.apply(x, weight, eps)
    return rms_norm_ref_fwd(x, weight, eps)[0]


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """LayerNorm (GPT-2-style) with affine parameters."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (normed * weight.float() + bias.float()).to(x.dtype)
