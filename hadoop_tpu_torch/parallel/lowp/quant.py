"""The per-group int8 codec of the relaxed parity tier.

A small copy of ``hadoop_tpu/parallel/lowp/quant.py``: ``quantize_array``
and ``dequantize_array`` (the ``int8`` codec only) and the MoE expert
payload round trip of ``moe_dispatch_quantized`` and
``moe_combine_quantized`` on one device (``axis_name=None``). The
quantized collectives and the comm ledger come with multi-GPU
parallelism (ROADMAP Queue A 6, A 8).

The rules are the reference's, so the bytes are too: symmetric groups of
``group`` consecutive elements of the flattened array, one f32 scale per
group, ``max(amax, 1e-30) / 127`` in f32 (an all-zeros group decodes to
exact zeros), values divided by their scale, rounded half to even and
clipped to ±127. The codec takes tensors and works on the tensor's own
device; every division is tensor by tensor, because CUDA torch turns a
division by a Python scalar into a multiplication by its reciprocal,
which rounds otherwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

WIRE_CODECS = ("int8", "fp8")
_TINY = 1e-30          # scale floor: an all-zeros group stays exactly 0


def _scales(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(amax, _TINY) / qmax`` in f32, as true divisions."""
    amax = amax.float()
    return torch.maximum(amax, torch.full_like(amax, _TINY)) / \
        torch.full_like(amax, qmax)


def _quant_rows(rows: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 ``clip(rint(rows / scales), -127, 127)`` (rows f32 [n, g])."""
    return torch.clamp(torch.round(rows / scales[:, None]), -127,
                       127).to(torch.int8)


def quantize_array(x: torch.Tensor, codec: str = "int8",
                   group: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-group quantization of ``x`` (any shape, any float
    dtype; widened to f32 first, exactly) on ``x``'s device. Returns
    ``(q int8 [G, group], scales f32 [G])`` with ``G = ceil(x.numel() /
    group)``; the last group is zero-padded."""
    if codec not in WIRE_CODECS:
        raise ValueError(f"unknown wire codec {codec!r} "
                         f"(must be one of {WIRE_CODECS})")
    if codec == "fp8":
        raise NotImplementedError(
            "the fp8 wire codec is not ported (the relaxed-parity tier, "
            "ROADMAP Queue A 8)")
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % group
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    rows = flat.reshape(-1, group)
    scales = _scales(rows.abs().amax(dim=1), 127.0)
    return _quant_rows(rows, scales), scales


def dequantize_array(q: torch.Tensor, scales: torch.Tensor,
                     shape: Sequence[int], dtype: torch.dtype
                     ) -> torch.Tensor:
    """Inverse of :func:`quantize_array`: ``q * scale`` in f32, cut to
    ``shape`` and cast to ``dtype``."""
    rows = q.float() * scales.float()[:, None]
    n = 1
    for d in shape:
        n *= int(d)
    return rows.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def _expert_payload_quantized(x: torch.Tensor, axis_name: Optional[str]
                              ) -> torch.Tensor:
    """An ``[E, C, D]`` expert payload through int8 with one f32 scale
    per (expert, slot) row and back, as the reference's exchange does on
    a single-device replica (``axis_name=None``: the exchange itself is
    the identity)."""
    if axis_name is not None:
        raise NotImplementedError(
            "the expert all-to-all exchange (ep) is multi-GPU "
            "parallelism, ROADMAP Queue A 6")
    flat = x.reshape(-1, x.shape[-1]).float()
    scales = _scales(flat.abs().amax(dim=1), 127.0)
    q = _quant_rows(flat, scales)
    return (q.float() * scales[:, None]).reshape(x.shape).to(x.dtype)


def moe_dispatch_quantized(xe: torch.Tensor,
                           axis_name: Optional[str] = None) -> torch.Tensor:
    """The dispatch leg: expert inputs ``[E, C, D]`` as int8 + row
    scales (the reference's ``moe.dispatch`` site)."""
    return _expert_payload_quantized(xe, axis_name)


def moe_combine_quantized(ye: torch.Tensor,
                          axis_name: Optional[str] = None) -> torch.Tensor:
    """The combine leg: expert outputs ``[E, C, D]`` as int8 + row
    scales (the reference's ``moe.combine`` site)."""
    return _expert_payload_quantized(ye, axis_name)
