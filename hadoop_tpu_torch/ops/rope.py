"""Rotary position embeddings (RoPE), rotated in float32 then cast back."""

from __future__ import annotations

from typing import Optional

import torch


def rope_frequencies(head_dim: int, max_seq: int, theta: float = 10000.0,
                     device=None):
    """Return (cos, sin) tables of shape [max_seq, head_dim // 2], float32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    pos = torch.arange(max_seq, dtype=torch.float32, device=device)
    angles = torch.outer(pos, inv_freq)  # [S, D/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotate q or k of shape [..., S, H, D] by position.

    ``positions``: optional integer tensor of absolute positions, [S] for
    every row, or [R, S] per ring rank for x of shape [R*B, S, H, D]
    (rank r's rows r*B..(r+1)*B-1); defaults to 0..S-1.
    """
    seq = x.shape[-3]
    if positions is None:
        c, s = cos[:seq], sin[:seq]
    else:
        c, s = cos[positions], sin[positions]
    if c.dim() == 3:                      # [R, S, D/2] -> [R*B, S, D/2]
        rows = x.shape[0] // c.shape[0]
        c = c.repeat_interleave(rows, dim=0)
        s = s.repeat_interleave(rows, dim=0)
    c = c[..., None, :]                   # [.., S, 1, D/2]: over heads
    s = s[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
