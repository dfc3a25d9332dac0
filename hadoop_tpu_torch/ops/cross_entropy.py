"""Token cross-entropy, plain and chunked over the sequence.

The counterpart of ``hadoop_tpu/ops/cross_entropy.py`` on one device:
``softmax_cross_entropy`` and ``chunked_lm_cross_entropy``, the fused
LM-head + CE of the training step. The vocab-parallel form comes with the
multi-GPU slice.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy. logits [B,S,V] (any float dtype), targets [B,S]
    integers."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - target_logit).mean()


def _piece(head, h_chunk, t_chunk):
    return softmax_cross_entropy(h_chunk @ head, t_chunk) * t_chunk.numel()


def chunked_lm_cross_entropy(h: torch.Tensor, head: torch.Tensor,
                             targets: torch.Tensor,
                             chunk: int = 256) -> torch.Tensor:
    """Fused LM head + cross-entropy, chunked over the sequence.

    Each chunk's head matmul and CE run under a non-reentrant
    ``torch.utils.checkpoint``, so no chunk's logits are kept for the
    backward: they are recomputed there, one chunk at a time, and peak
    memory is one [B, chunk, V] slab instead of the full [B, S, V]
    logits and their float32 softmax.

    h: [B, S, D] final hidden states (after the final norm); head: [D, V];
    targets: [B, S]. Returns the mean CE over B*S tokens. When ``chunk``
    does not divide S the whole sequence is one chunk, as in the
    reference.
    """
    b, s, _ = h.shape
    if s % chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, chunk):
        total = total + checkpoint(
            _piece, head, h[:, start:start + chunk],
            targets[:, start:start + chunk], use_reentrant=False)
    return total / (b * s)
