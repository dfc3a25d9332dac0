"""Token cross-entropy: plain, vocab-parallel, and chunked over the
sequence.

The counterpart of ``hadoop_tpu/ops/cross_entropy.py``:
``softmax_cross_entropy``, ``vocab_parallel_cross_entropy`` (the logits
sharded over the vocab on a tp axis; the softmax normaliser and the
target logit are sums over it, so no rank holds more than its vocab
slice) and ``chunked_lm_cross_entropy``, the fused LM-head + CE of the
training step.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from hadoop_tpu_torch.parallel import spmd


def softmax_cross_entropy(logits: torch.Tensor,
                          targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy. logits [B,S,V] (any float dtype), targets [B,S]
    integers."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    target_logit = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - target_logit).mean()


def vocab_parallel_cross_entropy(local_logits: torch.Tensor,
                                 targets: torch.Tensor, axis: spmd.Axis,
                                 vocab_shard_size: int) -> torch.Tensor:
    """Mean cross-entropy of logits sharded over the vocab on ``axis``.

    local_logits: [B,S,V/tp], this rank's vocab slice; targets: [B,S]
    global token ids. The normaliser takes the max over the axis (no
    gradient: it only shifts) and the sum of the shifted exponentials
    over it; the target logit is the one rank's masked pick, summed.
    """
    local = local_logits.float()
    lo = spmd.axis_index(axis) * vocab_shard_size
    global_max = spmd.pmax_raw(local.detach().amax(dim=-1), axis)
    sumexp = torch.exp(local - global_max[..., None]).sum(dim=-1)
    lse = torch.log(spmd.psum(sumexp, axis)) + global_max
    local_ids = targets - lo
    in_shard = (local_ids >= 0) & (local_ids < vocab_shard_size)
    picked = local.gather(
        -1, local_ids.clamp(0, vocab_shard_size - 1)[..., None])[..., 0]
    target_logit = spmd.psum(torch.where(in_shard, picked, 0.0), axis)
    return (lse - target_logit).mean()


def _piece(head, h_chunk, t_chunk, axis=None, vocab_shard_size=0):
    logits = h_chunk @ head
    if axis is None:
        return softmax_cross_entropy(logits, t_chunk) * t_chunk.numel()
    return vocab_parallel_cross_entropy(
        logits, t_chunk, axis, vocab_shard_size) * t_chunk.numel()


def chunked_lm_cross_entropy(h: torch.Tensor, head: torch.Tensor,
                             targets: torch.Tensor, chunk: int = 256,
                             axis: Optional[spmd.Axis] = None,
                             vocab_shard_size: int = 0) -> torch.Tensor:
    """Fused LM head + cross-entropy, chunked over the sequence.

    Each chunk's head matmul and CE run under a non-reentrant
    ``torch.utils.checkpoint``, so no chunk's logits are kept for the
    backward: they are recomputed there, one chunk at a time, and peak
    memory is one [B, chunk, V] slab instead of the full [B, S, V]
    logits and their float32 softmax.

    h: [B, S, D] final hidden states (after the final norm); head: [D, V]
    (or [D, V/tp] with ``axis`` the tp axis, vocab-parallel); targets:
    [B, S]. Returns the mean CE over B*S tokens. When ``chunk`` does not
    divide S the whole sequence is one chunk, as in the reference.
    """
    b, s, _ = h.shape
    if s % chunk:
        chunk = s
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for start in range(0, s, chunk):
        total = total + checkpoint(
            _piece, head, h[:, start:start + chunk],
            targets[:, start:start + chunk], axis, vocab_shard_size,
            use_reentrant=False)
    return total / (b * s)
