"""Ulysses context parallelism: an all-to-all head <-> sequence exchange.

The counterpart of ``hadoop_tpu/parallel/ulysses.py``. Where ring
attention keeps activations sequence-sharded and rotates K/V around the
ranks, the DeepSpeed-Ulysses shape transposes the sharding for the
attention op:

    [B, S/P, H, D]  --all_to_all-->  [B, S, H/P, D]
    full-sequence causal attention on the local heads (one launch of
    the causal flash kernel on a CUDA device)
    [B, S, H/P, D]  --all_to_all-->  [B, S/P, H, D]

Written once against an ``spmd.Axis``: on a folded axis (the sp ranks
on one device, rank-major in the batch) the exchange is a permute of
the stacked ranks and one kernel launch serves every rank; on a process
group it is ``all_to_all_single``. Both give the same bits.
"""

from __future__ import annotations

import torch

from hadoop_tpu_torch.obs.comm import record_comm, static_nbytes
from hadoop_tpu_torch.parallel import spmd


def supports(n_q_heads: int, n_kv_heads: int, axis_size: int) -> bool:
    """The head transpose needs both head counts divisible by the axis."""
    return n_q_heads % axis_size == 0 and n_kv_heads % axis_size == 0


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: spmd.Axis, impl: str = "auto") -> torch.Tensor:
    """q, k, v: [B, S_local, H(q|kv), D], sequence-sharded over ``axis``
    (``[P*B, ...]`` on a folded axis). Returns [B, S_local, Hq, D].
    RoPE must already be applied at global positions (the ring's
    offsets serve both strategies). ``impl`` as in
    ``causal_attention``."""
    from hadoop_tpu_torch.ops.attention import causal_attention
    if not supports(q.shape[2], k.shape[2], axis.size):
        raise ValueError(f"ulysses over {axis.size} ranks needs head counts "
                         f"{q.shape[2]}/{k.shape[2]} divisible by it")
    # the comm ledger: q, k and v in, the output (q's size) back
    a2a = 2 * static_nbytes(q) + static_nbytes(k) + static_nbytes(v)
    record_comm("cp.all2all", a2a, a2a)
    q, k, v = (spmd.all_to_all(t, axis, 2, 1) for t in (q, k, v))
    attn = causal_attention(q, k, v, impl=impl)
    return spmd.all_to_all(attn, axis, 1, 2)
