"""The row-parallel projection and its tp reduce.

The counterpart of ``hadoop_tpu/ops/collective_matmul.py``. The
row-parallel matmuls (attention out-projection, MLP down-projection)
end in a sum over ``tp``: ``spmd.psum``, or ``spmd.psum_scatter`` of the
sequence under Megatron-SP. The reduce records its bytes in the comm
ledger (``obs/comm.py``: ``tp.psum``, ``tp.scatter``).

Two parity tiers (``parallel.parity``, ``parallel/lowp``):

- **bitwise** (default): one reduce on the whole product. The
  reference cuts the collective into ``tp_chunks`` pieces so that XLA
  can overlap them; ``spmd``'s sums add in rank order elementwise, so
  the cut changes no value, and ``spmd``'s collectives block, so it
  would overlap nothing here.
- **relaxed** (``ctx.relaxed_codec``, ``ctx.relaxed_chunk_matmul``):
  the reduce is cut exactly as the reference's, into ``tp_chunks``
  chunks along the sequence (the batch under Megatron-SP, whose scatter
  takes the sequence), and each chunk's wire is int8 (or fp8) with its
  own tensor scale; :func:`chunked_matmul_reduce` cuts the matmul too,
  so the weight gradient sums per-chunk products (a reassociation the
  loss-curve guard covers). On blocking collectives the chunks overlap
  nothing: they are there because each chunk's scale, and so each
  value, is the reference's.
- A layer the sync schedule turns off (``relaxed_sync``,
  ``lowp/syncpolicy.py``) replaces the reduce with the local partial
  (skip) or the previous step's correction (stale).
"""

from __future__ import annotations

from typing import Optional

import torch

from hadoop_tpu_torch.obs.comm import record_comm, static_nbytes
from hadoop_tpu_torch.parallel import spmd


def _largest_divisor(n: int, want: int) -> int:
    for d in range(min(want, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def _reduce_one(t: torch.Tensor, ctx) -> torch.Tensor:
    """One tp reduction, psum or Megatron-SP's psum_scatter of the
    sequence, on the tier ``ctx`` names: the exact collective, or the
    quantized wire with one tensor scale."""
    if ctx.relaxed_codec is not None:   # relaxed tier: quantized wire
        from hadoop_tpu_torch.parallel.lowp.quant import (
            RelaxedQuant, psum_quantized, psum_scatter_quantized)
        rq = RelaxedQuant(codec=ctx.relaxed_codec)
        if ctx.megatron_sp:
            return psum_scatter_quantized(
                t, ctx.tp, rq, scatter_dimension=1, scale="tensor",
                site="tp.scatter")
        return psum_quantized(t, (ctx.tp,), rq, scale="tensor",
                              site="tp.psum")
    site = "tp.scatter" if ctx.megatron_sp else "tp.psum"
    record_comm(site, static_nbytes(t), static_nbytes(t))
    if ctx.megatron_sp:
        return spmd.psum_scatter(t, ctx.tp, 1)
    return spmd.psum(t, ctx.tp)


def _chunks(n: int, ctx, least: int = 1) -> int:
    return _largest_divisor(n, max(least, ctx.tp_overlap_chunks))


def reduce_row_parallel(y: torch.Tensor, ctx, relaxed_sync=None
                        ) -> torch.Tensor:
    """The row-parallel reduce: psum over tp, or psum_scatter of the
    sequence (dim 1) under Megatron-SP; identity without tp. Under the
    relaxed codec, ``ctx.tp_overlap_chunks`` quantized reduces along a
    dim the collective does not touch. ``relaxed_sync``: this site's
    scheduled mode; an off site returns the skip (or the stale pair)."""
    if ctx.tp is None:
        return y
    if relaxed_sync is not None and relaxed_sync.mode != "sync":
        from hadoop_tpu_torch.parallel.lowp.syncpolicy import \
            scheduled_row_reduce
        return scheduled_row_reduce(y, ctx, relaxed_sync)
    if ctx.relaxed_codec is None:
        return _reduce_one(y, ctx)
    axis = 0 if ctx.megatron_sp else 1
    c = _chunks(y.shape[axis], ctx)
    if c <= 1:
        return _reduce_one(y, ctx)
    return torch.cat([_reduce_one(t, ctx) for t in y.chunk(c, dim=axis)],
                     dim=axis)


def _project(x: torch.Tensor, w: torch.Tensor, ctx,
             bias: Optional[torch.Tensor]) -> torch.Tensor:
    """This rank's partial product, with the replicated bias added to it
    as the reference adds it (so a tp plan's sum holds it tp times: a
    fault of the reference that the port matches, ROADMAP Queue C).
    Under plain tp ``copy_to`` gives the bias the gradient the
    reference's vma transpose gives it; under Megatron-SP the train
    step's sum over the tp data axis does."""
    y = x @ w
    if bias is None:
        return y
    return y + (bias if ctx.megatron_sp else spmd.copy_to(bias, ctx.tp))


def chunked_matmul_reduce(x: torch.Tensor, w: torch.Tensor, ctx,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The chunked collective matmul (T3): each chunk's product and its
    reduce, at least two chunks. A relaxed-tier entry point: the forward
    chunks are disjoint rows of the same product, the backward sums the
    weight gradient over the chunks."""
    axis = 0 if ctx.megatron_sp else 1
    c = _chunks(x.shape[axis], ctx, least=2)
    if c <= 1:
        return _reduce_one(_project(x, w, ctx, bias), ctx)
    return torch.cat([_reduce_one(_project(xi, w, ctx, bias), ctx)
                      for xi in x.chunk(c, dim=axis)], dim=axis)


def row_parallel_project(x: torch.Tensor, w: torch.Tensor, ctx,
                         bias: Optional[torch.Tensor] = None,
                         relaxed_sync=None) -> torch.Tensor:
    """``reduce_row_parallel(x @ w + bias)``: the attention
    out-projection and the MLP down-projection. ``relaxed_sync`` (the
    site's scheduled mode) comes first, then the relaxed chunked
    matmul."""
    if relaxed_sync is not None and relaxed_sync.mode != "sync" \
            and ctx.tp is not None:
        from hadoop_tpu_torch.parallel.lowp.syncpolicy import \
            scheduled_row_reduce
        return scheduled_row_reduce(_project(x, w, ctx, bias), ctx,
                                    relaxed_sync)
    if ctx.relaxed_chunk_matmul and ctx.tp is not None:
        return chunked_matmul_reduce(x, w, ctx, bias=bias)
    return reduce_row_parallel(_project(x, w, ctx, bias), ctx)
