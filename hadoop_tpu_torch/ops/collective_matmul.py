"""The row-parallel projection and its tp reduce.

The counterpart of ``hadoop_tpu/ops/collective_matmul.py``'s bitwise
path. The row-parallel matmuls (attention out-projection, MLP
down-projection) end in a sum over ``tp``: ``spmd.psum``, or
``spmd.psum_scatter`` of the sequence under Megatron-SP, taken once on
the whole product. The reference's chunked forms (the collective in
pieces, and the T3-style per-chunk matmul) overlap nothing here:
``spmd``'s collectives are blocking, so a chunk's reduce waits for the
whole product and delays the next. They come back with an asynchronous
collective and an on/off measurement on more than one card (ROADMAP
Queue A 6). The reduce records its bytes in the comm ledger
(``obs/comm.py``: ``tp.psum``, ``tp.scatter``).
"""

from __future__ import annotations

from typing import Optional

import torch

from hadoop_tpu_torch.obs.comm import record_comm, static_nbytes
from hadoop_tpu_torch.parallel import spmd


def reduce_row_parallel(y: torch.Tensor, ctx) -> torch.Tensor:
    """The row-parallel reduce: psum over tp, or psum_scatter of the
    sequence (dim 1) under Megatron-SP; identity without tp."""
    if ctx.tp is None:
        return y
    site = "tp.scatter" if ctx.megatron_sp else "tp.psum"
    record_comm(site, static_nbytes(y), static_nbytes(y))
    if ctx.megatron_sp:
        return spmd.psum_scatter(y, ctx.tp, 1)
    return spmd.psum(y, ctx.tp)


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


def row_parallel_project(x: torch.Tensor, w: torch.Tensor, ctx,
                         bias: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """``reduce_row_parallel(x @ w + bias)``: the attention
    out-projection and the MLP down-projection."""
    return reduce_row_parallel(_project(x, w, ctx, bias), ctx)
