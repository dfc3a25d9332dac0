"""Ring attention: causal attention over a sequence sharded across ranks.

The counterpart of ``hadoop_tpu/parallel/ring_attention.py``. Each rank
owns a contiguous sequence shard of Q/K/V; K/V shards rotate around the
ring while every rank accumulates its queries' attention with the
online-softmax merge of ``ops.attention``. Causality holds globally
because each chunk is masked with absolute positions (or, on the fused
path, weighted out of the merge); fully masked chunks merge as the
identity.

The ring is an ``spmd.Axis``. On a process group (one rank per process,
``parallel/mesh.py``) a hop is ``spmd.ppermute``, a paired send and
receive, as the reference's ``ppermute`` is. On a folded axis the ranks
share one device: q, k and v are ``[R*B, S_local, H, D]`` with rank r's
shard on rows r*B..(r+1)*B-1, a hop is a roll of that stack, and one
kernel launch per ring step serves every rank; each rank's kernel work
is what an R-device deployment does, the wall time is not. Both kinds
run the code below, and both are differentiable (the fused partial's
backward differentiates its plain version, as the reference's does).
"""

from __future__ import annotations

from typing import Union

import torch

from hadoop_tpu_torch.ops import flash
from hadoop_tpu_torch.ops.attention import (_kernel_takes, _repeat_kv,
                                            chunk_attention, merge_attention)
from hadoop_tpu_torch.obs.comm import record_comm, static_nbytes
from hadoop_tpu_torch.parallel import spmd


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: Union[int, spmd.Axis], impl: str = "auto"
                   ) -> torch.Tensor:
    """q,k,v: [B, S_local, H(q|kv), D] on a process-group ``axis``, or
    [R*B, S_local, ...] rank-major on a folded one (an int ``axis`` is a
    folded ring of that many ranks). Returns [.., S_local, Hq, D] in
    q's dtype.

    ``impl``: "flash" runs each ring step through the fused partial
    (``ops.flash.flash_attention_partial``): the step-0 diagonal is the
    causal partial; each later step first hops, then runs the
    non-causal partial, folded in through the merge weight (a chunk from
    a later rank is entirely in this rank's future, so its lse is forced
    to -inf, the merge identity: the same shape every step). "ref" runs
    the chunk/merge path on absolute positions. "auto" takes "flash" for
    CUDA tensors whose shapes ``flash.partial_supported`` accepts and
    whose dtype and head dim the kernels were built for
    (``flash.kernel_built``; the reference's predicate excludes GPUs,
    this port's kernels are for one) and "ref" otherwise.
    """
    if impl not in ("auto", "flash", "ref"):
        raise ValueError(f"impl={impl!r} (choices: auto, flash, ref)")
    if isinstance(axis, int):
        axis = spmd.folded("sp", axis)
    ring_size = axis.size
    rows, sl, hq, d = q.shape
    ranks = spmd.local_ranks(axis, q.device)
    if rows % ranks.numel():
        raise ValueError(f"{rows} rows do not fold {ring_size} ring ranks")
    scale = 1.0 / (d ** 0.5)
    my = ranks.repeat_interleave(rows // ranks.numel())   # rank of each row
    use_flash = impl == "flash" or (
        impl == "auto" and q.is_cuda and _kernel_takes(q, k, v)
        and flash.partial_supported(q.shape, k.shape))

    # the comm ledger: the K/V shards times the hops of the path, as the
    # reference records them (the fused path skips the diagonal's)
    kv_bytes = static_nbytes(k) + static_nbytes(v)
    hops = ring_size - 1 if use_flash else ring_size
    record_comm("cp.ring", hops * kv_bytes, hops * kv_bytes)
    if use_flash:
        out, lse = flash.flash_attention_partial(q, k, v, scale, True)
        kc, vc = k, v
        for i in range(1, ring_size):
            kc, vc = spmd.ppermute(kc, axis), spmd.ppermute(vc, axis)
            src = (my - i) % ring_size
            o_i, l_i = flash.flash_attention_partial(q, kc, vc, scale, False)
            visible = (src < my)[:, None, None]
            l_i = torch.where(visible, l_i, float("-inf"))
            out, lse = merge_attention(out, lse, o_i, l_i)
        return out.to(q.dtype)

    n_rep = hq // k.shape[2]
    local = torch.arange(sl, device=q.device)
    q_pos = my[:, None] * sl + local
    out = torch.zeros((rows, sl, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((rows, sl, hq), float("-inf"), device=q.device)
    kc, vc = k, v
    for i in range(ring_size):
        src = (my - i) % ring_size          # which shard this K/V chunk is
        kv_pos = src[:, None] * sl + local
        o_i, l_i = chunk_attention(
            q, _repeat_kv(kc, n_rep).float(), _repeat_kv(vc, n_rep).float(),
            scale, q_pos, kv_pos)
        out, lse = merge_attention(out, lse, o_i, l_i)
        if i + 1 < ring_size:
            kc, vc = spmd.ppermute(kc, axis), spmd.ppermute(vc, axis)
    return out.to(q.dtype)
