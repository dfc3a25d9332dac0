"""Ring attention: causal attention over a sequence sharded across ranks.

The counterpart of ``hadoop_tpu/parallel/ring_attention.py``. Each rank
owns a contiguous sequence shard of Q/K/V; K/V shards rotate around the
ring while every rank accumulates its queries' attention with the
online-softmax merge of ``ops.attention``. Causality holds globally
because each chunk is masked with absolute positions (or, on the fused
path, weighted out of the merge); fully masked chunks merge as the
identity.

The ranks of one ring share one device here. The reference runs them
under ``shard_map`` on an ``sp`` mesh with ``ppermute`` as the hop; the
port folds the rank axis into the batch instead: q, k and v are
``[R*B, S_local, H, D]`` with rank r's shard on rows r*B..(r+1)*B-1, a
ring hop is a roll of that axis by one, and one kernel launch per ring
step serves every rank. Each rank's kernel work is what an R-device
deployment does (same shapes, same launches per rank, same numerics);
the wall time is not an R-device time. Hops between distinct devices
come with multi-GPU parallelism (ROADMAP Queue A 6).
"""

from __future__ import annotations

import torch

from hadoop_tpu_torch.ops import flash
from hadoop_tpu_torch.ops.attention import (_kernel_takes, _repeat_kv,
                                            chunk_attention, merge_attention)


def _hop(x: torch.Tensor, ring_size: int) -> torch.Tensor:
    """One ring hop: rank r receives rank r-1's shard (``ppermute`` with
    the permutation i -> i+1)."""
    return torch.roll(x.reshape(ring_size, -1, *x.shape[1:]), 1,
                      dims=0).reshape(x.shape)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ring_size: int, impl: str = "auto") -> torch.Tensor:
    """q,k,v: [R*B, S_local, H(q|kv), D], rank-major. Returns
    [R*B, S_local, Hq, D] in q's dtype.

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
    rows, sl, hq, d = q.shape
    if rows % ring_size:
        raise ValueError(f"{rows} rows do not fold {ring_size} ring ranks")
    b = rows // ring_size
    scale = 1.0 / (d ** 0.5)
    # rank of each row
    my = torch.arange(ring_size, device=q.device).repeat_interleave(b)
    use_flash = impl == "flash" or (
        impl == "auto" and q.is_cuda and _kernel_takes(q, k, v)
        and flash.partial_supported(q.shape, k.shape))

    if use_flash:
        out, lse = flash.flash_attention_partial(q, k, v, scale, True)
        kc, vc = k, v
        for i in range(1, ring_size):
            kc, vc = _hop(kc, ring_size), _hop(vc, ring_size)
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
            kc, vc = _hop(kc, ring_size), _hop(vc, ring_size)
    return out.to(q.dtype)
