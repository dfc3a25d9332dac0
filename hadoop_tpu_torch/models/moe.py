"""Mixture-of-experts MLP with capacity-based one-hot dispatch.

The counterpart of ``hadoop_tpu/models/moe.py`` on one device. Routing
is dense one-hot algebra with static shapes (Switch-Transformer style):
top-k experts per token with renormalised gates, and each expert takes
at most ``C = max(4, ceil(T * k / E * capacity_factor))`` of the ``T``
tokens routed together, in token-major order; a token past its expert's
capacity gets no output from it (its residual passes through). The
serving engine's fused step routes through :func:`route` too, so the
capacity rule and the drop order are one.

In training, gradients reach the router only through the renormalised
top-k gate values in ``combine`` (the reference's ``jax.lax.top_k``):
the dispatch one-hots carry none. There is no auxiliary loss, as in the
reference. ``moe_mlp`` runs under two ``record_function`` ranges,
"moe.route" (the routing and the dispatch and combine einsums) and
"moe.experts" (the expert FFN), so a profile gives each its share.

Under an ``ep`` axis (``ctx.ep``, a process group) a rank holds E/ep
experts: the [E, C, D] expert batches it built go out with
``all_to_all`` (split 0, concat 1) to [E/ep, ep·C, D], each rank's local
experts run on every peer's batch, and the inverse exchange brings
[E, C, D] back in expert order; the backward of each exchange is the
other. Under tp the experts' d_ff is this rank's shard, so the output
is a partial sum that the caller reduces (``reduce_row_parallel``), and
the router, which every tp rank holds whole, gets the sum of every tp
rank's part of its gradient (``spmd.copy_to``; under Megatron-SP the
train step's sum over the tp data axis gives it).

Under ep each exchange records its bytes in the comm ledger
(``obs/comm.py``: ``moe.dispatch``, ``moe.combine``).

``drops``: while it is a list, each routing appends ``(choices,
kept)``, the T·k token-expert choices and those within capacity (a
0-d device tensor), for a caller to read the dropped share.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
from torch.profiler import record_function

from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.ops import swiglu
from hadoop_tpu_torch.obs.comm import record_comm, static_nbytes
from hadoop_tpu_torch.parallel import spmd

drops = None


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = math.ceil(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, int(c))


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Per-expert slot count C for a ``n_tokens``-row dispatch."""
    return _capacity(n_tokens, cfg)


def route(x2d: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch and combine tensors for ``x2d`` [T, D]: ``dispatch``
    [T, E, C] of 0/1 and ``combine`` [T, E, C] of gate weights, f32."""
    T = x2d.shape[0]
    E, K, C = cfg.n_experts, cfg.top_k, _capacity(T, cfg)
    logits = (x2d @ router_w).float()                      # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(probs, K, dim=-1)       # [T, K]
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    # one-hot expert choice per (token, k): [T, K, E]
    choice = torch.nn.functional.one_hot(top_idx, E).float()
    # position of each (t, k) in its expert's queue, token-major priority
    flat = choice.reshape(T * K, E)
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(T, K, E)
    keep = (pos < C) & (choice > 0)
    # slot one-hot [T, K, E, C]; a position past C keeps no slot
    slot = torch.nn.functional.one_hot(
        torch.clamp(pos.long(), max=C), C + 1)[..., :C].float()
    slot = slot * keep[..., None].float()
    dispatch = slot.sum(dim=1)                             # [T, E, C]
    combine = (slot * top_vals[:, :, None, None]).sum(dim=1)
    return dispatch, combine


def _expert_ffn(xe: torch.Tensor, lp, cfg: ModelConfig) -> torch.Tensor:
    """Each expert's SwiGLU MLP. xe: [E, C, D]. The down product in
    ``w_down``'s dtype (a tp serving rank keeps it in float32)."""
    gate = torch.bmm(xe, lp["w_gate"])
    up = torch.bmm(xe, lp["w_up"])
    w = lp["w_down"]
    return torch.bmm(swiglu(gate, up).to(w.dtype), w)


def moe_mlp(h: torch.Tensor, lp, cfg: ModelConfig, ctx=None) -> torch.Tensor:
    """Routed MLP over ``h`` [B, S, D], every token routed together.
    ``lp``: one layer's ``router`` [D, E] and expert stacks
    ``w_gate``/``w_up`` [E_local, D, F_local], ``w_down`` [E_local,
    F_local, D] (E/ep experts under ``ctx.ep``, d_ff/tp under
    ``ctx.tp``: then the result is a partial sum over tp)."""
    ep = getattr(ctx, "ep", None)
    tp = getattr(ctx, "tp", None)
    router = lp["router"]
    if tp is not None and not ctx.megatron_sp:
        router = spmd.copy_to(router, tp)
    B, S, D = h.shape
    x2d = h.reshape(B * S, D)
    with record_function("moe.route"):
        dispatch, combine = route(x2d, router, cfg)
        if drops is not None:
            drops.append((x2d.shape[0] * cfg.top_k, dispatch.detach().sum()))
        xe = torch.einsum("tec,td->ecd", dispatch.to(h.dtype), x2d)
        if ep is not None:
            record_comm("moe.dispatch", static_nbytes(xe),
                        static_nbytes(xe))
        xe = spmd.all_to_all(xe, ep, 0, 1)          # [E/ep, ep*C, D]
    with record_function("moe.experts"):
        ye = _expert_ffn(xe, lp, cfg)
    with record_function("moe.route"):
        if ep is not None:
            record_comm("moe.combine", static_nbytes(ye),
                        static_nbytes(ye))
        ye = spmd.all_to_all(ye, ep, 1, 0)          # [E, C, D]
        y2d = torch.einsum("tec,ecd->td", combine, ye.float())
    return y2d.reshape(B, S, D).to(h.dtype)
