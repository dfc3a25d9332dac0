"""The single-device training step.

The counterpart of ``hadoop_tpu/parallel/train.py``'s ``make_train_step``
and ``init_sharded`` for ``MeshPlan()``: forward through the decoder
(``remat`` as there), the chunked LM-head cross-entropy, the backward —
through the flash-attention backward kernels on a CUDA device — and an
AdamW (or plain SGD) update. PyTorch runs it eagerly; the step updates
the parameters and the optimizer state in place. Its four parts run under
``torch.profiler.record_function`` ranges ("forward", "loss",
"backward", "optimizer"), which a profile shows beside the kernels
(``tools/profile_flagship.py --train``; ``--train-moe`` also shows the
MoE MLP's "moe.route" and "moe.experts"). A MoE model trains as the
reference's single-device step does: no auxiliary loss, the router
learning only through the renormalised top-k gates of ``combine``.
Plans of more than one device (expert parallelism included), ZeRO-1
and microbatching come with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from hadoop_tpu_torch.device import check_on, resolve_device
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import (_layer_fn,
                                             final_hidden, forward_hidden,
                                             head_matrix, init_params)
from hadoop_tpu_torch.ops.cross_entropy import chunked_lm_cross_entropy
from hadoop_tpu_torch.parallel.mesh import MeshPlan
from hadoop_tpu_torch.parallel.optimizer import (AdamWState, adamw_init,
                                                 adamw_update, grad_sq,
                                                 tree_leaves, tree_map)


def _loss_from_h(params, h, targets, cfg: ModelConfig, chunk: int = 256):
    """LM loss from pre-head hidden states, chunked over the sequence so
    the full [B, S, V] logits never materialize."""
    h = final_hidden(params, h, cfg)
    head = head_matrix(params, cfg, h.dtype)
    return chunked_lm_cross_entropy(h, head, targets, chunk)


def make_train_step(cfg: ModelConfig, plan: Optional[MeshPlan] = None, *,
                    lr: float = 3e-4, n_microbatches: int = 1,
                    remat=False, optimizer: str = "adamw",
                    zero1: bool = False, attn_impl: str = "auto",
                    device=None):
    """The train step on ``device`` (default: the GPU; raises without one
    unless ``device="cpu"``).

    Returns ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, {"loss", "grad_norm"})``: tokens and targets are [B, S]
    integers; the returned trees are the ones passed in, updated in
    place; the metrics are 0-d float32 tensors on the device (reading one
    waits for the step). ``optimizer``: "adamw", or "sgd" (p - lr·g, the
    reference's exact-parity mode). ``attn_impl`` as in
    ``causal_attention``.
    """
    plan = MeshPlan() if plan is None else plan
    if plan.n_devices > 1 or zero1 or n_microbatches > 1:
        raise NotImplementedError(
            f"plan {plan} with zero1={zero1}, n_microbatches="
            f"{n_microbatches}: the port trains on one device; parallel "
            "plans (expert parallelism included), ZeRO-1 and pipelining "
            "are ROADMAP Queue A 6")
    if optimizer not in ("adamw", "sgd"):
        raise ValueError(f"optimizer={optimizer!r} (choices: adamw, sgd)")
    _layer_fn(remat)                      # refuse an unknown mode now
    dev = resolve_device(device)

    def step(params, opt_state: AdamWState, tokens, targets
             ) -> Tuple[Dict[str, Any], AdamWState, Dict[str, torch.Tensor]]:
        check_on(params["embed"], dev, "params")
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        # differentiate through aliases: the caller's tensors keep their
        # requires_grad flag, and the update below writes their storage
        alias = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            with record_function("forward"):
                h = forward_hidden(alias, tokens, cfg, attn_impl, remat)
            with record_function("loss"):
                loss = _loss_from_h(alias, h, targets, cfg)
            leaves = tree_leaves(alias)
            with record_function("backward"):
                flat = torch.autograd.grad(loss, leaves)
        grad_of = {id(a): g for a, g in zip(leaves, flat)}
        grads = tree_map(lambda a: grad_of[id(a)], alias)
        with record_function("optimizer"):
            gsq = grad_sq(grads)
            if optimizer == "sgd":
                with torch.no_grad():
                    tree_map(lambda p, g: p.copy_(p.float() - lr * g.float()),
                             params, grads)
                opt_state = AdamWState(opt_state.count + 1, opt_state.mu,
                                       opt_state.nu)
                gnorm = torch.sqrt(gsq)
            else:
                params, opt_state, gnorm = adamw_update(
                    params, grads, opt_state, lr, gsq=gsq)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None) -> Tuple[Dict[str, Any], AdamWState]:
    """Parameters from ``generator`` (as ``init_params``) and zero AdamW
    state, on ``device`` (default: the GPU)."""
    params = init_params(cfg, generator, device)
    return params, adamw_init(params)
