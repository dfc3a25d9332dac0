"""AdamW on one device.

The counterpart of ``hadoop_tpu/parallel/optimizer.py``'s ``AdamWState``,
``adamw_init`` and ``adamw_update``: b1 0.9, b2 0.95, eps 1e-8, gradients
clipped to global norm 1.0, decoupled weight decay 0.1 on tensors with
``ndim >= 2``, bias correction from ``count``. Moments are float32; the
parameters stay in their own dtype with no master copy, as in the
reference. Unlike the reference's pure function, ``adamw_update`` updates
the parameters and moments in place and returns the same trees. ZeRO-1
comes with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    count: int             # steps taken
    mu: Dict[str, Any]     # tree like params, float32
    nu: Dict[str, Any]     # tree like params, float32


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def adamw_init(params) -> AdamWState:
    """Zero float32 moments shaped like ``params``, on their devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(0, tree_map(zeros, params), tree_map(zeros, params))


def grad_sq(grads) -> torch.Tensor:
    """Squared global norm of a gradient tree, in float32."""
    return sum(g.float().square().sum() for g in tree_leaves(grads))


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, lr: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 gsq: Optional[torch.Tensor] = None):
    """One AdamW step, in place: the float32 moments of ``state`` and the
    parameters (cast back to their dtype) are overwritten. Returns
    ``(params, AdamWState(count + 1, mu, nu), grad_norm)`` with the same
    trees. ``gsq``: squared global gradient norm, if the caller has it."""
    count = state.count + 1
    if gsq is None:
        gsq = grad_sq(grads)
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    bc1 = 1.0 - b1 ** count
    bc2 = 1.0 - b2 ** count

    def leaf(p, g, m, n):
        g = g.float() * scale
        m.mul_(b1).add_(g, alpha=1 - b1)
        n.mul_(b2).add_(g.square(), alpha=1 - b2)
        update = (m / bc1) / (torch.sqrt(n / bc2) + eps)
        if p.ndim >= 2:
            update = update + weight_decay * p.float()
        p.copy_(p.float() - lr * update)

    tree_map(leaf, params, grads, state.mu, state.nu)
    return params, AdamWState(count, state.mu, state.nu), gnorm
