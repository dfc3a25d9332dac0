"""AdamW on one device.

The counterpart of ``hadoop_tpu/parallel/optimizer.py``'s ``AdamWState``,
``adamw_init`` and ``adamw_update``: b1 0.9, b2 0.95, eps 1e-8, gradients
clipped to global norm 1.0, decoupled weight decay 0.1 on tensors with
``ndim >= 2``, bias correction from ``count``. Moments are float32; the
parameters stay in their own dtype with no master copy, as in the
reference. Unlike the reference's pure function, ``adamw_update`` updates
the parameters and moments in place and returns the same trees.

ZeRO-1 (``zero1_update``, the reference's Megatron-style distributed
optimizer): a leaf replicated over the data axes keeps only its slice
of the moments on each rank (``parallel/overlap.py`` defines the slice
layout); each rank updates its slice of the parameter and the slices
are gathered back into the whole leaf on every rank.

On CUDA tensors the update of each leaf is one pass of the hand-written
kernel ``ops/csrc/adamw.cu`` (the reference's step is fused by XLA; the
same arithmetic run eagerly would be ~19 elementwise kernels per leaf),
and ``grad_sq`` is its reduction, which reads each gradient in its own
dtype. On CPU tensors both are their plain versions, ``adamw_leaf_ref``
and ``grad_sq_ref``. ``launches`` and ``launches_grad_sq`` count the
kernels' launches.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from hadoop_tpu_torch.ops import _build
from hadoop_tpu_torch.parallel import overlap, spmd

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_CHUNK = 1 << 30            # elements per launch: the C entries count in int
_SUMSQ_BLOCKS = 1024        # most partials per piece of a gradient
_SUMSQ_PER_BLOCK = 4096     # fewest elements per partial

launches = 0                # adamw.cu update launches
launches_grad_sq = 0        # adamw.cu squared-norm launches (pieces + finish)


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


# ---------------------------------------------------------- plain versions

def grad_sq_ref(grads) -> torch.Tensor:
    """Plain version of the squared global norm of a gradient tree, in
    float32."""
    return sum(g.float().square().sum() for g in tree_leaves(grads))


def adamw_leaf_ref(p, g, m, n, scale, hyper: Dict[str, float],
                   decay: bool) -> None:
    """Plain version of the kernel on one leaf, in place: p, and the
    float32 moments m and n. ``hyper`` as ``_hyper`` gives it."""
    g = g.float() * scale
    m.mul_(hyper["b1"]).add_(g, alpha=hyper["one_minus_b1"])
    n.mul_(hyper["b2"]).add_(g.square(), alpha=hyper["one_minus_b2"])
    update = (m / hyper["bc1"]) / (torch.sqrt(n / hyper["bc2"])
                                   + hyper["eps"])
    if decay:
        update = update + hyper["weight_decay"] * p.float()
    p.copy_(p.float() - hyper["lr"] * update)


def _hyper(count: int, lr, b1, b2, eps, weight_decay) -> Dict[str, float]:
    """The update's scalars, in the order the kernel takes them, computed
    in double (each is rounded to float32 once where it meets a tensor)."""
    return {"b1": b1, "one_minus_b1": 1 - b1, "b2": b2,
            "one_minus_b2": 1 - b2, "bc1": 1.0 - b1 ** count,
            "bc2": 1.0 - b2 ** count, "eps": eps,
            "weight_decay": weight_decay, "lr": lr}


# ------------------------------------------------------------ the kernels

def _pieces(*tensors):
    """Flat views of same-sized contiguous tensors, in pieces of at most
    ``_CHUNK`` elements."""
    flat = [t.view(-1) for t in tensors]
    for start in range(0, flat[0].numel(), _CHUNK):
        yield [f[start:start + _CHUNK] for f in flat]


def _check_leaf(p, g, m, n, scale) -> None:
    dev = p.device
    if not (p.is_cuda and all(t.device == dev for t in (g, m, n, scale))):
        raise ValueError("adamw kernel: p, g, m, n and the scale must lie "
                         "on one CUDA device")
    if p.dtype not in _DTYPES or g.dtype != p.dtype or \
            m.dtype != torch.float32 or n.dtype != torch.float32 or \
            scale.dtype != torch.float32 or scale.numel() != 1:
        raise ValueError(
            f"adamw kernel: p {p.dtype}, g {g.dtype}, m {m.dtype}, n "
            f"{n.dtype}, scale {scale.dtype} {tuple(scale.shape)}; it takes "
            f"p and g of one of {list(_DTYPES)}, float32 moments and a "
            f"float32 scalar scale")
    if not (g.shape == m.shape == n.shape == p.shape):
        raise ValueError(f"adamw kernel: shapes p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, m {tuple(m.shape)}, n "
                         f"{tuple(n.shape)}")
    if not all(t.is_contiguous() for t in (p, m, n)):
        raise ValueError("adamw kernel: p, m and n must be contiguous (they "
                         "are updated in place)")


def _launch_adamw(p, g, m, n, scale, hyper: Dict[str, float],
                  decay: bool) -> None:
    """The update kernel on one leaf, in place, one launch per piece."""
    global launches
    _check_leaf(p, g, m, n, scale)
    g = g.contiguous()
    for pp, gp, mp, np_ in _pieces(p, g, m, n):
        _build.launch("htpu_adamw", pp, gp, mp, np_, scale, pp.numel(),
                      _DTYPES[p.dtype], int(decay), *hyper.values())
        launches += 1


def _launch_grad_sq(leaves: List[torch.Tensor]) -> torch.Tensor:
    """Squared global norm by the kernel: one partial launch per piece of
    each gradient, then one finishing launch; float32 0-d."""
    global launches_grad_sq
    dev = leaves[0].device
    if not all(g.is_cuda and g.device == dev and g.dtype in _DTYPES
               for g in leaves):
        raise ValueError("grad_sq kernel: gradients must lie on one CUDA "
                         f"device with dtypes among {list(_DTYPES)}")
    pieces = [piece for g in leaves for (piece,) in _pieces(g.contiguous())]
    blocks = [min(-(-x.numel() // _SUMSQ_PER_BLOCK), _SUMSQ_BLOCKS)
              for x in pieces]
    partials = torch.empty(sum(blocks), dtype=torch.float32, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    offset = 0
    for x, nb in zip(pieces, blocks):
        _build.launch("htpu_grad_sq_partial", x, partials[offset:],
                      x.numel(), nb, _DTYPES[x.dtype])
        launches_grad_sq += 1
        offset += nb
    _build.launch("htpu_grad_sq_finish", partials, out, offset)
    launches_grad_sq += 1
    return out


# ---------------------------------------------------------------- public

def grad_sq(grads) -> torch.Tensor:
    """Squared global norm of a gradient tree, in float32: the kernel for
    CUDA tensors, the plain version for CPU tensors."""
    leaves = [g for g in tree_leaves(grads) if g.numel()]
    if leaves and leaves[0].is_cuda:
        return _launch_grad_sq(leaves)
    return grad_sq_ref(grads)


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
    hyper = _hyper(count, lr, b1, b2, eps, weight_decay)

    def leaf(p, g, m, n):
        if p.is_cuda:
            _launch_adamw(p, g, m, n, scale, hyper, p.ndim >= 2)
        else:
            adamw_leaf_ref(p, g, m, n, scale, hyper, p.ndim >= 2)

    tree_map(leaf, params, grads, state.mu, state.nu)
    return params, AdamWState(count, state.mu, state.nu), gnorm


# ------------------------------------------------------------------ ZeRO-1

def zero1_leaf_plan(spec_axes: Sequence[str], data_axes: Sequence[str]
                    ) -> Tuple[str, ...]:
    """Data axes a leaf's state is partitioned over: the data axes the
    leaf is not already sharded on."""
    return tuple(a for a in data_axes if a not in spec_axes)


def zero1_init_local(local_shape, z: int, device=None) -> torch.Tensor:
    """Zeros for one leaf's per-rank (K,) moment slice."""
    numel = 1
    for n in local_shape:
        numel *= n
    return torch.zeros((-(-numel // z),), dtype=torch.float32,
                       device=device)


@torch.no_grad()
def zero1_update(params, grads, state: AdamWState, lr: float, *,
                 leaf_axes, gsq: torch.Tensor, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0,
                 gather_bucket_bytes: int = 0, gather_relaxed=None,
                 gather_vma=None):
    """One ZeRO-1 AdamW step, in place. ``leaf_axes``: per leaf, the
    ``spmd.Axis`` tuple its state is partitioned over; ``grads`` are
    this rank's (K,) slices of the gradients summed over the data axes,
    ``state``'s moments its (K,) float32 slices. Each rank updates its
    slice of each parameter (the kernel on CUDA tensors) and the slices are gathered into the whole leaves: through
    ``overlap.bucketed_gather_slices`` when ``gather_bucket_bytes`` > 0,
    else one ``all_gather`` per leaf. ``gather_relaxed`` (the relaxed
    tier, with bucketed gathers): the slices cross the wire quantized,
    bucketed by ``gather_vma`` as the reference's, and the parameters
    (this rank's slice too) become the dequantized copy, as the
    reference's do. Returns ``(params, AdamWState, grad_norm)``."""
    count = state.count + 1
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    hyper = _hyper(count, lr, b1, b2, eps, weight_decay)
    flat_p, rebuild = overlap.flatten(params)
    flat_g, _ = overlap.flatten(grads)
    flat_m, _ = overlap.flatten(state.mu)
    flat_n, _ = overlap.flatten(state.nu)
    flat_a, _ = overlap.flatten(leaf_axes)
    slices = []
    for p, g, m, n, axes in zip(flat_p, flat_g, flat_m, flat_n, flat_a):
        ps = overlap.local_slice(p, axes).clone()
        gs = g.contiguous()
        m, n = m.view(-1), n.view(-1)
        if ps.is_cuda:
            _launch_adamw(ps, gs, m, n, scale, hyper, p.ndim >= 2)
        else:
            adamw_leaf_ref(ps, gs, m, n, scale, hyper, p.ndim >= 2)
        slices.append(ps)
    if gather_bucket_bytes > 0:
        whole, _ = overlap.flatten(overlap.bucketed_gather_slices(
            rebuild(slices), params, leaf_axes, gather_bucket_bytes,
            relaxed=gather_relaxed, vma=gather_vma))
    else:
        whole = [_gather_leaf(s, p, axes)
                 for s, p, axes in zip(slices, flat_p, flat_a)]
    for p, w in zip(flat_p, whole):
        p.copy_(w)
    return params, AdamWState(count, state.mu, state.nu), gnorm


def _gather_leaf(piece: torch.Tensor, like: torch.Tensor, axes
                 ) -> torch.Tensor:
    """One leaf from every rank's slice (the last axis gathered first, so
    the slices land in mixed-radix order)."""
    buf = piece[None]
    for a in reversed(axes):
        buf = spmd.all_gather_raw(buf, a, 0)
    return buf.reshape(-1)[:like.numel()].view(like.shape)
