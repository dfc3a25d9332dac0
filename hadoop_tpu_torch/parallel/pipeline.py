"""Pipeline parallelism over the ``pp`` axis: GPipe, 1F1B and
interleaved 1F1B.

The counterpart of ``hadoop_tpu/parallel/pipeline.py`` (1F1B and its
interleaved form) and of the GPipe clock in ``hadoop_tpu/parallel/
train.py``. Each pp rank holds a contiguous slice of the stacked layers
(its v chunks of Lc layers under vpp = v, laid out by
``mesh.physical_layer_order``) and runs one clock over M microbatches
of its local batch. At each tick a rank runs at most one chunk forward
and one chunk backward, then posts the tick's hops together
(``spmd.hop_raw``): the forward's output to the next rank, the
backward's input cotangent to the previous one. A rank receives exactly
where its neighbour sends, which both work out from the clock, so the
number and order of hops agree on every rank and a tick that has
nothing to send sends nothing (where ``lax.ppermute`` moves masked
zeros). Virtual stage q = c·P + s is chunk c of rank s: q = 0 embeds,
q = V − 1 (V = v·P) ends in the loss head.

- **GPipe** (``gpipe_clock``): every microbatch's forward, keeping its
  autograd graph, then every backward in reverse order. Activation
  memory grows with M.
- **1F1B** (``one_f_one_b_clock``, the reference's ``M + 2P − 2``
  ticks): microbatch t − s forward, t − (2P − 2 − s) backward. The
  forward runs without a graph and stashes only the stage input; the
  backward recomputes the stage from it (activation checkpointing at
  stage boundaries), so at most 2P − 1 inputs are live on a rank.
- **Interleaved** (``interleaved_clock``, ``(M/P + 2)·V + P − 1``
  ticks; M must divide by P): the reference's ``fwd_coords`` /
  ``bwd_coords``; at most 2V inputs are live.

``run_schedule`` returns the sum of the M per-microbatch mean losses
(nonzero on the rank of the last virtual stage only) and this rank's
float32 gradient accumulators; the caller sums them over the data axes
and over ``pp`` for every leaf not sharded on it (stage 0 holds the
embedding's part, the last stage the head's and the final norm's) and
divides by M (``parallel/train.py``), through the overlap pass's
buckets: quantized ones under the relaxed parity tier, where the
reference's sums never reach its buckets (ROADMAP Queue C 9).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import embed_tokens, run_layers
from hadoop_tpu_torch.ops import rope_frequencies
from hadoop_tpu_torch.parallel import spmd

# (stage, tick) -> (microbatch, chunk) run there, or None
Coords = Callable[[int, int], Optional[Tuple[int, int]]]

SCHEDULES = ("1f1b", "gpipe", "interleaved")


@dataclasses.dataclass(frozen=True)
class Clock:
    """A schedule's clock for M microbatches on P ranks of v chunks:
    ``n_ticks``, the forward and backward ``Coords``, and whether the
    backward recomputes the stage from its stashed input (else the
    forward keeps its graph)."""
    M: int
    P: int
    v: int
    n_ticks: int
    fwd: Coords
    bwd: Coords
    recompute: bool


def gpipe_clock(M: int, P: int) -> Clock:
    """M + P − 1 forward ticks (microbatch t − s), then as many backward
    ticks, the last stage first."""
    T = M + P - 1

    def fwd(s, t):
        m = t - s
        return (m, 0) if t < T and 0 <= m < M else None

    def bwd(s, t):
        m = M - 1 - (t - T - (P - 1 - s))
        return (m, 0) if t >= T and 0 <= m < M else None
    return Clock(M, P, 1, 2 * T, fwd, bwd, recompute=False)


def one_f_one_b_clock(M: int, P: int) -> Clock:
    """The reference's 1F1B clock: M + 2P − 2 ticks."""
    def fwd(s, t):
        m = t - s
        return (m, 0) if 0 <= m < M else None

    def bwd(s, t):
        m = t - (2 * P - 2 - s)
        return (m, 0) if 0 <= m < M else None
    return Clock(M, P, 1, M + 2 * P - 2, fwd, bwd, recompute=True)


def interleaved_clock(M: int, P: int, v: int) -> Clock:
    """The reference's interleaved clock (``fwd_coords``/``bwd_coords``):
    the forward of (m, q = cP + s) at (m÷P)·V + cP + (m mod P) + s, its
    backward at (m÷P)·V + (m mod P) + 2V − 1 − q."""
    if M % P:
        raise ValueError(f"interleaved schedule needs n_microbatches "
                         f"({M}) divisible by pp ({P})")
    V = v * P

    def fwd(s, t):
        u = t - s
        if u < 0:
            return None
        w = u % V
        m = (u // V) * P + w % P
        return (m, w // P) if m < M else None

    def bwd(s, t):
        z = t + s - (V - 1)
        if z < 0:
            return None
        w = z % V
        cc = w // P
        m = (z // V - (cc == 0)) * P + w % P
        return (m, 0 if cc == 0 else v - cc) if 0 <= m < M else None
    return Clock(M, P, v, (M // P + 2) * V + P - 1, fwd, bwd,
                 recompute=True)


def make_clock(schedule: str, M: int, P: int, v: int) -> Clock:
    """The clock of ``schedule`` ("1f1b" with v > 1 is interleaved, as
    in the reference)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"pipeline_schedule={schedule!r} (choices: "
                         f"{', '.join(SCHEDULES)})")
    if schedule == "interleaved" or v > 1:
        if schedule == "gpipe":
            raise ValueError("gpipe runs one chunk a rank (vpp 1)")
        return interleaved_clock(M, P, v)
    if schedule == "gpipe":
        return gpipe_clock(M, P)
    return one_f_one_b_clock(M, P)


def interleaved_layer_permutation(n_layers: int, pp: int, v: int
                                  ) -> List[int]:
    """Physical → logical layer order of the interleaved layout: rank s
    holds chunks {c·pp + s}, virtual stage q covering logical layers
    [q·Lc, (q+1)·Lc); physical position (s·v + c)·Lc + i holds logical
    layer (c·pp + s)·Lc + i. ``stacked[perm]`` lays a logically ordered
    stack out physically; ``argsort(perm)`` undoes it."""
    if n_layers % (pp * v):
        raise ValueError(f"n_layers={n_layers} not divisible by "
                         f"pp*v={pp * v}")
    lc = n_layers // (pp * v)
    perm = []
    for s in range(pp):
        for c in range(v):
            q = c * pp + s
            perm.extend(range(q * lc, (q + 1) * lc))
    return perm


def stage_body(params, tok, tgt, x_in, first: bool, last: bool,
               cfg: ModelConfig, ctx, cos, sin, attn_impl: str, remat,
               loss_from_h):
    """One virtual stage on one microbatch: the embedding at the first
    (else ``x_in``), the chunk's layers (``params["layers"]``, stacked;
    ``cfg``'s n_layers is their count), the loss head at the last.
    Returns (y, loss or None)."""
    x = embed_tokens(params, tok, cfg, ctx) if first else x_in
    y = run_layers(x, params["layers"], cfg, cos, sin, attn_impl, remat,
                   ctx)
    return y, (loss_from_h(params, y, tgt, cfg, ctx) if last else None)


def run_schedule(params, tokens, targets, *, clock: Clock,
                 cfg: ModelConfig, ctx, pp: spmd.Axis, remat,
                 attn_impl: str, loss_from_h
                 ) -> Tuple[torch.Tensor, Dict[str, Any], Dict[str, int]]:
    """This rank's part of one pipelined step. ``params``: this rank's
    shards (layer leaves [v·Lc, ...]); ``tokens``/``targets``: its
    [B_local, S_local] batch, cut into M microbatches of rows. Returns
    (the sum of the last stage's per-microbatch mean losses, a float32
    0-d tensor; float32 gradients shaped like ``params``; stats: the
    stage, ticks, and the most stage inputs stashed at once)."""
    M, P, v = clock.M, clock.P, clock.v
    s, V = pp.index, clock.v * clock.P
    dev = params["embed"].device
    tok_mb = tokens.reshape(M, -1, tokens.shape[-1])
    tgt_mb = targets.reshape(M, -1, targets.shape[-1])
    n_local = next(iter(params["layers"].values())).shape[0]
    lc = n_local // v
    scfg = dataclasses.replace(cfg, n_layers=lc)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device=dev)
    seq = tokens.shape[-1] // (ctx.tp_size if ctx.megatron_sp else 1)
    like = torch.empty((tok_mb.shape[1], seq, cfg.d_model),
                       dtype=cfg.torch_dtype, device=dev)
    # the leaves each chunk differentiates: its slice of each stacked
    # layer leaf, and the whole of every other leaf
    rest = {k: p.detach().requires_grad_() for k, p in params.items()
            if k != "layers"}
    chunks = [{k: p[c * lc:(c + 1) * lc].detach().requires_grad_()
               for k, p in params["layers"].items()} for c in range(v)]
    gacc = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
            for k, p in params.items() if k != "layers"}
    gacc["layers"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                     device=dev)
                      for k, p in params["layers"].items()}
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    stash: Dict[Tuple[int, int], Any] = {}
    peak = 0
    recv_f = recv_b = None

    def run(m, c, x_in):
        q = c * P + s
        return stage_body(dict(rest, layers=chunks[c]), tok_mb[m],
                          tgt_mb[m], x_in,
                          q == 0, q == V - 1, scfg, ctx, cos, sin,
                          attn_impl, remat, loss_from_h)

    def q_of(coords, rank):
        return None if coords is None else coords[1] * P + rank

    for t in range(clock.n_ticks):
        out_f = out_b = None
        f = clock.fwd(s, t)
        if f is not None:
            q = f[1] * P + s
            x_in = None if q == 0 else recv_f
            if clock.recompute:
                with torch.no_grad():
                    y, loss = run(*f, x_in)
                stash[f] = x_in
            else:
                with torch.enable_grad():
                    x_in = None if x_in is None else \
                        x_in.detach().requires_grad_()
                    y, loss = run(*f, x_in)
                stash[f] = (x_in, y, loss)
            peak = max(peak, len(stash))
            if loss is not None:
                loss_sum += loss.detach().float()
            else:
                out_f = y.detach()
        b = clock.bwd(s, t)
        if b is not None:
            q = b[1] * P + s
            if clock.recompute:
                x_in = stash.pop(b)
                with torch.enable_grad():
                    if x_in is not None:
                        x_in = x_in.requires_grad_()
                    y, loss = run(*b, x_in)
            else:
                x_in, y, loss = stash.pop(b)
            root, cot = (loss, None) if q == V - 1 else (y, recv_b)
            leaves = list(chunks[b[1]].values()) + list(rest.values())
            grads = torch.autograd.grad(
                root, leaves + ([x_in] if x_in is not None else []), cot,
                allow_unused=True)
            c0 = b[1] * lc
            for key, g in zip(chunks[b[1]], grads):
                gacc["layers"][key][c0:c0 + lc] += g
            for key, g in zip(rest, grads[len(chunks[b[1]]):]):
                if g is not None:
                    gacc[key] += g
            if x_in is not None:
                out_b = grads[-1]
            del root, cot, grads, y, loss
        # the tick's hops: what this rank sends, and what its neighbours
        # send it by the same clock
        sends = [(x, shift, tag) for x, shift, tag in
                 ((out_f, 1, 0), (out_b, -1, 1)) if x is not None]
        want_f = q_of(clock.fwd((s - 1) % P, t), (s - 1) % P) not in (
            None, V - 1)
        want_b = q_of(clock.bwd((s + 1) % P, t), (s + 1) % P) not in (
            None, 0)
        recvs = [(like, 1, 0)] * want_f + [(like, -1, 1)] * want_b
        got = spmd.hop_raw(pp, sends, recvs) if sends or recvs else []
        recv_f = got.pop(0) if want_f else None
        recv_b = got.pop(0) if want_b else None
    if stash:
        raise RuntimeError(f"pipeline clock left {sorted(stash)} stashed")
    return loss_sum, gacc, {"stage": s, "ticks": clock.n_ticks,
                            "stash_peak": peak}
