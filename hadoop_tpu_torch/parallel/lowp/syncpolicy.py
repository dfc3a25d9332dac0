"""Partially synchronized activations: per-layer tp sync schedules.

The counterpart of ``hadoop_tpu/parallel/lowp/syncpolicy.py`` (PST,
arXiv:2506.19645). The row-parallel reduce need not run on every layer
of every step: a scheduled-off layer skips it (each rank goes on with
its local partial) or takes it stale (the previous step's correction
stands in for this step's collective).

The schedule is resolved once, when the train step is built
(:func:`resolve_schedule`):

  parallel.lowp.sync.schedule   full | none | periodic:<k> | layers:<spec>
  parallel.lowp.sync.mode       skip | stale     (what an "off" layer does)

Clauses join with ``+``, later clauses refine earlier ones:

- ``full``: every layer syncs (the default).
- ``none``: no layer syncs (the falsifiability arm: the loss-curve guard
  must reject it).
- ``periodic:<k>``: layer ``i`` syncs iff ``i % k == 0``; ``periodic:1``
  is ``full``.
- ``layers:<i>=<mode>[,...]``: per-layer overrides (``mode`` one of
  sync, skip, stale; ``*`` is every layer), applied in spec order.

An off layer, at the row-parallel reduce (``ops/collective_matmul.py``
through :func:`scheduled_row_reduce`):

- **skip**: the psum becomes the rank's local partial times ``tp`` (its
  own sequence block of it under Megatron-SP). The backward is the exact
  collective's transpose (the identity for the psum, an all-gather for
  the scatter), never zero.
- **stale**: the layer consumes ``local + corr``, ``corr`` the previous
  step's ``exact - local`` for the site (no gradient), and emits this
  step's correction for the next step. The exact collective still runs,
  on values without gradient, and its bytes go to the ``tp.stale`` site.

A scheduled-off site records ``payload 0, executions 0`` against the
full reference bytes in the comm ledger, so the ledger shows the
collectives that did not run. The gain and the tolerance are the
reference's: a schedule is judged at ``parallel.lowp.sync.guard.rel-tol``
(2.0), the quantizers at ``parallel.lowp.guard.rel-tol`` (0.25).
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Tuple

import torch

from hadoop_tpu_torch.obs.comm import static_nbytes
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.lowp.quant import _record

SYNC_SCHEDULE_KEY = "parallel.lowp.sync.schedule"
SYNC_MODE_KEY = "parallel.lowp.sync.mode"

MODES = ("sync", "skip", "stale")
OFF_MODES = ("skip", "stale")


# ------------------------------------------------------- schedule parsing

def _parse_clauses(spec: str) -> Tuple[str, int, List[Tuple[Any, str]]]:
    """The grammar check: ``(base, k, overrides)`` or a ValueError.
    ``overrides`` keeps spec order (later refines earlier); the index
    range is the resolver's to check."""
    if not isinstance(spec, str) or not spec.strip():
        raise ValueError(
            f"{SYNC_SCHEDULE_KEY} must be a non-empty schedule spec, "
            f"got {spec!r}")
    base, k = "full", 1
    overrides: List[Tuple[Any, str]] = []
    seen_base = False
    for clause in spec.strip().split("+"):
        clause = clause.strip()
        if clause in ("full", "none"):
            if seen_base:
                raise ValueError(f"{SYNC_SCHEDULE_KEY}: more than one "
                                 f"base clause in {spec!r}")
            base, seen_base = clause, True
        elif clause.startswith("periodic:"):
            if seen_base:
                raise ValueError(f"{SYNC_SCHEDULE_KEY}: more than one "
                                 f"base clause in {spec!r}")
            try:
                k = int(clause[len("periodic:"):])
            except ValueError:
                raise ValueError(
                    f"{SYNC_SCHEDULE_KEY}: periodic:<k> needs an "
                    f"integer period, got {clause!r}") from None
            if k < 1:
                raise ValueError(f"{SYNC_SCHEDULE_KEY}: periodic "
                                 f"period must be >= 1, got {k}")
            base, seen_base = "periodic", True
        elif clause.startswith("layers:"):
            body = clause[len("layers:"):]
            if not body:
                raise ValueError(f"{SYNC_SCHEDULE_KEY}: empty layers: "
                                 f"override in {spec!r}")
            for item in body.split(","):
                item = item.strip()
                if "=" not in item:
                    raise ValueError(
                        f"{SYNC_SCHEDULE_KEY}: layers: overrides are "
                        f"<layer>=<mode>, got {item!r}")
                idx_s, mode = item.split("=", 1)
                mode = mode.strip()
                if mode not in MODES:
                    raise ValueError(
                        f"{SYNC_SCHEDULE_KEY}: mode must be one of "
                        f"{MODES}, got {mode!r} in {item!r}")
                idx_s = idx_s.strip()
                if idx_s == "*":
                    overrides.append(("*", mode))
                    continue
                try:
                    idx = int(idx_s)
                except ValueError:
                    raise ValueError(
                        f"{SYNC_SCHEDULE_KEY}: layer index must be an "
                        f"integer or '*', got {idx_s!r}") from None
                if idx < 0:
                    raise ValueError(f"{SYNC_SCHEDULE_KEY}: layer "
                                     f"index must be >= 0, got {idx}")
                overrides.append((idx, mode))
        else:
            raise ValueError(
                f"{SYNC_SCHEDULE_KEY}: unknown clause {clause!r} "
                f"(want full | none | periodic:<k> | layers:<spec>)")
    return base, k, overrides


def validate_spec(spec: str, off_mode: str = "skip") -> None:
    """The grammar alone (no layer count): what ParityConfig checks."""
    _parse_clauses(spec)
    if off_mode not in OFF_MODES:
        raise ValueError(f"{SYNC_MODE_KEY} must be one of {OFF_MODES}, "
                         f"got {off_mode!r}")


def resolve_schedule(spec: str, n_layers: int,
                     off_mode: str = "skip") -> Tuple[str, ...]:
    """The per-layer modes (``sync``, ``skip`` or ``stale``) of a spec
    over ``n_layers`` layers; an index out of range raises. A plan
    without tp has no sync to schedule: the caller passes none."""
    if off_mode not in OFF_MODES:
        raise ValueError(f"{SYNC_MODE_KEY} must be one of {OFF_MODES}, "
                         f"got {off_mode!r}")
    base, k, overrides = _parse_clauses(spec)
    if base == "full":
        modes = ["sync"] * n_layers
    elif base == "none":
        modes = [off_mode] * n_layers
    else:  # periodic
        modes = ["sync" if i % k == 0 else off_mode
                 for i in range(n_layers)]
    for idx, mode in overrides:
        if idx == "*":
            modes = [mode] * n_layers
            continue
        if idx >= n_layers:
            raise ValueError(
                f"{SYNC_SCHEDULE_KEY}: layer index {idx} out of range "
                f"for {n_layers} layers")
        modes[idx] = mode
    return tuple(modes)


@dataclasses.dataclass(frozen=True)
class SiteSync:
    """One reduce site's mode for the current layer; ``corr`` (stale
    only) is the previous step's correction for the site."""
    mode: str                      # "sync" | "skip" | "stale"
    corr: Optional[Any] = None


# ------------------------------------------------------- the reduce seam

def _site_and_ref(y, ctx):
    return ("tp.scatter" if ctx.megatron_sp else "tp.psum"), \
        static_nbytes(y)


def _own_block(v, ctx):
    """This rank's block of the sequence (dim 1)."""
    step = v.shape[1] // ctx.tp_size
    lo = ctx.tp.index * step
    return v[:, lo:lo + step]


class _Skip(torch.autograd.Function):
    """Forward: the local partial times ``tp`` (its own sequence block
    under Megatron-SP); backward: the exact reduce's transpose."""

    @staticmethod
    def forward(fctx, y, ctx):
        fctx.pctx = ctx
        return (_own_block(y, ctx) if ctx.megatron_sp else y) * ctx.tp_size

    @staticmethod
    def backward(fctx, g):
        ctx = fctx.pctx
        if ctx.megatron_sp:
            return spmd.all_gather_raw(g, ctx.tp, 1), None
        return g, None


def skip_row_reduce(y, ctx):
    """The scheduled-off reduce: the local partial scaled by ``tp`` (the
    row-parallel sum has ``tp`` parts of like size, so the bare partial
    would understate the layer's contribution by about 1/tp), its own
    sequence block under Megatron-SP; the backward is the exact
    collective's transpose. Records the site at payload 0, executions 0
    against the full reference bytes."""
    site, ref = _site_and_ref(y, ctx)
    _record(site, 0, ref, executions=0)
    return _Skip.apply(y, ctx)


def stale_row_reduce(y, ctx, corr):
    """The scheduled-stale reduce: ``out = skip(y) + corr`` (the previous
    step's correction, no gradient; no collective on this step's path)
    and this step's correction, ``exact - skip(y)`` of values without
    gradient, for the next step. The exact collective is recorded at
    the ``tp.stale`` site. Returns ``(out, new_corr)``."""
    local = skip_row_reduce(y, ctx)
    if tuple(corr.shape) != tuple(local.shape):
        raise ValueError(
            f"stale sync correction shape {tuple(corr.shape)} != reduce "
            f"output {tuple(local.shape)} (sync_state layout mismatch)")
    out = local + corr.detach().to(local.dtype)
    with torch.no_grad():
        y_sg = y.detach()
        _record("tp.stale", static_nbytes(y_sg), static_nbytes(y_sg))
        exact = spmd.psum_scatter_raw(y_sg, ctx.tp, 1) if ctx.megatron_sp \
            else spmd.psum_raw(y_sg, ctx.tp)
        new_corr = exact - local.detach()
    return out, new_corr


def scheduled_row_reduce(y, ctx, relaxed_sync: SiteSync):
    """One row-parallel reduce in its scheduled mode: skip returns the
    tensor, stale ``(out, new_corr)``."""
    if relaxed_sync.mode == "skip":
        return skip_row_reduce(y, ctx)
    if relaxed_sync.mode == "stale":
        if relaxed_sync.corr is None:
            raise ValueError("stale sync schedule reached the reduce "
                             "seam without a correction input")
        return stale_row_reduce(y, ctx, relaxed_sync.corr)
    raise ValueError(f"scheduled_row_reduce: unexpected mode "
                     f"{relaxed_sync.mode!r}")
