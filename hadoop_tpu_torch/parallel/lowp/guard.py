"""A-B acceptance for the relaxed parity tier.

The counterpart of ``hadoop_tpu/parallel/lowp/guard.py``: the relaxed
tier's guards are statistical where the bitwise tier's are ``==``.

- :func:`allclose_guard` replaces a bitwise assert on values, reporting
  the max abs/rel divergence, so a failing guard says how far off.
- :func:`loss_curve_report` judges a loss curve against its twin: the
  smoothed per-step relative divergence stays within ``rel_tol`` and
  the judged run still learns. The elastic plane's acceptance uses it
  too (an evicted, resharded run against its uninterrupted twin).
- :func:`run_loss_ab`: N training steps bitwise and relaxed from the
  same init and data, judged by ``loss_curve_report`` at the tolerance
  :func:`guard_rel_tol_for` picks. The reference runs it as one
  controller; the port's runs on every rank of a ``torch.distributed``
  world (or alone, for a one-device plan), as the ``Trainer`` does.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from hadoop_tpu_torch.parallel.lowp import (BITWISE_PARITY, ParityConfig,
                                            RELAXED_PARITY)


class ParityGuardError(AssertionError):
    """A relaxed-tier guard rejected: values or trajectories diverged
    past the configured bound."""


def _leaves(tree) -> List:
    """The leaves of nested dicts (in key order), lists and tuples."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [tree]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


def allclose_guard(name: str, ref, got, *, rtol: float = 1e-5,
                   atol: float = 1e-6) -> Dict:
    """The relaxed tier's replacement for a bitwise assert: compare two
    arrays or trees (tensors, numpy arrays, numbers), raise
    :class:`ParityGuardError` with the measured divergence when out of
    tolerance (``np.allclose``'s criterion), return the divergence report
    when within."""
    ref_leaves, got_leaves = _leaves(ref), _leaves(got)
    if len(ref_leaves) != len(got_leaves):
        raise ParityGuardError(
            f"{name}: tree arity {len(got_leaves)} != {len(ref_leaves)}")
    max_abs = 0.0
    max_rel = 0.0
    ok = True
    for a, b in zip(ref_leaves, got_leaves):
        a, b = _host(a), _host(b)
        if a.shape != b.shape:
            raise ParityGuardError(f"{name}: shape {b.shape} != {a.shape}")
        d = np.abs(a - b)
        max_abs = max(max_abs, float(d.max(initial=0.0)))
        denom = np.maximum(np.abs(a), atol)
        max_rel = max(max_rel, float((d / denom).max(initial=0.0)))
        if not np.all(d <= atol + rtol * np.abs(a)):
            ok = False
    report = {"max_abs": max_abs, "max_rel": max_rel,
              "rtol": rtol, "atol": atol}
    if not ok:
        raise ParityGuardError(
            f"{name}: allclose guard rejected (max_abs={max_abs:.3e}, "
            f"max_rel={max_rel:.3e}, rtol={rtol}, atol={atol})")
    return report


def _smooth(curve: np.ndarray, window: int) -> np.ndarray:
    """Trailing moving average (the head uses the running mean, so the
    early steps, where both curves are steep and close, still judge)."""
    if window <= 1 or curve.size <= 1:
        return curve
    out = np.empty_like(curve)
    for i in range(curve.size):
        lo = max(0, i - window + 1)
        out[i] = curve[lo:i + 1].mean()
    return out


def loss_curve_report(bitwise: Sequence[float],
                      relaxed: Sequence[float], *,
                      rel_tol: float = 0.25,
                      abs_floor: float = 1e-6,
                      smooth_window: int = 5) -> Dict:
    """Bounded-trajectory acceptance of a curve against its twin.

    Accepted iff (a) both curves are finite, (b) the max per-step
    relative divergence ``|r_t - b_t| / max(|b_t|, abs_floor)`` of the
    curves smoothed over ``smooth_window`` trailing steps stays within
    ``rel_tol``, and (c) a judged curve of 10 steps or more still learns
    (its final loss below its first). The raw per-step maximum is
    recorded too (``raw_max_rel_div``). A plain dict, so a run records
    it in its JSON."""
    b = np.asarray(list(bitwise), np.float64)
    r = np.asarray(list(relaxed), np.float64)
    report: Dict = {"steps": int(min(b.size, r.size)),
                    "rel_tol": rel_tol,
                    "bitwise_first": float(b[0]) if b.size else None,
                    "bitwise_final": float(b[-1]) if b.size else None,
                    "relaxed_first": float(r[0]) if r.size else None,
                    "relaxed_final": float(r[-1]) if r.size else None}
    if b.size == 0 or b.size != r.size:
        report.update(accepted=False,
                      reason=f"curve length mismatch {r.size}!={b.size}")
        return report
    if not (np.isfinite(b).all() and np.isfinite(r).all()):
        report.update(accepted=False, reason="non-finite loss")
        return report
    raw_div = np.abs(r - b) / np.maximum(np.abs(b), abs_floor)
    bs, rs = _smooth(b, smooth_window), _smooth(r, smooth_window)
    div = np.abs(rs - bs) / np.maximum(np.abs(bs), abs_floor)
    report["max_rel_div"] = float(div.max())
    report["mean_rel_div"] = float(div.mean())
    report["final_rel_div"] = float(div[-1])
    report["raw_max_rel_div"] = float(raw_div.max())
    if div.max() > rel_tol:
        report.update(accepted=False,
                      reason=f"max_rel_div {div.max():.4f} > {rel_tol}")
        return report
    if r.size >= 10 and not r[-1] < r[0]:
        report.update(accepted=False,
                      reason=f"relaxed curve did not learn "
                             f"({r[0]:.4f} -> {r[-1]:.4f})")
        return report
    report["accepted"] = True
    return report


def guard_rel_tol_for(parity: ParityConfig, n_layers: int, *,
                      tp: int = 1) -> float:
    """The loss-curve tolerance that judges ``parity``: the schedule
    tier's when the RESOLVED schedule turns a sync off (a schedule
    shifts the trajectory), else the quantizers' (``periodic:1``,
    ``layers:*=sync`` and a plan without tp build the full graph)."""
    from hadoop_tpu_torch.parallel.lowp.syncpolicy import resolve_schedule
    sched = resolve_schedule(
        parity.relaxed_sync, n_layers,
        off_mode=parity.relaxed_sync_mode) if tp > 1 else None
    if sched is not None and any(m != "sync" for m in sched):
        return parity.sync_guard_rel_tol
    return parity.guard_rel_tol


def _traffic() -> Dict[str, int]:
    from hadoop_tpu_torch.parallel import spmd
    return dict(spmd.traffic)


def _delta(after: Dict[str, Any], before: Dict[str, Any]) -> Dict[str, Any]:
    return {k: after[k] - before.get(k, 0) for k in after}


def run_loss_ab(plan, *, preset: str = "tiny", steps: int = 50,
                lr: float = 5e-3, batch: int = 8, seq: int = 32,
                zero1: bool = False, n_microbatches: int = 1,
                optimizer: str = "adamw", remat=False,
                parity: Optional[ParityConfig] = None,
                rel_tol: Optional[float] = None,
                bitwise_losses: Optional[Sequence[float]] = None,
                seed: int = 0, overrides: Optional[Dict[str, Any]] = None,
                weights=None, tokens=None, mesh=None, device=None,
                probe: Optional[Callable[[], Dict[str, int]]] = None
                ) -> Dict:
    """The loss-curve A-B: ``steps`` training steps bitwise and relaxed
    from the same init and data on ``plan``, the relaxed curve judged by
    :func:`loss_curve_report`. On a plan of more than one rank every
    rank of the world calls it (``mesh``: the plan's, made here if not
    given). Returns the report (never raises on a rejection): the
    judge's fields, ``plan``, ``codec``, ``sync_schedule``,
    ``sync_mode``, ``comm`` (the comm ledger of the first relaxed step:
    the reference's ledger is one trace, which is one step),
    ``comm_steps`` (every relaxed step's), both curves, and ``rank``:
    this rank's own measures a step and an arm (host seconds, the
    ``spmd.traffic`` bytes by axis, and ``probe()``'s counters, deltas
    over the arm). Everything but ``rank`` is the same on every rank.

    The data: ``tokens`` (a [batch, seq] integer array, which sets
    ``batch`` and ``seq``) or drawn from ``seed + 1``; targets the tokens
    rolled by one; the model's ``max_seq`` is ``max(seq, 32)`` unless
    ``overrides`` names it. The init:
    ``weights`` (a numpy tree, ``params_from_numpy``) or ``init_params``
    from ``seed``, the same for both arms. ``bitwise_losses``: a bitwise
    curve measured before for the same plan, steps and data, which
    skips the bitwise arm. ``lr`` 5e-3 keeps ``tiny`` descending for 50
    steps (the reference's default)."""
    from hadoop_tpu_torch.device import resolve_device
    from hadoop_tpu_torch.models import get_config
    from hadoop_tpu_torch.models.convert import params_from_numpy
    from hadoop_tpu_torch.models.decoder import init_params
    from hadoop_tpu_torch.parallel.lowp.quant import capture_comm
    from hadoop_tpu_torch.parallel.mesh import make_mesh
    from hadoop_tpu_torch.parallel.train import (init_sharded,
                                                 make_data_sharding,
                                                 make_train_step)

    if parity is None:
        parity = RELAXED_PARITY
    if tokens is not None:
        batch, seq = np.asarray(tokens).shape
    cfg = get_config(preset, **dict({"max_seq": max(seq, 32)},
                                    **(overrides or {})))
    if rel_tol is None:
        rel_tol = guard_rel_tol_for(parity, cfg.n_layers, tp=plan.tp)
    dev = resolve_device(device)
    if mesh is None and plan.n_devices > 1:
        mesh = make_mesh(plan)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                               generator=torch.Generator().manual_seed(
                                   seed + 1))
    tokens = torch.as_tensor(np.asarray(tokens)).long()
    targets = torch.roll(tokens, -1, dims=1)
    if mesh is not None:
        cut = make_data_sharding(mesh)
        tokens, targets = cut(tokens), cut(targets)
    tokens, targets = tokens.to(dev), targets.to(dev)
    rank: Dict[str, Any] = {}
    first: List[Any] = []       # the first relaxed step's ledger

    def run(tier: ParityConfig, arm: str) -> List[float]:
        step = make_train_step(cfg, plan, mesh, lr=lr, optimizer=optimizer,
                               zero1=zero1, n_microbatches=n_microbatches,
                               remat=remat, parity=tier, device=dev)
        full = params_from_numpy(weights, cfg, dev) if weights is not None \
            else init_params(cfg, torch.Generator(device=dev).manual_seed(
                seed), dev)
        if mesh is not None:
            params, opt = init_sharded(full, cfg, plan, mesh, zero1=zero1,
                                       optimizer=optimizer)
        else:
            from hadoop_tpu_torch.parallel.optimizer import adamw_init
            params, opt = full, adamw_init(full)
        del full
        losses, secs = [], []
        t0, c0 = _traffic(), probe() if probe is not None else {}
        for i in range(steps):
            s0 = time.monotonic()
            if i == 0 and tier.relaxed:
                with capture_comm() as led:
                    params, opt, m = step(params, opt, tokens, targets)
                first.append(led)
            else:
                params, opt, m = step(params, opt, tokens, targets)
            # the judge needs both whole curves on the host
            losses.append(float(m["loss"]))
            secs.append(time.monotonic() - s0)
        rank[arm] = {"step_s": secs, "traffic": _delta(_traffic(), t0)}
        if probe is not None:
            rank[arm]["probe"] = _delta(probe(), c0)
        return losses

    bit = [float(x) for x in bitwise_losses] \
        if bitwise_losses is not None else run(BITWISE_PARITY, "bitwise")
    with capture_comm() as ledger:
        rel = run(parity, "relaxed")
    report = loss_curve_report(bit, rel, rel_tol=rel_tol)
    report["plan"] = repr(plan)
    report["codec"] = parity.codec
    report["sync_schedule"] = parity.relaxed_sync
    report["sync_mode"] = parity.relaxed_sync_mode
    report["comm"] = first[0].report()
    report["comm_steps"] = ledger.report()
    if mesh is not None:
        # ranks hold their own stage's sites under pp: position 0's
        report["comm"], report["comm_steps"] = mesh.broadcast(
            (report["comm"], report["comm_steps"]))
    report["bitwise_losses"] = [round(x, 6) for x in bit]
    report["relaxed_losses"] = [round(x, 6) for x in rel]
    report["rank"] = rank
    return report

