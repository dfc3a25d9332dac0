"""A-B acceptance for the relaxed parity tier, first part.

The counterpart of the numpy half of ``hadoop_tpu/parallel/lowp/guard.py``:
the relaxed tier's guards are statistical where the bitwise tier's are
``==``.

- :func:`allclose_guard` replaces a bitwise assert on values, reporting
  the max abs/rel divergence, so a failing guard says how far off.
- :func:`loss_curve_report` judges a loss curve against its twin: the
  smoothed per-step relative divergence stays within ``rel_tol`` and
  the judged run still learns. The elastic plane's acceptance uses it
  too (an evicted, resharded run against its uninterrupted twin).

``guard_rel_tol_for`` and ``run_loss_ab`` need ``ParityConfig`` and wait
for the relaxed tier (ROADMAP Queue A 6 item 4).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


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
