"""A-B acceptance for the long-context prefill.

The counterpart of ``hadoop_tpu/serving/longctx/guard.py``. The CP
softmax reassociation (online-softmax merges across ranks) is not
bitwise against the single-device forward, so the prefill ships behind
a two-mode guard:

- **exact** (small shapes): the CP prefill's last-token logits within a
  tight atol of the single-device forward's AND the same greedy argmax.
- **relaxed** (at scale): bounded relative logit divergence plus argmax
  agreement.

Both return a plain report dict and raise ``ParityGuardError`` on
rejection.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from hadoop_tpu_torch.models.decoder import (final_hidden, forward_hidden,
                                             head_matrix)


class ParityGuardError(AssertionError):
    """A relaxed-tier guard rejected: values or trajectories diverged
    past the configured bound."""


def longctx_ab_report(ref_logits, cp_logits, *, mode: str = "exact",
                      rel_tol: float = 0.05,
                      exact_atol: float = 5e-4) -> Dict:
    """Judge CP last-token logits against the single-device reference.
    Raises :class:`ParityGuardError` on rejection, returns the
    divergence report on acceptance."""
    ref = np.asarray(ref_logits, np.float32).reshape(-1)
    got = np.asarray(cp_logits, np.float32).reshape(-1)
    if ref.shape != got.shape:
        raise ParityGuardError(
            f"longctx guard: logits shape {got.shape} != {ref.shape}")
    d = np.abs(ref - got)
    max_abs = float(d.max(initial=0.0))
    max_rel = float((d / np.maximum(np.abs(ref), 1e-6)).max(initial=0.0))
    agree = int(np.argmax(ref)) == int(np.argmax(got))
    report = {"mode": mode, "max_abs": max_abs, "max_rel": max_rel,
              "argmax_agree": agree}
    if mode == "exact":
        report["atol"] = exact_atol
        ok = agree and max_abs <= exact_atol
    elif mode == "relaxed":
        report["rel_tol"] = rel_tol
        ok = agree and max_rel <= rel_tol
    else:
        raise ValueError(f"guard mode must be exact|relaxed, got {mode!r}")
    report["accepted"] = ok
    if not ok:
        raise ParityGuardError(
            f"longctx {mode} guard rejected: max_abs={max_abs:.3e}, "
            f"max_rel={max_rel:.3e}, argmax_agree={agree}")
    return report


@torch.no_grad()
def _reference_last_logits(params, cfg, tokens: List[int],
                          device) -> np.ndarray:
    """The single-device forward's last-token logits [V] float32:
    ``forward_hidden`` over the whole prompt, then the final norm and the
    head on the last row only (no [S, V] logits tensor)."""
    toks = torch.as_tensor([tokens], dtype=torch.long, device=device)
    h = forward_hidden(params, toks, cfg)
    row = final_hidden(params, h[0, -1], cfg)
    return (row @ head_matrix(params, cfg, row.dtype)).float().cpu().numpy()


def run_prefill_ab(params, cfg, tokens: List[int], prefiller, *,
                   mode: str = "exact", rel_tol: float = 0.05,
                   exact_atol: float = 5e-4) -> Dict:
    """The prefill A-B: CP prefill of ``tokens`` on ``prefiller`` against
    the single-device forward's last-token logits, on the prefiller's
    device."""
    ref = _reference_last_logits(params, cfg, tokens, prefiller.ring.device)
    res = prefiller.cp_prefill(tokens)
    report = longctx_ab_report(ref, res.last_logits, mode=mode,
                               rel_tol=rel_tol, exact_atol=exact_atol)
    report.update(chips=res.chips, sp_mode=res.sp_mode,
                  prompt_tokens=len(tokens),
                  prefill_seconds=round(res.seconds, 4))
    return report
