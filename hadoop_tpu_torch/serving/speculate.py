"""N-gram / prompt-lookup draft proposal for speculative decoding.

The port's own copy of ``hadoop_tpu/serving/speculate.py`` (host Python,
no device work). The cheapest useful draft model is the request's own
history: serving traffic is full of self-similar token streams
(templated answers, code, retrieval echoes, and the short cycles greedy
decode settles into), so the tokens that followed the last n-gram *last
time* are a strong guess for what follows it now. ``NgramProposer``
keeps an O(1)-per-token index over one request's prompt + generated
tokens and proposes up to ``k`` draft tokens per step; the engine
verifies all of them in ONE batched forward inside its captured step
(see ``engine._step_impl``) and accepts the longest agreeing prefix.

Exactness is the engine's job, not the proposer's: a bad proposal costs
wasted verify rows, never a wrong token — greedy lanes accept a draft
only on argmax equality, sampled lanes rejection-sample against the
verifier distribution (the draft is a point mass, so the acceptance
test is ``u < p(draft)`` and a rejection re-samples from the target
with the draft token removed — the classic speculative-sampling
identity keeps the output distribution exactly the target's).

The index maps every ``min_n..max_n``-gram to the END position of its
most recent *interior* occurrence (n-grams ending at the current tip
are registered only when the next token arrives, so a lookup can never
match the tip against itself). Proposal chains: after predicting one
token the lookup repeats on the virtually-extended tail, so a period-p
cycle proposes whole periods up to ``k``, not just the p tokens that
physically follow the match.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class NgramProposer:
    """Per-request prompt-lookup index. Not thread-safe: owned and
    driven by the engine's scheduler thread only."""

    def __init__(self, tokens: Sequence[int], max_n: int = 3,
                 min_n: int = 1):
        if min_n < 1 or max_n < min_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"[{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n
        self._hist: List[int] = []
        # ngram tuple -> end index of its most recent occurrence that
        # is strictly behind the tip (registration is deferred by one
        # append, so the tip never matches itself)
        self._index: Dict[Tuple[int, ...], int] = {}
        self.extend(tokens)

    def __len__(self) -> int:
        return len(self._hist)

    def extend(self, tokens: Sequence[int]) -> None:
        for t in tokens:
            self.append(t)

    def append(self, tok: int) -> None:
        h = self._hist
        i = len(h) - 1          # old tip becomes interior: register it
        if i >= 0:
            for n in range(self.min_n, self.max_n + 1):
                if i - n + 1 < 0:
                    break
                self._index[tuple(h[i - n + 1:i + 1])] = i
        h.append(int(tok))

    def _next(self, ext: List[int]) -> Optional[int]:
        """Predict the token after ``history + ext`` by longest-n-gram
        lookup (longer context wins ties against staler matches)."""
        h = self._hist
        tail = h[-self.max_n:] + ext
        total = len(h) + len(ext)
        for n in range(min(self.max_n, total, len(tail)),
                       self.min_n - 1, -1):
            pos = self._index.get(tuple(tail[-n:]))
            if pos is not None:
                # index entries always end before the real tip, so the
                # continuation h[pos + 1] exists
                return h[pos + 1]
        return None

    def propose(self, k: int) -> List[int]:
        """Up to ``k`` draft tokens continuing the history. Chained:
        each prediction extends the virtual tail for the next lookup,
        so repeating structure proposes as deep as ``k`` allows."""
        out: List[int] = []
        if not self._hist:
            return out
        while len(out) < k:
            nxt = self._next(out)
            if nxt is None:
                break
            out.append(nxt)
        return out
