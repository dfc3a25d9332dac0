"""Refcounted fixed pool of KV-cache pages — the device tier's allocator.

The port's own copy of ``hadoop_tpu/serving/kvstore/pool.py``: the pool
is the refcount truth for every resident page.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional


class BlockPool:
    """Refcounted fixed pool of KV-cache pages. Block 0 is reserved
    scratch (padding and inactive lanes scatter there), so
    ``num_blocks - 1`` are allocatable.

    Lifecycle: ``alloc`` hands out pages at refcount 1; prefix sharing
    ``incref``s a page per additional mapper; ``decref`` drops one
    mapping and reports pages that reached zero WITHOUT freeing them —
    the engine decides whether a zero-ref page stays resident as prefix
    cache or returns to the free list via ``free``. ``free`` refuses
    pages still shared (refcount > 1), so a preemption can never yank a
    page out from under a sibling."""

    SCRATCH = 0

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is scratch)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = deque(range(1, num_blocks))  # guarded-by: _lock
        self._ref = [0] * num_blocks              # guarded-by: _lock
        self._lock = threading.Lock()

    @property
    def num_usable(self) -> int:
        return self.num_blocks - 1

    @property
    def num_free(self) -> int:
        with self._lock:
            return len(self._free)

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    def alloc(self, n: int) -> Optional[List[int]]:
        with self._lock:
            if n > len(self._free):
                return None
            out = [self._free.popleft() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def incref(self, blocks: List[int]) -> None:
        with self._lock:
            for b in blocks:
                if b == self.SCRATCH:
                    raise ValueError("incref of the scratch block")
                self._ref[b] += 1

    def decref(self, blocks: List[int]) -> List[int]:
        """Drop one reference per block; returns the blocks that hit
        zero (now unmapped — cacheable or freeable, caller's call)."""
        released = []
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(f"decref of unreferenced block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    released.append(b)
        return released

    def free(self, blocks: List[int]) -> None:
        with self._lock:
            for b in blocks:
                if b == self.SCRATCH:
                    raise ValueError("freeing the scratch block")
                if self._ref[b] > 1:
                    raise ValueError(
                        f"freeing block {b} still shared "
                        f"(refcount {self._ref[b]}) — decref instead")
                self._ref[b] = 0
                self._free.append(b)
