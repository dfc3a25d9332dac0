"""Server-side retry cache for at-most-once non-idempotent operations.

The port's copy of ``hadoop_tpu/ipc/retry_cache.py``, on the same wire
and disk formats.

Parity with the reference (ref: ipc/RetryCache.java): keyed by
(client_id, call_id); a retried request that already executed returns the
cached payload instead of re-executing; a request whose first execution is
still in flight blocks until it completes. Entries expire after a TTL.

Usage in a handler:
    cached = cache.wait_for_completion(ctx.client_id, ctx.call_id)
    if cached.done: return cached.payload
    try:    payload = do_mutation(); cache.complete(cached, True, payload)
    except: cache.complete(cached, False); raise
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Tuple


class CacheEntry:
    def __init__(self, key: Tuple[bytes, int]):
        self.key = key
        self.event = threading.Event()
        self.done = False
        self.success = False
        self.payload: Any = None
        self.expiry = 0.0


class RetryCache:
    def __init__(self, ttl_s: float = 600.0, max_entries: int = 65536):
        self.ttl_s = ttl_s
        self.max_entries = max_entries
        self._entries: Dict[Tuple[bytes, int], CacheEntry] = {}
        self._lock = threading.Lock()

    def wait_for_completion(self, client_id: bytes, call_id: int,
                            timeout: float = 60.0) -> CacheEntry:
        """Returns an entry. If entry.done, this is a replay — use
        entry.payload. Otherwise the caller owns execution and must call
        complete().

        At-most-once guarantee: a waiter never becomes a concurrent second
        executor. If the original execution fails, exactly one waiter takes
        ownership (via the retry loop below — the failed entry is evicted, so
        one waiter re-inserts and owns it). If the original is still running
        at ``timeout``, RetriableError tells the remote client to back off
        and retry rather than double-executing. Ref: ipc/RetryCache.java
        waitForCompletion semantics.
        """
        from hadoop_tpu_torch.ipc.errors import RetriableError

        key = (client_id, call_id)
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                self._evict_locked()
                entry = self._entries.get(key)
                if entry is None:
                    entry = CacheEntry(key)
                    entry.expiry = time.monotonic() + self.ttl_s
                    self._entries[key] = entry
                    return entry  # caller owns execution
            # Somebody else is executing (or executed) this call.
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not entry.event.wait(remaining):
                raise RetriableError(
                    "original execution of this call is still in progress")
            if entry.done:
                return entry  # completed replay
            # Original execution failed and was evicted: loop — one waiter
            # wins the re-insert and becomes the new executor.

    def complete(self, entry: CacheEntry, success: bool,
                 payload: Any = None) -> None:
        entry.success = success
        entry.payload = payload
        entry.done = success
        if not success:
            # Failed executions are retryable: remove so the retry re-executes.
            with self._lock:
                self._entries.pop(entry.key, None)
        entry.event.set()

    def _evict_locked(self) -> None:
        if len(self._entries) < self.max_entries:
            return
        now = time.monotonic()
        for k in [k for k, e in self._entries.items()
                  if e.done and e.expiry < now]:
            del self._entries[k]
        if len(self._entries) < self.max_entries:
            return
        # Capacity pressure: give up oldest COMPLETED entries early (a
        # lost replay payload only costs that client a duplicate-reply
        # miss). NEVER evict an in-flight entry — its retry would mint a
        # second concurrent executor of a non-idempotent op, the exact
        # thing this cache exists to prevent; if every entry is in
        # flight the cache temporarily overflows instead.
        for k in [k for k, e in self._entries.items() if e.done]:
            if len(self._entries) < self.max_entries:
                break
            del self._entries[k]

    def size(self) -> int:
        with self._lock:
            return len(self._entries)
