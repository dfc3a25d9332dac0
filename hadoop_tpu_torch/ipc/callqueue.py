"""The RPC server's call queues and schedulers (server-side QoS).

The port's copy of ``hadoop_tpu/ipc/callqueue.py``:

- :class:`CallQueueManager` owns a queue and a scheduler, keeps the
  capacity and, with ``<prefix>.backoff.enable``, raises
  ``ServerTooBusyError`` when the queue is full (the server turns it into
  a retryable error reply); without backoff a put waits up to 60 s.
- :class:`DefaultRpcScheduler`: every caller at priority 0, one FIFO.
- :class:`DecayRpcScheduler`: per-caller call counts decayed by
  ``ipc.decay-scheduler.decay-factor`` every
  ``ipc.decay-scheduler.period``; a caller whose share of the calls
  passes ``thresholds[i]`` gets level i + 1 or worse.
- :class:`FairCallQueue`: one sub-queue a level, taken by weighted
  round-robin (weights 2^(L-1-i)), so a light caller overtakes a heavy
  one and no level starves.

``<prefix>.callqueue.impl`` is ``fifo`` or ``fair``,
``<prefix>.scheduler.impl`` ``default`` or ``decay`` (``decay`` by
default under ``fair``), ``<prefix>.scheduler.priority.levels`` the
number of levels (4).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, List, Optional

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.ipc.errors import ServerTooBusyError


class DefaultRpcScheduler:
    """Everything at priority 0."""

    num_levels = 1

    def __init__(self, num_levels: int = 1,
                 conf: Optional[ConfLike] = None):
        pass

    def priority(self, caller: str) -> int:
        return 0

    def add_response_time(self, caller: str, priority: int,
                          elapsed_s: float) -> None:
        pass

    def stop(self) -> None:
        pass


class DecayRpcScheduler:
    """Usage-share priority with exponential decay."""

    def __init__(self, num_levels: int = 4,
                 conf: Optional[ConfLike] = None):
        conf = conf or Configuration(load_defaults=False)
        self.num_levels = num_levels
        self.decay_period_s = conf.get_time_seconds(
            "ipc.decay-scheduler.period", 5.0)
        self.decay_factor = conf.get_float(
            "ipc.decay-scheduler.decay-factor", 0.5)
        # by default a share past 1/2^(L-i) puts a caller at level i
        raw = conf.get_list("ipc.decay-scheduler.thresholds")
        if raw:
            self.thresholds = [float(t) for t in raw]
        else:
            self.thresholds = [1.0 / (2 ** (num_levels - i))
                               for i in range(1, num_levels)]
        self._counts: dict = {}        # guarded-by: _lock
        self._total = 0.0              # guarded-by: _lock
        self._lock = threading.Lock()
        self._stop = threading.Event()
        threading.Thread(target=self._decay_loop, daemon=True,
                         name="decay-scheduler").start()

    def _decay_loop(self) -> None:
        while not self._stop.wait(self.decay_period_s):
            with self._lock:
                dead = []
                self._total = 0.0
                for caller, count in self._counts.items():
                    count *= self.decay_factor
                    if count < 0.5:
                        dead.append(caller)
                    else:
                        self._counts[caller] = count
                        self._total += count
                for caller in dead:
                    del self._counts[caller]

    def priority(self, caller: str) -> int:
        with self._lock:
            self._counts[caller] = self._counts.get(caller, 0.0) + 1.0
            self._total += 1.0
            share = self._counts[caller] / self._total if self._total \
                else 0.0
        level = 0
        for i, th in enumerate(self.thresholds):
            if share >= th:
                level = i + 1
        return min(level, self.num_levels - 1)

    def add_response_time(self, caller: str, priority: int,
                          elapsed_s: float) -> None:
        pass    # the counts decide; response times are not used

    def snapshot(self) -> dict:
        with self._lock:
            return {"total": self._total, "callers": dict(self._counts)}

    def stop(self) -> None:
        self._stop.set()


class FairCallQueue:
    """N priority sub-queues taken by weighted round-robin."""

    def __init__(self, num_levels: int, capacity: int):
        self.num_levels = num_levels
        per = max(1, capacity // num_levels)
        self._queues: List[queue.Queue] = [queue.Queue(per)
                                           for _ in range(num_levels)]
        self._weights = [2 ** (num_levels - 1 - i)
                         for i in range(num_levels)]
        self._rr_lock = threading.Lock()
        self._rr_level = 0
        self._rr_credit = self._weights[0]
        self._not_empty = threading.Condition()
        self._size = 0                 # guarded-by: _not_empty

    def put_nowait(self, item: Any, priority: int) -> None:
        q = self._queues[min(priority, self.num_levels - 1)]
        q.put_nowait(item)             # raises queue.Full
        with self._not_empty:
            self._size += 1
            self._not_empty.notify()

    def get(self, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._not_empty:
            while self._size == 0:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise queue.Empty
                self._not_empty.wait(remaining)
            self._size -= 1
        return self._take_weighted()

    def _take_weighted(self) -> Any:
        with self._rr_lock:
            for _ in range(2 * self.num_levels):
                lvl = self._rr_level
                if self._rr_credit <= 0:
                    self._advance()
                    continue
                try:
                    item = self._queues[lvl].get_nowait()
                    self._rr_credit -= 1
                    return item
                except queue.Empty:
                    self._advance()
            # the size said an item exists: scan for it
            for q in self._queues:
                try:
                    return q.get_nowait()
                except queue.Empty:
                    continue
            raise queue.Empty

    def _advance(self) -> None:
        self._rr_level = (self._rr_level + 1) % self.num_levels
        self._rr_credit = self._weights[self._rr_level]

    def qsize(self) -> int:
        with self._not_empty:
            return self._size


class _FifoQueue:
    """A ``SimpleQueue`` FIFO whose capacity is checked against its size
    before a put (advisory within one racing put a handler)."""

    def __init__(self, capacity: int):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._capacity = capacity

    def put_nowait(self, item: Any, priority: int) -> None:
        if self._q.qsize() >= self._capacity:
            raise queue.Full
        self._q.put(item)

    def get(self, timeout: Optional[float] = None) -> Any:
        return self._q.get(timeout=timeout)

    def qsize(self) -> int:
        return self._q.qsize()


class CallQueueManager:
    """The server's queue and scheduler pair."""

    def __init__(self, conf: Optional[ConfLike] = None,
                 capacity: int = 1024, prefix: str = "ipc"):
        conf = conf or Configuration(load_defaults=False)
        impl = conf.get(f"{prefix}.callqueue.impl", "fifo")
        sched = conf.get(f"{prefix}.scheduler.impl",
                         "decay" if impl == "fair" else "default")
        levels = conf.get_int(f"{prefix}.scheduler.priority.levels", 4)
        self.backoff_enable = conf.get_bool(f"{prefix}.backoff.enable",
                                            False)
        self.capacity = capacity
        if sched == "decay":
            self.scheduler = DecayRpcScheduler(levels, conf)
        else:
            self.scheduler = DefaultRpcScheduler(levels, conf)
        if impl == "fair":
            self.queue = FairCallQueue(self.scheduler.num_levels, capacity)
        else:
            self.queue = _FifoQueue(capacity)

    def put(self, call, caller: str) -> None:
        priority = self.scheduler.priority(caller)
        call.priority = priority
        try:
            self.queue.put_nowait(call, priority)
        except queue.Full:
            if self.backoff_enable:
                raise ServerTooBusyError(
                    "call queue is full; retry with backoff") from None
            # no backoff: wait a bounded time for room, then fail
            t0 = time.monotonic()
            while time.monotonic() - t0 < 60.0:
                try:
                    self.queue.put_nowait(call, priority)
                    return
                except queue.Full:
                    time.sleep(0.005)
            raise ServerTooBusyError("call queue full for 60s") from None

    def take(self, timeout: Optional[float] = None):
        return self.queue.get(timeout=timeout)

    def add_response_time(self, caller: str, priority: int,
                          elapsed_s: float) -> None:
        self.scheduler.add_response_time(caller, priority, elapsed_s)

    def qsize(self) -> int:
        return self.queue.qsize()

    def stop(self) -> None:
        self.scheduler.stop()
