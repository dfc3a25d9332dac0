"""Instrumented reader/writer lock for the namesystem.

The port's copy of ``hadoop_tpu/dfs/namenode/namesystem_lock.py``, on
the same wire and disk formats.

Parity with the reference (ref: server/namenode/FSNamesystemLock.java:66 —
:88/:109/:184 record longest holds and log past thresholds): a
write-preferring RW lock that tracks read/write hold times, logs warnings
when a hold exceeds the threshold, and exposes metrics — the reference's
answer to "no TSAN for the JVM" (SURVEY.md §5.2).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from hadoop_tpu_torch.metrics import metrics_system

log = logging.getLogger(__name__)


class NamesystemLock:
    def __init__(self, name: str = "fsn",
                 write_warn_threshold_s: float = 1.0,
                 read_warn_threshold_s: float = 5.0):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer: Optional[int] = None
        self._writer_depth = 0
        self._waiting_writers = 0
        self.write_warn_threshold_s = write_warn_threshold_s
        self.read_warn_threshold_s = read_warn_threshold_s
        reg = metrics_system().source(f"{name}.lock")
        self._m_write_hold = reg.rate("write_lock_held")
        self._m_read_hold = reg.rate("read_lock_held")
        self._m_write_warns = reg.counter("write_lock_warnings")
        self._local = threading.local()

    # ---------------------------------------------------------------- write

    def write_lock(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_depth += 1
                return
            self._waiting_writers += 1
            while self._writer is not None or self._readers > 0:
                self._cond.wait()
            self._waiting_writers -= 1
            self._writer = me
            self._writer_depth = 1
            self._local.write_t0 = time.monotonic()

    def write_unlock(self) -> None:
        me = threading.get_ident()
        with self._cond:
            assert self._writer == me, "write_unlock by non-owner"
            self._writer_depth -= 1
            if self._writer_depth > 0:
                return
            held = time.monotonic() - self._local.write_t0
            self._writer = None
            self._cond.notify_all()
        self._m_write_hold.add(held)
        if held > self.write_warn_threshold_s:
            self._m_write_warns.incr()
            log.warning("Namesystem write lock held for %.3fs (threshold %.1fs)",
                        held, self.write_warn_threshold_s)

    # ----------------------------------------------------------------- read

    def read_lock(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:  # writer may re-enter as reader
                self._writer_depth += 1
                return
            while self._writer is not None or self._waiting_writers > 0:
                self._cond.wait()
            self._readers += 1
        t0s = getattr(self._local, "read_t0s", None)
        if t0s is None:
            t0s = self._local.read_t0s = []
        t0s.append(time.monotonic())

    def read_unlock(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_depth -= 1
                return
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()
        held = time.monotonic() - self._local.read_t0s.pop()
        self._m_read_hold.add(held)
        if held > self.read_warn_threshold_s:
            log.warning("Namesystem read lock held for %.3fs", held)

    # ------------------------------------------------------ context managers

    class _Guard:
        __slots__ = ("_enter", "_exit")

        def __init__(self, enter, exit_):
            self._enter = enter
            self._exit = exit_

        def __enter__(self):
            self._enter()
            return self

        def __exit__(self, *exc):
            self._exit()
            return False

    def write(self) -> "_Guard":
        return self._Guard(self.write_lock, self.write_unlock)

    def read(self) -> "_Guard":
        return self._Guard(self.read_lock, self.read_unlock)

    def held_by_current_writer(self) -> bool:
        return self._writer == threading.get_ident()
