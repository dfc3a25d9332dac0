"""The trainer's step anatomy, as plain thread-safe counters.

The counterpart of ``TrainerStepMetrics`` (``hadoop_tpu/obs/trainer.py``)
with the reference's names: ``steps``; ``data_wait`` and ``step_wall``,
each with a histogram; ``ckpt_snapshot``, ``ckpt_write`` and
``ckpt_fence``. ``anatomy()`` gives the reference's JSON shape. There is
no metrics system here: the ``/jmx`` and ``/prom`` seams come with the
HTTP door (ROADMAP Queue A 2).
"""

from __future__ import annotations

import threading
from typing import Dict, List


class Counter:
    """A count of events."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def incr(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value


class Rate:
    """Durations in seconds: count, mean and max."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._n = 0
        self._total = 0.0
        self._max = 0.0

    def add(self, elapsed_s: float) -> None:
        with self._lock:
            self._n += 1
            self._total += elapsed_s
            self._max = max(self._max, elapsed_s)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"num_ops": self._n,
                    "avg_time": self._total / self._n if self._n else 0.0,
                    "max_time": self._max}


class Histogram:
    """Log-bucketed durations in seconds: the reference's bounds, 0.25 ms
    to ~131 s doubling per bucket, and a last bucket above them."""

    BOUNDS = tuple(0.00025 * (2 ** i) for i in range(20))

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._buckets: List[int] = [0] * (len(self.BOUNDS) + 1)
        self._sum = 0.0
        self._count = 0

    def add(self, value: float) -> None:
        i = next((i for i, b in enumerate(self.BOUNDS) if value <= b),
                 len(self.BOUNDS))
        with self._lock:
            self._buckets[i] += 1
            self._sum += value
            self._count += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {"sum": self._sum, "count": self._count,
                    "buckets": list(self._buckets)}


class TrainerStepMetrics:
    """The step-anatomy counters of one trainer rank."""

    def __init__(self, rank: int = 0):
        self.rank = int(rank)
        self.steps = Counter("steps")
        self.data_wait = Rate("data_wait")
        self.step_wall = Rate("step_wall")
        self.ckpt_snapshot = Rate("ckpt_snapshot")
        self.ckpt_write = Rate("ckpt_write")
        self.ckpt_fence = Rate("ckpt_fence")
        self.step_wall_hist = Histogram("step_wall_seconds")
        self.data_wait_hist = Histogram("data_wait_seconds")

    def anatomy(self) -> Dict:
        """Cumulative step anatomy in the reference's JSON shape."""
        def hist(h):
            s = h.snapshot()
            return {"sum": s["sum"], "count": s["count"]}

        def rate(r):
            s = r.snapshot()
            return {"num_ops": s["num_ops"], "avg_time": s["avg_time"]}

        return {"rank": self.rank,
                "steps": self.steps.value,
                "step_wall": hist(self.step_wall_hist),
                "data_wait": hist(self.data_wait_hist),
                "ckpt": {"snapshot": rate(self.ckpt_snapshot),
                         "write": rate(self.ckpt_write),
                         "fence": rate(self.ckpt_fence)}}
