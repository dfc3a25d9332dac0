"""Top-N of the process's decayed accountings, which ``/ws/v1/top`` serves.

The port's copy of ``hadoop_tpu/obs/top.py``. The chassis keeps no
counter of its own: a daemon registers each decay accounting it owns
(the serving door's ``DecayCostScheduler.snapshot``, per-tenant decayed
token cost) under a name, and ``/ws/v1/top`` ranks every source's current
window. Process-wide like the metrics system; a daemon unregisters its
sources when it stops.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List

# source name -> zero-arg snapshot fn returning
# {"total": float, <"callers"|"tenants">: {key: decayed_cost}}
_sources: Dict[str, Callable[[], Dict]] = {}
_lock = threading.Lock()


def register_top_source(name: str, snapshot_fn: Callable[[], Dict]) -> None:
    """Register (or replace) a decay accounting's snapshot under
    ``name``."""
    with _lock:
        _sources[name] = snapshot_fn


def unregister_top_source(name: str) -> None:
    with _lock:
        _sources.pop(name, None)


def top_n(n: int = 10) -> Dict[str, Dict]:
    """{source: {total, window: [{key, cost, share}]}}, heaviest first. A
    source whose snapshot raises is reported as an error entry, never an
    exception out of the servlet."""
    with _lock:
        sources = dict(_sources)
    out: Dict[str, Dict] = {}
    for name, fn in sources.items():
        try:
            snap = fn()
        except Exception as e:  # noqa: BLE001 — source is daemon code
            out[name] = {"error": f"{type(e).__name__}: {e}"}
            continue
        total = float(snap.get("total", 0.0) or 0.0)
        entries = snap.get("callers") or snap.get("tenants") or {}
        ranked: List[Dict] = sorted(
            ({"key": k, "cost": round(float(v), 3),
              "share": round(float(v) / total, 4) if total else 0.0}
             for k, v in entries.items()),
            key=lambda e: -e["cost"])[:n]
        out[name] = {"total": round(total, 3), "window": ranked}
    return out


def reset_for_tests() -> None:
    with _lock:
        _sources.clear()
