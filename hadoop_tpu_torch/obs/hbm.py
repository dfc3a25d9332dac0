"""Live HBM ledger: what device memory is spent on, as one report.

The counterpart of ``hadoop_tpu/obs/hbm.py``. Components register byte
**providers** (zero-argument callables returning live byte counts) under
an owner key: the trainer its parameters and optimizer state, the decode
engine its weights and KV pool. ``report()`` sums them per component
beside what the device's allocator says (``device_memory_stats``).

Providers are owned: a component unregisters on teardown, so a stopped
engine's pool never haunts the report. A provider that raises is
skipped and counted in ``errors``. The first ``report()`` registers one
callback gauge per component in the metrics system (source ``hbm``,
family ``htpu_hbm_bytes{component=...}`` on the door's ``/prom``).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from hadoop_tpu_torch.metrics import metrics_system

# The bounded component set; unknown components map to "other".
HBM_COMPONENTS = ("weights", "weights_dequantized", "moe_experts",
                  "kv_pool",
                  "longctx_window", "longctx_tail", "longctx_sampler",
                  "params", "opt_state", "grad_buckets", "other")


def device_memory_stats() -> Optional[Dict]:
    """The CUDA allocator's view of the current device: bytes in use and
    their peak (tensors allocated through PyTorch) and the device's total
    memory as ``bytes_limit``. ``None`` without a CUDA device, or before
    this process has used one."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    _, total = torch.cuda.mem_get_info()
    return {"platform": "gpu",
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}


class HbmLedger:
    """Process-global registry of device byte providers."""

    # how long one provider sweep may serve repeated queries
    CACHE_SECONDS = 0.25

    def __init__(self):
        self._lock = threading.Lock()
        # owner -> (component, provider)          guarded-by: _lock
        self._providers: Dict[str, Tuple[str, Callable[[], int]]] = {}
        # (monotonic stamp, components, errors) of the last sweep;
        # invalidated on register/unregister      guarded-by: _lock
        self._cache: Optional[Tuple[float, Dict[str, int], int]] = None
        self._reg = None      # the metrics source the gauges live in
        # (monotonic stamp, device_memory_stats()) of the last report:
        # the allocator's stats dict is built in Python, so a health
        # poller reading it at every scrape would hold the GIL against
        # the engine's scheduler thread        guarded-by: _lock
        self._device_cache: Optional[Tuple[float, Optional[Dict]]] = None

    def register(self, owner: str, component: str,
                 provider: Callable[[], int]) -> None:
        """Register ``provider`` as ``owner``'s contribution to
        ``component`` (re-registering an owner replaces it)."""
        if component not in HBM_COMPONENTS:
            component = "other"
        with self._lock:
            self._providers[owner] = (component, provider)
            self._cache = None

    def unregister(self, owner: str) -> None:
        with self._lock:
            self._providers.pop(owner, None)
            self._cache = None

    def unregister_prefix(self, prefix: str) -> None:
        """Drop every owner under ``prefix`` (a component's teardown)."""
        with self._lock:
            for key in [k for k in self._providers if k.startswith(prefix)]:
                del self._providers[key]
            self._cache = None

    def component_bytes(self) -> Tuple[Dict[str, int], int]:
        """({component: live bytes}, provider-error count), from one sweep
        that serves for ``CACHE_SECONDS``."""
        now = time.monotonic()
        with self._lock:
            if self._cache is not None and \
                    now - self._cache[0] < self.CACHE_SECONDS:
                return dict(self._cache[1]), self._cache[2]
            providers = list(self._providers.values())
        out: Dict[str, int] = {}
        errors = 0
        for component, provider in providers:
            try:
                b = int(provider())
            except Exception:  # noqa: BLE001 — a torn-down owner that
                # missed its unregister reads as an error count, not a
                # dead ledger
                errors += 1
                continue
            out[component] = out.get(component, 0) + b
        with self._lock:
            self._cache = (now, dict(out), errors)
        return out, errors

    def report(self) -> Dict:
        """Components, their total, and the allocator's view; each part
        read at most once per ``CACHE_SECONDS``."""
        self._ensure_metrics()
        comps, errors = self.component_bytes()
        now = time.monotonic()
        with self._lock:
            n = len(self._providers)
            cached = self._device_cache
        if cached is None or now - cached[0] >= self.CACHE_SECONDS:
            cached = (now, device_memory_stats())
            with self._lock:
                self._device_cache = cached
        return {"components": comps,
                "total_bytes": sum(comps.values()),
                "providers": n,
                "errors": errors,
                "device": cached[1]}


    def _ensure_metrics(self) -> None:
        """Callback gauges per component under one ``htpu_hbm_bytes``
        family, registered once per metrics source."""
        reg = metrics_system().source("hbm")
        if reg is self._reg:
            return
        for c in HBM_COMPONENTS:
            reg.register_callback_gauge(
                "hbm_bytes_" + c,
                lambda comp=c: self.component_bytes()[0].get(comp, 0),
                prom_name="hbm_bytes", prom_labels={"component": c})
        self._reg = reg


_LEDGER = HbmLedger()


def hbm_ledger() -> HbmLedger:
    return _LEDGER


def tree_nbytes(tree) -> int:
    """Total bytes of the tensors in nested dicts, lists and tuples
    (NamedTuples included); other leaves, such as an int count, add
    nothing."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return int(getattr(tree, "nbytes", 0))
