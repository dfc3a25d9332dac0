"""CP plan construction for a long-context prefill.

The counterpart of ``hadoop_tpu/serving/longctx/plan.py``. A long-context
prefill is a batch-of-one, sequence-sharded job on a one-axis ``sp``
ring. The reference builds a ``jax.sharding.Mesh`` over sp devices; the
port's ring (``Ring``) holds its sp ranks on one device, folded into the
batch (``parallel/spmd.py``: a ring hop is a roll, Ulysses' all-to-all a
permute), so every rank's kernel work is that of an sp-device
deployment while the wall time is one device's. Serving over distinct
devices is ROADMAP Queue A 6.

``ring_order`` keeps the reference's rule for devices without
``coords``, which every ``torch.device`` is: id order. Its topology
snake-sort (TASP, PAPERS: arXiv:2509.26541) comes back with rings over
distinct GPUs.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional, Sequence

import torch

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.parallel.ulysses import supports

log = logging.getLogger(__name__)


def ring_order(devices: Sequence[torch.device]) -> List[torch.device]:
    """Order ``devices`` along the ring: id order (the CPU first)."""
    return sorted(devices, key=lambda d: -1 if d.index is None else d.index)


@dataclasses.dataclass(frozen=True)
class Ring:
    """The port's ``sp`` mesh: ``size`` context-parallel ranks, all on
    ``device``."""
    size: int
    device: torch.device


def cp_mesh(sp: int, devices: Optional[Sequence] = None) -> Ring:
    """The ring every long-context prefill runs on: ``sp`` ranks on the
    current GPU (``devices=None``), or on the one device that every entry
    of ``devices`` names. Raises ``NotImplementedError`` for distinct
    devices."""
    if sp < 1:
        raise ValueError(f"sp={sp}")
    if devices is None:
        return Ring(sp, resolve_device(None))
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("longctx plan needs a device")
    if len(set(devs)) > 1:
        raise NotImplementedError(
            f"a ring over distinct devices {devs}: multi-device ring hops "
            f"come with multi-GPU parallelism (ROADMAP Queue A 6); this "
            f"port runs the sp ranks on one device")
    return Ring(sp, devs[0])


def choose_sp_mode(cfg, sp: int, requested: str = "ring") -> str:
    """Validate the requested CP attention strategy against the model's
    head counts, as the reference does: ulysses needs both head counts
    divisible by the ring (``parallel/ulysses.py``); an impossible
    ulysses request degrades to ring with a loud log."""
    if requested not in ("ring", "ulysses"):
        raise ValueError("serving.longctx.sp.mode must be ring|ulysses, "
                         f"got {requested!r}")
    if requested == "ulysses" and sp > 1 and \
            not supports(cfg.n_heads, cfg.n_kv_heads, sp):
        log.warning(
            "serving.longctx.sp.mode=ulysses needs n_heads(%d) and "
            "n_kv_heads(%d) divisible by the %d-rank axis; falling back "
            "to ring", cfg.n_heads, cfg.n_kv_heads, sp)
        return "ring"
    return requested
