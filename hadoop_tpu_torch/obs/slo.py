"""The bounded tenant classes the serving door stamps on each request.

The part of ``hadoop_tpu/obs/slo.py`` the door uses: the class set
p0..p3 (p0 the under-share, interactive end of the QoS decay ladder, p3
the over-share end; deeper ladders clamp into p3, so every ``htpu_slo_*``
family keeps a closed label set), the level-to-class map, and the
``obs.slo.class.map`` identity map (``"tenant=class,tenant=class"``)
that pins a tenant's class.
"""

from __future__ import annotations

import logging
from typing import Dict

log = logging.getLogger(__name__)

SLO_CLASSES = ("p0", "p1", "p2", "p3")

CLASS_MAP_KEY = "obs.slo.class.map"


def slo_class_of(level: int) -> str:
    """Map a DecayCostScheduler level onto the bounded class set."""
    return SLO_CLASSES[min(max(level, 0), len(SLO_CLASSES) - 1)]


def parse_class_map(conf) -> Dict[str, str]:
    """``obs.slo.class.map`` from ``conf`` (a ``ConfLike``). Entries that
    name a class outside :data:`SLO_CLASSES` are dropped with a warning."""
    out: Dict[str, str] = {}
    raw = (conf.get(CLASS_MAP_KEY, "") or "").strip()
    for part in raw.split(","):
        part = part.strip()
        if not part or "=" not in part:
            continue
        tenant, cls = (s.strip() for s in part.split("=", 1))
        if tenant and cls in SLO_CLASSES:
            out[tenant] = cls
        elif tenant:
            log.warning("slo: class map entry %r names unknown class "
                        "%r (known: %s) -- ignored", tenant, cls,
                        ",".join(SLO_CLASSES))
    return out
