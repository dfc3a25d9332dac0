"""What a serving replica publishes in the service registry.

The port carries no registry RPC client. A replica takes any object with
the three methods of :class:`RegistryLike`, the part of ``hadoop_tpu``'s
``RegistryClient`` it uses, so that client passes in unchanged (its
``register`` sends ``record.to_wire()``); the port never imports or
checks for its type. What is copied here is the record and its names:

- :class:`ServiceRecord` with the reference's wire form
  (``{"p": path, "e": endpoints, "a": attributes, "eph": ephemeral}``);
- ``HEARTBEAT_ATTR``, the attribute a publisher stamps with
  ``time.time()`` on every refresh;
- :func:`record_ttl`, the record TTL from a conf
  (``serving.registry.record.ttl``, else ``serving.registry.ttl``, else
  10 s);
- :func:`replica_path`, where a replica of a service registers
  (``/services/serving/<service>/<instance>``).
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol

HEARTBEAT_ATTR = "hb"
RECORD_TTL_KEY = "serving.registry.record.ttl"
REGISTRY_PREFIX = "/services/serving"


def record_ttl(conf) -> float:
    """The record TTL in seconds (``conf``: a ``ConfLike``)."""
    return conf.get_time_seconds(
        RECORD_TTL_KEY, conf.get_time_seconds("serving.registry.ttl", 10.0))


def replica_path(service: str, instance: str) -> str:
    return f"{REGISTRY_PREFIX}/{service}/{instance}"


class ServiceRecord:
    """A named service record: endpoints and attributes."""

    def __init__(self, path: str, endpoints: Dict[str, str],
                 attributes: Optional[Dict[str, str]] = None,
                 ephemeral: bool = True):
        self.path = path
        self.endpoints = endpoints
        self.attributes = attributes or {}
        self.ephemeral = ephemeral

    def to_wire(self) -> Dict:
        return {"p": self.path, "e": self.endpoints,
                "a": self.attributes, "eph": self.ephemeral}

    @classmethod
    def from_wire(cls, d: Dict) -> "ServiceRecord":
        return cls(d["p"], d["e"], d.get("a", {}), d.get("eph", True))


class RegistryLike(Protocol):
    """What a replica asks of a registry client. ``register`` publishes
    (or refreshes) ``record`` with a TTL; a replica refreshes it itself,
    so it passes ``auto_renew=False``."""

    def register(self, record: ServiceRecord, ttl_s: float = 10.0,
                 auto_renew: bool = True) -> None: ...

    def unregister(self, path: str) -> None: ...

    def close(self) -> None: ...
