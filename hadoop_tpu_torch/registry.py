"""The service registry as its clients see it: records, their names, and
the RPC client of the reference's registry server.

The port's copy of the client side of ``hadoop_tpu/registry/registry.py``:

- :class:`ServiceRecord` with the reference's wire form
  (``{"p": path, "e": endpoints, "a": attributes, "eph": ephemeral}``);
- ``HEARTBEAT_ATTR``, the attribute a publisher stamps with
  ``time.time()`` on every refresh, and :func:`record_is_stale`, the
  consumers' reading of it;
- :func:`record_ttl`, the record TTL from a conf
  (``serving.registry.record.ttl``, else ``serving.registry.ttl``, else
  10 s);
- :func:`replica_path`, where a replica of a service registers
  (``/services/serving/<service>/<instance>``);
- :class:`RegistryClient`, which speaks the reference's
  ``RegistryProtocol`` over the port's RPC client (``ipc/``) to the
  reference's ``RegistryServer``, and renews ephemeral records it
  registered with ``auto_renew``. The server is a fleet daemon the port
  uses as it is, like the router and the doctor.

A replica or trainer rank takes any object with the methods of
:class:`RegistryLike`, so an in-process caller may pass another client.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Protocol

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.ipc import Client, get_proxy, idempotent

log = logging.getLogger(__name__)

HEARTBEAT_ATTR = "hb"
RECORD_TTL_KEY = "serving.registry.record.ttl"
REGISTRY_PREFIX = "/services/serving"


def record_ttl(conf) -> float:
    """The record TTL in seconds (``conf``: a ``ConfLike``)."""
    return conf.get_time_seconds(
        RECORD_TTL_KEY, conf.get_time_seconds("serving.registry.ttl", 10.0))


def replica_path(service: str, instance: str) -> str:
    return f"{REGISTRY_PREFIX}/{service}/{instance}"


def record_is_stale(record: "ServiceRecord", ttl_s: float,
                    now: Optional[float] = None) -> bool:
    """The record's owner stopped heartbeating: its stamp is older than
    ``ttl_s`` on this host's clock (hosts are assumed clock-synced well
    within the TTL). A record without the stamp is never stale (the
    registry's own TTL sweep evicts it); a malformed stamp always is."""
    hb = record.attributes.get(HEARTBEAT_ATTR)
    if not hb:
        return False
    try:
        stamp = float(hb)
    except (TypeError, ValueError):
        return True
    return (time.time() if now is None else now) - stamp > ttl_s


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
    """What a replica or trainer rank asks of a registry client.
    ``register`` publishes (or refreshes) ``record`` with a TTL; a
    publisher with a heartbeat refreshes it itself, so it passes
    ``auto_renew=False``."""

    def register(self, record: ServiceRecord, ttl_s: float = 10.0,
                 auto_renew: bool = True) -> None: ...

    def unregister(self, path: str) -> None: ...

    def close(self) -> None: ...


class RegistryProtocol:
    """The reference server's RPC face as the client calls it (the class
    name is the wire protocol name). Every method is idempotent: a
    register overwrites, an unregister of a gone path is a no-op."""

    @idempotent
    def register(self, record_wire: Dict, ttl_s: float) -> bool: ...

    @idempotent
    def renew(self, path: str, ttl_s: float) -> bool: ...

    @idempotent
    def unregister(self, path: str) -> bool: ...

    @idempotent
    def resolve(self, path: str) -> Optional[Dict]: ...

    @idempotent
    def list(self, prefix: str) -> List[Dict]: ...


class RegistryClient:
    """Register, renew, resolve and list records on a registry server at
    ``addr`` (host, port)."""

    def __init__(self, addr, conf: Optional[ConfLike] = None):
        self.conf = conf or Configuration()
        self._client = Client(self.conf)
        self._proxy = get_proxy(RegistryProtocol, tuple(addr),
                                client=self._client)
        # path -> (record, ttl): kept so that a renewal that finds the
        # record gone (the registry restarted and lost its ephemeral
        # state) registers it again
        self._renewals: Dict[str, tuple] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register(self, record: ServiceRecord, ttl_s: float = 10.0,
                 auto_renew: bool = True) -> None:
        self._proxy.register(record.to_wire(), ttl_s)
        if auto_renew and record.ephemeral:
            self._renewals[record.path] = (record, ttl_s)
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._renew_loop, daemon=True,
                    name="registry-renewer")
                self._thread.start()

    def unregister(self, path: str) -> None:
        self._renewals.pop(path, None)
        self._proxy.unregister(path)

    def resolve(self, path: str) -> Optional[ServiceRecord]:
        d = self._proxy.resolve(path)
        return ServiceRecord.from_wire(d) if d else None

    def list(self, prefix: str) -> List[ServiceRecord]:
        return [ServiceRecord.from_wire(d)
                for d in self._proxy.list(prefix)]

    def close(self) -> None:
        self._stop.set()
        self._client.stop()

    def _renew_loop(self) -> None:
        while not self._stop.wait(min(
                [t / 3 for _, t in list(self._renewals.values())]
                or [1.0])):
            self._renew_once()

    def _renew_once(self) -> None:
        for path, (record, ttl) in list(self._renewals.items()):
            try:
                if not self._proxy.renew(path, ttl):
                    if path not in self._renewals:
                        continue       # unregistered while we renewed
                    log.info("registry record %s lost; re-registering",
                             path)
                    self._proxy.register(record.to_wire(), ttl)
                    if path not in self._renewals:
                        # an unregister raced the re-register: the
                        # deliberate removal wins
                        self._proxy.unregister(path)
            except Exception as e:  # noqa: BLE001 — a dead registry
                # must not end the loop; the next round retries
                log.debug("registry renewal of %s failed: %s", path, e)
