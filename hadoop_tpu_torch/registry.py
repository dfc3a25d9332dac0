"""The service registry: records, their names, the RPC client and the
server.

The port's copy of ``hadoop_tpu/registry/registry.py``:

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
- :class:`RegistryClient`, which speaks ``RegistryProtocol`` over the
  port's RPC client (``ipc/``) to a registry server (the port's or the
  reference's: the wire is one), and renews ephemeral records it
  registered with ``auto_renew``;
- :class:`RegistryServer`, a service serving ``RegistryProtocol`` on the
  port's RPC server (``registry.port``, 0 for any): records by path, an
  ephemeral record's deadline its TTL from the last register or renew,
  a persistent one never expiring, a sweep every
  ``registry.sweep.interval`` (1 s) that deletes the expired.

A replica or trainer rank takes any object with the methods of
:class:`RegistryLike`, so an in-process caller may pass another client.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional, Protocol

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.ipc import Client, Server, get_proxy, idempotent
from hadoop_tpu_torch.service import AbstractService
from hadoop_tpu_torch.util.misc import Daemon

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


class _Entry:
    __slots__ = ("record", "deadline")

    def __init__(self, record: ServiceRecord, deadline: float):
        self.record = record
        self.deadline = deadline


class RegistryProtocol:
    """The registry's RPC face (the class name is the wire protocol
    name): the server half calls into ``server``, and the client's proxy
    reads the idempotency marks. Every method is idempotent: a register
    overwrites, an unregister of a gone path is a no-op."""

    def __init__(self, server: Optional["RegistryServer"] = None):
        self.srv = server

    @idempotent
    def register(self, record_wire: Dict, ttl_s: float) -> bool:
        return self.srv.put(ServiceRecord.from_wire(record_wire), ttl_s)

    @idempotent
    def renew(self, path: str, ttl_s: float) -> bool:
        return self.srv.renew(path, ttl_s)

    @idempotent
    def unregister(self, path: str) -> bool:
        return self.srv.remove(path)

    @idempotent
    def resolve(self, path: str) -> Optional[Dict]:
        rec = self.srv.get(path)
        return rec.to_wire() if rec else None

    @idempotent
    def list(self, prefix: str) -> List[Dict]:
        return [r.to_wire() for r in self.srv.list(prefix)]


class RegistryServer(AbstractService):
    """Records with liveness TTLs, served over the port's RPC server."""

    def __init__(self, conf: ConfLike):
        super().__init__("RegistryServer")
        self._entries: Dict[str, _Entry] = {}   # guarded-by: _lock
        self._lock = threading.Lock()
        self.rpc: Optional[Server] = None
        self._stop = threading.Event()

    def service_init(self, conf: ConfLike) -> None:
        self.rpc = Server(conf, bind=("127.0.0.1", conf.get_int(
            "registry.port", 0)), num_handlers=2, name="registry")
        self.rpc.register_protocol("RegistryProtocol",
                                   RegistryProtocol(self))
        self._sweep_interval = conf.get_time_seconds(
            "registry.sweep.interval", 1.0)

    def service_start(self) -> None:
        self.rpc.start()
        Daemon(self._sweep_loop, "registry-sweeper").start()
        log.info("RegistryServer on :%d", self.rpc.port)

    def service_stop(self) -> None:
        self._stop.set()
        if self.rpc:
            self.rpc.stop()

    @property
    def port(self) -> int:
        return self.rpc.port

    def put(self, record: ServiceRecord, ttl_s: float) -> bool:
        deadline = time.monotonic() + ttl_s if record.ephemeral \
            else float("inf")
        with self._lock:
            self._entries[record.path] = _Entry(record, deadline)
        return True

    def renew(self, path: str, ttl_s: float) -> bool:
        with self._lock:
            e = self._entries.get(path)
            if e is None:
                return False
            # a persistent record stays persistent: a keepalive must not
            # give it a TTL that the sweep would then enforce
            if e.record.ephemeral:
                e.deadline = time.monotonic() + ttl_s
            return True

    def remove(self, path: str) -> bool:
        with self._lock:
            return self._entries.pop(path, None) is not None

    def get(self, path: str) -> Optional[ServiceRecord]:
        with self._lock:
            e = self._entries.get(path)
            return e.record if e else None

    def list(self, prefix: str) -> List[ServiceRecord]:
        prefix = prefix.rstrip("/")
        with self._lock:
            return [e.record for p, e in sorted(self._entries.items())
                    if p == prefix or p.startswith(prefix + "/")]

    def _sweep_once(self, now: Optional[float] = None) -> List[str]:
        """Delete the records whose deadline passed (on the monotonic
        clock, or at ``now`` on it); the paths deleted."""
        now = time.monotonic() if now is None else now
        with self._lock:
            dead = [p for p, e in self._entries.items() if e.deadline < now]
            for p in dead:
                del self._entries[p]
        for p in dead:
            log.info("registry record %s expired", p)
        return dead

    def _sweep_loop(self) -> None:
        while not self._stop.wait(self._sweep_interval):
            self._sweep_once()


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
