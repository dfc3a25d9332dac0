"""YARN service specs, as the reference's service AM reads them, and the
client half that watches and flexes a running service.

The port's copy of the spec records of ``hadoop_tpu/yarn/records.py``
(``Resource``) and ``yarn/services.py`` (``Component``, ``ServiceSpec``,
the ``RESTART_*`` policies), with the same ``to_wire``/``to_dict``/
``to_json`` forms: the reference's ``ServiceSpec.from_json`` reads the
port's JSON, so the reference's ``ServiceClient`` submits a port spec
unchanged. The RM, the node agents and the service AM are the fleet's
daemons, used as they are.

The client half is the port's copy of ``ApplicationId``,
``ApplicationReport`` and ``AppState`` (``yarn/records.py``, the same
wire forms), ``YarnClient.application_report`` (``yarn/client.py``) and
``ServiceClient``'s ``status``, ``flex`` and ``close``
(``yarn/services.py``), over the port's RPC client: a report from the
RM, then the service AM's ``ClientAMProtocol`` at the report's
``htpu-am://host:port`` tracking URL, waited for up to 30 s.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration

RESTART_ALWAYS = "ALWAYS"        # long-running daemons
RESTART_ON_FAILURE = "ON_FAILURE"
RESTART_NEVER = "NEVER"


class Resource:
    """A container's size: memory, virtual cores and accelerator chips
    (the reference's ``tpu_chips`` dimension, on the wire as ``t``)."""

    __slots__ = ("memory_mb", "vcores", "tpu_chips")

    def __init__(self, memory_mb: int = 0, vcores: int = 0,
                 tpu_chips: int = 0):
        self.memory_mb = memory_mb
        self.vcores = vcores
        self.tpu_chips = tpu_chips

    def to_wire(self) -> Dict:
        return {"m": self.memory_mb, "v": self.vcores, "t": self.tpu_chips}

    @classmethod
    def from_wire(cls, d: Dict) -> "Resource":
        return cls(d.get("m", 0), d.get("v", 0), d.get("t", 0))


class Component:
    """One component of a service: N containers of one launch command."""

    def __init__(self, name: str, number_of_containers: int,
                 launch_command: List[str],
                 resource: Optional[Resource] = None,
                 restart_policy: str = RESTART_ALWAYS):
        self.name = name
        self.number_of_containers = number_of_containers
        self.launch_command = launch_command
        self.resource = resource or Resource(128, 1)
        self.restart_policy = restart_policy

    def to_dict(self) -> Dict:
        return {"name": self.name, "n": self.number_of_containers,
                "cmd": self.launch_command,
                "r": self.resource.to_wire(),
                "restart": self.restart_policy}

    @classmethod
    def from_dict(cls, d: Dict) -> "Component":
        return cls(d["name"], d["n"], d["cmd"], Resource.from_wire(d["r"]),
                   d.get("restart", RESTART_ALWAYS))


class ServiceSpec:
    """A named service of components."""

    def __init__(self, name: str, components: List[Component]):
        self.name = name
        self.components = components

    def to_json(self) -> str:
        return json.dumps({"name": self.name,
                           "components": [c.to_dict()
                                          for c in self.components]})

    @classmethod
    def from_json(cls, s: str) -> "ServiceSpec":
        d = json.loads(s)
        return cls(d["name"], [Component.from_dict(c)
                               for c in d["components"]])


# ------------------------------------------------- the client half

class AppState:
    """An application's externally visible states."""
    NEW = "NEW"
    SUBMITTED = "SUBMITTED"
    ACCEPTED = "ACCEPTED"
    RUNNING = "RUNNING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    KILLED = "KILLED"
    TERMINAL = (FINISHED, FAILED, KILLED)


class ApplicationId:
    """``application_<cluster_ts>_<seq>``, on the wire as ``{ts, s}``."""

    __slots__ = ("cluster_ts", "seq")

    def __init__(self, cluster_ts: int, seq: int):
        self.cluster_ts = cluster_ts
        self.seq = seq

    def __str__(self):
        return f"application_{self.cluster_ts}_{self.seq:04d}"

    def to_wire(self) -> Dict:
        return {"ts": self.cluster_ts, "s": self.seq}

    @classmethod
    def from_wire(cls, d: Dict) -> "ApplicationId":
        return cls(d["ts"], d["s"])

    @classmethod
    def parse(cls, s: str) -> "ApplicationId":
        _, ts, seq = s.split("_")
        return cls(int(ts), int(seq))

    def __eq__(self, o):
        return isinstance(o, ApplicationId) and str(o) == str(self)

    def __hash__(self):
        return hash((self.cluster_ts, self.seq))


class ApplicationReport:
    """The RM's report of one application; ``tracking_url`` is where a
    service AM publishes its ``htpu-am://host:port`` endpoint."""

    __slots__ = ("app_id", "name", "user", "queue", "state", "final_status",
                 "diagnostics", "tracking_url", "start_time", "finish_time",
                 "attempt_no")

    def __init__(self, app_id: ApplicationId, name: str, user: str,
                 queue: str, state: str, final_status: str = "",
                 diagnostics: str = "", tracking_url: str = "",
                 start_time: float = 0.0, finish_time: float = 0.0,
                 attempt_no: int = 0):
        self.app_id = app_id
        self.name = name
        self.user = user
        self.queue = queue
        self.state = state
        self.final_status = final_status
        self.diagnostics = diagnostics
        self.tracking_url = tracking_url
        self.start_time = start_time
        self.finish_time = finish_time
        self.attempt_no = attempt_no

    def to_wire(self) -> Dict:
        return {"id": self.app_id.to_wire(), "nm": self.name, "u": self.user,
                "q": self.queue, "st": self.state, "fs": self.final_status,
                "d": self.diagnostics, "tu": self.tracking_url,
                "t0": self.start_time, "t1": self.finish_time,
                "at": self.attempt_no}

    @classmethod
    def from_wire(cls, d: Dict) -> "ApplicationReport":
        return cls(ApplicationId.from_wire(d["id"]), d["nm"], d["u"], d["q"],
                   d["st"], d.get("fs", ""), d.get("d", ""), d.get("tu", ""),
                   d.get("t0", 0.0), d.get("t1", 0.0), d.get("at", 0))


class YarnClient:
    """Application reports from the RM's ``ClientRMProtocol``."""

    def __init__(self, rm_addr: Tuple[str, int],
                 conf: Optional[ConfLike] = None):
        from hadoop_tpu_torch.ipc import Client, get_proxy
        self.conf = conf or Configuration()
        self._client = Client(self.conf)
        self.rm = get_proxy("ClientRMProtocol", tuple(rm_addr),
                            client=self._client)

    def application_report(self, app_id: ApplicationId
                           ) -> ApplicationReport:
        return ApplicationReport.from_wire(
            self.rm.get_application_report(app_id.to_wire()))

    def close(self) -> None:
        self._client.stop()


class ServiceClient:
    """Status and flex of a running YARN service, through its AM's
    ``ClientAMProtocol`` at the tracking URL the RM reports. It submits
    nothing: the reference's ``ServiceClient`` submits a port spec."""

    AM_WAIT_S = 30.0

    def __init__(self, rm_addr: Tuple[str, int],
                 conf: Optional[ConfLike] = None):
        from hadoop_tpu_torch.ipc import Client
        self.rm_addr = tuple(rm_addr)
        self.conf = conf or Configuration()
        self.yc = YarnClient(self.rm_addr, self.conf)
        self._client = Client(self.conf)

    def _am_proxy(self, app_id: ApplicationId):
        from hadoop_tpu_torch.ipc import get_proxy
        deadline = time.monotonic() + self.AM_WAIT_S
        while time.monotonic() < deadline:
            report = self.yc.application_report(app_id)
            if report.state in (AppState.FAILED, AppState.KILLED):
                raise IOError(f"service app {report.state}: "
                              f"{report.diagnostics}")
            url = report.tracking_url
            if url.startswith("htpu-am://"):
                host, port = url[len("htpu-am://"):].split(":")
                return get_proxy("ClientAMProtocol", (host, int(port)),
                                 client=self._client)
            time.sleep(0.2)
        raise TimeoutError("service AM did not publish its endpoint")

    def status(self, app_id: ApplicationId) -> Dict:
        return self._am_proxy(app_id).get_status()

    def flex(self, app_id: ApplicationId, component: str,
             count: int) -> bool:
        return self._am_proxy(app_id).flex_component(component, count)

    def close(self) -> None:
        self.yc.close()
        self._client.stop()
