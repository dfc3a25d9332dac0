"""YARN service specs, as the reference's service AM reads them.

The port's copy of the spec records of ``hadoop_tpu/yarn/records.py``
(``Resource``) and ``yarn/services.py`` (``Component``, ``ServiceSpec``,
the ``RESTART_*`` policies), with the same ``to_wire``/``to_dict``/
``to_json`` forms: the reference's ``ServiceSpec.from_json`` reads the
port's JSON, so the reference's ``ServiceClient`` submits a port spec
unchanged. The RM, the node agents and the service AM are the fleet's
daemons, used as they are.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

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
