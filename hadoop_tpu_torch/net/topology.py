"""NetworkTopology — locality tree for placement and read ordering.

The port's copy of ``hadoop_tpu/net/topology.py``, on the same wire and
disk formats.

Parity with the reference's topology layer (ref: hadoop-common net/
NetworkTopology.java — the /rack/host tree with getDistance/
sortByDistance; resolver ref: net/ScriptBasedMapping.java +
net.topology.script.file.name / TableMapping). TPU-first naming: the
unit of locality is the POD (hosts on one ICI domain) rather than a
switch rack — paths look like ``/pod0/host3`` — but the math is the
reference's: distance 0 same node, 2 same pod, 4 cross-pod.

Resolution order (ref: CachedDNSToSwitchMapping chain):
  1. ``net.topology.table`` — inline ``host=/pod`` pairs (comma list)
  2. ``net.topology.script.file.name`` — executable, hosts in argv,
     one location per output line
  3. DEFAULT_POD for everyone (flat cluster — behavior without topology)
"""

from __future__ import annotations

import logging
import subprocess
import threading
from typing import Dict, List, Optional, Sequence

from hadoop_tpu_torch.conf import Configuration

log = logging.getLogger(__name__)

DEFAULT_POD = "/default-pod"


def distance(loc_a: str, host_a: str, loc_b: str, host_b: str) -> int:
    """0 same host, 2 same pod, 4 cross-pod (ref: NetworkTopology
    .getDistance — two levels collapse the reference's general tree)."""
    if host_a == host_b and loc_a == loc_b:
        return 0
    if loc_a == loc_b:
        return 2
    return 4


class TopologyResolver:
    """host → /pod location with caching. Ref: ScriptBasedMapping /
    TableMapping behind CachedDNSToSwitchMapping."""

    def __init__(self, conf: Optional[Configuration] = None):
        conf = conf or Configuration()
        self._cache: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._table: Dict[str, str] = {}
        for pair in conf.get_list("net.topology.table", []):
            host, _, loc = pair.partition("=")
            if loc:
                self._table[host.strip()] = loc.strip()
        self._script = conf.get("net.topology.script.file.name", "")

    def resolve(self, host: str) -> str:
        with self._lock:
            got = self._cache.get(host)
        if got is not None:
            return got
        loc = self._table.get(host)
        script_failed = False
        if loc is None and self._script:
            try:
                out = subprocess.run(
                    [self._script, host], capture_output=True, timeout=10,
                    text=True)
                line = out.stdout.strip().splitlines()
                loc = line[0].strip() if line else None
            except (OSError, subprocess.SubprocessError) as e:
                log.warning("topology script failed for %s: %s", host, e)
                script_failed = True
        loc = loc or DEFAULT_POD
        if not script_failed:
            # never cache a TRANSIENT script failure's default: it would
            # pin wrong placement/sort decisions for the host until
            # process restart; the next resolve retries the script
            with self._lock:
                self._cache[host] = loc
        return loc


class NetworkTopology:
    """The live tree: tracked nodes with their locations.
    Ref: NetworkTopology.java (add/remove/getDistance/sortByDistance)."""

    def __init__(self, resolver: Optional[TopologyResolver] = None):
        self.resolver = resolver or TopologyResolver()
        self._locations: Dict[str, str] = {}  # host → /pod
        self._lock = threading.Lock()

    def add(self, host: str) -> str:
        loc = self.resolver.resolve(host)
        with self._lock:
            self._locations[host] = loc
        return loc

    def remove(self, host: str) -> None:
        with self._lock:
            self._locations.pop(host, None)

    def location_of(self, host: str) -> str:
        with self._lock:
            got = self._locations.get(host)
        return got if got is not None else self.resolver.resolve(host)

    def pods(self) -> Dict[str, List[str]]:
        with self._lock:
            out: Dict[str, List[str]] = {}
            for host, loc in self._locations.items():
                out.setdefault(loc, []).append(host)
            return out

    def same_pod(self, host_a: str, host_b: str) -> bool:
        return self.location_of(host_a) == self.location_of(host_b)

    def sort_by_distance(self, reader_host: str, nodes: Sequence,
                         host_of=lambda n: n.host) -> List:
        """Stable sort: local replica first, then same-pod, then the rest
        (ref: NetworkTopology.sortByDistance as DatanodeManager uses it
        for getBlockLocations)."""
        reader_loc = self.location_of(reader_host)

        def key(node) -> int:
            h = host_of(node)
            return distance(reader_loc, reader_host,
                            self.location_of(h), h)

        return sorted(nodes, key=key)
