"""Per-peer rolling latency tracking — the DataNode (and replica) side

The port's copy of ``hadoop_tpu/obs/peers.py``, on the same wire and
disk formats.
of slow-node detection.

The reference's ``DataNodePeerMetrics`` (ref: server/datanode/metrics/
DataNodePeerMetrics.java, fed from BlockReceiver's
``SendPacketDownstreamAvgInfo``): every DataNode times its *downstream*
pipeline hop — packet forward + downstream ack round-trip — per peer
uuid, and publishes rolling summaries. The fleet doctor aggregates every
node's view of every peer and runs median/MAD across targets: a slow
node is one that *several of its upstream peers* independently measure
as slow, which separates "that node is sick" from "my own NIC is sick".

``SELF_READ``/``SELF_WRITE`` ride the same tracker: the node's own
whole-op service times (windowed, unlike the lifetime ``/prom``
histograms), so the doctor can also compare nodes on their own service
latency without differencing cumulative buckets.

Bounded everywhere: samples per peer (rolling window) and tracked peers
(idle-longest evicted) — a long-lived DN in a churning cluster must not
grow a dict forever (the FleetScraper pruning precedent).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from hadoop_tpu_torch.obs.detect import RollingStat

# reserved peer keys for the node's own service times
SELF_READ = "__self_read__"
SELF_WRITE = "__self_write__"


class PeerLatencyTracker:
    """Thread-safe rolling per-peer latency summaries."""

    def __init__(self, window: int = 128, max_peers: int = 64):
        self.window = window
        self.max_peers = max_peers
        self._lock = threading.Lock()
        self._peers: Dict[str, RollingStat] = {}  # guarded-by: _lock

    def record(self, peer: str, seconds: float) -> None:
        if not peer:
            return
        with self._lock:
            stat = self._peers.get(peer)
            if stat is None:
                if len(self._peers) >= self.max_peers:
                    # evict the idle-longest REAL peer (it left the
                    # cluster, or traffic moved away) — bounded memory.
                    # The reserved self-stat entries are never eviction
                    # candidates: a read-quiet node forwarding writes
                    # to many peers must not lose its own service-time
                    # signal (the dn.read_service detector's input).
                    cands = [p for p in self._peers
                             if p not in (SELF_READ, SELF_WRITE)]
                    if cands:
                        oldest = min(
                            cands, key=lambda p: self._peers[p].last_at)
                        del self._peers[oldest]
                stat = self._peers[peer] = RollingStat(self.window)
            stat.record(seconds)

    def record_self_read(self, seconds: float) -> None:
        self.record(SELF_READ, seconds)

    def record_self_write(self, seconds: float) -> None:
        self.record(SELF_WRITE, seconds)

    def summary(self) -> Dict[str, Dict]:
        """{peer_uuid: {n, mean, median}} for downstream peers only
        (self stats live under ``self_summary``). Summaries are read
        UNDER the lock: ``RollingStat.summary`` iterates the deque a
        responder thread concurrently appends to, and an unlocked read
        intermittently dies with deque-mutated-during-iteration (each
        summary is O(window) — cheap enough to hold the lock)."""
        out: Dict[str, Dict] = {}
        with self._lock:
            for peer, stat in self._peers.items():
                if peer in (SELF_READ, SELF_WRITE):
                    continue
                s = stat.summary()
                if s is not None:
                    out[peer] = s
        return out

    def self_summary(self) -> Dict[str, Optional[Dict]]:
        with self._lock:
            read = self._peers.get(SELF_READ)
            write = self._peers.get(SELF_WRITE)
            return {"read": read.summary() if read else None,
                    "write": write.summary() if write else None}

    def to_report(self, node_id: str) -> Dict:
        """The ``/ws/v1/peers`` payload one daemon publishes."""
        return {"node": node_id, "peers": self.summary(),
                "self": self.self_summary()}
