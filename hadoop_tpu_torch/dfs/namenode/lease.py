"""Write leases: single-writer enforcement with expiry-driven recovery.

The port's copy of ``hadoop_tpu/dfs/namenode/lease.py``, on the same
wire and disk formats.

Parity with the reference (ref: server/namenode/LeaseManager.java (689 LoC)):
one lease per client holder covering all its open files; renewed by the
client's heartbeat (renew_lease RPC); soft limit lets another client claim a
file whose writer went quiet; hard limit triggers NameNode-side lease
recovery (file closed with its current blocks).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Set


class Lease:
    def __init__(self, holder: str):
        self.holder = holder
        self.paths: Set[str] = set()
        self.last_renewal = time.monotonic()

    def renew(self) -> None:
        self.last_renewal = time.monotonic()

    def age(self) -> float:
        return time.monotonic() - self.last_renewal


class LeaseManager:
    # Ref: HdfsConstants LEASE_SOFTLIMIT_PERIOD (60s) / HARDLIMIT (20min);
    # configurable here so miniclusters can shrink them.
    def __init__(self, soft_limit_s: float = 60.0,
                 hard_limit_s: float = 20 * 60.0):
        self.soft_limit_s = soft_limit_s
        self.hard_limit_s = hard_limit_s
        self._leases: Dict[str, Lease] = {}            # guarded-by: _lock
        self._path_to_holder: Dict[str, str] = {}      # guarded-by: _lock
        self._lock = threading.Lock()

    def add_lease(self, holder: str, path: str) -> None:
        with self._lock:
            lease = self._leases.get(holder)
            if lease is None:
                lease = Lease(holder)
                self._leases[holder] = lease
            lease.paths.add(path)
            lease.renew()
            self._path_to_holder[path] = holder

    def remove_lease(self, holder: str, path: str) -> None:
        with self._lock:
            self._path_to_holder.pop(path, None)
            lease = self._leases.get(holder)
            if lease is not None:
                lease.paths.discard(path)
                if not lease.paths:
                    del self._leases[holder]

    def renew_lease(self, holder: str) -> None:
        with self._lock:
            lease = self._leases.get(holder)
            if lease is not None:
                lease.renew()

    def holder_of(self, path: str) -> Optional[str]:
        with self._lock:
            return self._path_to_holder.get(path)

    def rename_path(self, old: str, new: str) -> None:
        """Re-key leases for a renamed path AND everything under it (a
        directory rename moves open files with it).
        Ref: LeaseManager.renameLease / getINodeWithLeases subtree walk."""
        old_prefix = old.rstrip("/") + "/"
        new_base = new.rstrip("/")
        with self._lock:
            moves = [(p, h) for p, h in self._path_to_holder.items()
                     if p == old or p.startswith(old_prefix)]
            for path, holder in moves:
                newp = new_base + path[len(old.rstrip("/")):] \
                    if path != old else new
                del self._path_to_holder[path]
                self._path_to_holder[newp] = holder
                lease = self._leases.get(holder)
                if lease is not None:
                    lease.paths.discard(path)
                    lease.paths.add(newp)

    def remove_under(self, root: str) -> None:
        """Drop leases for a path and its whole subtree (deletion).
        Ref: LeaseManager.removeLeases."""
        prefix = root.rstrip("/") + "/"
        with self._lock:
            doomed = [(p, h) for p, h in self._path_to_holder.items()
                      if p == root or p.startswith(prefix)]
        for path, holder in doomed:
            self.remove_lease(holder, path)

    def is_soft_expired(self, path: str) -> bool:
        """May another writer preempt this lease? Ref: soft limit check in
        FSNamesystem.recoverLeaseInternal."""
        with self._lock:
            holder = self._path_to_holder.get(path)
            if holder is None:
                return True
            lease = self._leases.get(holder)
            return lease is None or lease.age() > self.soft_limit_s

    def hard_expired_paths(self) -> List[str]:
        """Paths whose writers exceeded the hard limit → NN-driven recovery.
        Ref: LeaseManager.Monitor.checkLeases."""
        with self._lock:
            out: List[str] = []
            for lease in self._leases.values():
                if lease.age() > self.hard_limit_s:
                    out.extend(lease.paths)
            return out

    def is_hard_expired(self, path: str) -> bool:
        """Point check for the recovery sweep's re-verification under the
        namespace lock: a renewal (or a fresh lease from a delete+
        recreate) between the sweep's snapshot and the lock acquisition
        must call off the force-close."""
        with self._lock:
            holder = self._path_to_holder.get(path)
            if holder is None:
                return True  # no lease at all: nothing protects the file
            lease = self._leases.get(holder)
            return lease is None or lease.age() > self.hard_limit_s

    def num_leases(self) -> int:
        with self._lock:
            return len(self._leases)

    def snapshot_for_image(self) -> Dict[str, List[str]]:
        with self._lock:
            return {h: sorted(l.paths) for h, l in self._leases.items()}

    def restore_from_image(self, snap: Dict[str, List[str]]) -> None:
        with self._lock:
            self._leases.clear()
            self._path_to_holder.clear()
        for holder, paths in snap.items():
            for p in paths:
                self.add_lease(holder, p)
