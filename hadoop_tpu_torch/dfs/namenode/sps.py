"""StoragePolicySatisfier: NameNode-internal replica migration.

The port's copy of ``hadoop_tpu/dfs/namenode/sps.py``, on the same wire
and disk formats.

The external Mover (hadoop_tpu_torch.dfs.balancer.Mover) walks the whole
namespace from a client; the SPS instead satisfies storage policies for
explicitly requested paths *inside* the NameNode, driving the moves
through the same heartbeat command queues the redundancy monitor uses —
no client process, work survives via a persistent xattr marker.

Ref: hadoop-hdfs server/namenode/sps/StoragePolicySatisfier.java (the
in-NN satisfier), FSDirSatisfyStoragePolicyOp.java (the
``satisfyStoragePolicy`` RPC sets the ``system.hdfs.sps`` xattr so a
restart re-discovers pending work), StoragePolicySatisfyManager.java.

Design differences from the reference, deliberately TPU-host-shaped:
the reference runs a dedicated satisfier thread with per-block tracking
records (ItemInfo/AttemptedItemInfo) and timeouts; here one
``pass_once`` is folded into the NameNode's redundancy-monitor sweep —
each pass (a) issues transfer commands for misplaced replicas through
``DatanodeDescriptor.transfer_queue``, (b) retires misplaced copies
once the right-typed replica has registered, removing the xattr when a
path is fully satisfied, and (c) forgets moves older than
``MOVE_TIMEOUT_S`` so a lost command or dead node is retried on a
later sweep instead of wedging the path.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Set, Tuple

from hadoop_tpu_torch.dfs.protocol.records import (POLICY_TYPES, Block,
                                             DatanodeInfo)

log = logging.getLogger(__name__)

SPS_XATTR = "system.hdfs.sps"

# A move whose replica hasn't registered after this long is assumed lost
# (source died before the heartbeat command, target died mid-copy, ...)
# and forgotten so the next sweep re-issues it. Ref: the reference's
# AttemptedItemInfo + BlockStorageMovementAttemptedItems timeout sweep.
MOVE_TIMEOUT_S = 60.0


class StoragePolicySatisfier:
    def __init__(self, fsn):
        self.fsn = fsn
        self._pending: Set[str] = set()
        # (block_id, bad_uuid) -> (Block, target_uuid, root, issued_at)
        self._inflight: Dict[Tuple[int, str],
                             Tuple[Block, str, str, float]] = {}
        self._scanned_on_activation = False

    # ------------------------------------------------------------ requests

    def satisfy(self, path: str) -> bool:
        """The satisfyStoragePolicy(path) RPC: mark + queue.
        Ref: FSDirSatisfyStoragePolicyOp.satisfyStoragePolicy."""
        if self.fsn.get_file_info(path) is None:
            raise FileNotFoundError(path)
        self.fsn.set_xattr(path, SPS_XATTR, b"1")
        self._pending.add(path)
        return True

    def pending_paths(self) -> List[str]:
        return sorted(self._pending)

    # ---------------------------------------------------------- the sweep

    def _recover_markers(self) -> None:
        """Re-discover ``system.hdfs.sps`` markers after a restart or
        failover (the xattr is journaled; the in-memory queue is not)."""
        try:
            if SPS_XATTR in self.fsn.get_xattrs("/"):
                self._pending.add("/")
        except (FileNotFoundError, ValueError):
            pass
        stack = ["/"]
        while stack:
            d = stack.pop()
            try:
                entries = self.fsn.listing(d)
            except (FileNotFoundError, ValueError):
                continue
            for st in entries:
                p = st["p"]
                if st["d"]:
                    stack.append(p)
                try:
                    if SPS_XATTR in self.fsn.get_xattrs(p):
                        self._pending.add(p)
                except (FileNotFoundError, ValueError):
                    pass

    def pass_once(self) -> int:
        """One satisfier sweep; returns replica moves issued."""
        if not self._scanned_on_activation:
            self._scanned_on_activation = True
            self._recover_markers()
        if not self._pending:
            return 0
        self._retire_completed()
        issued = 0
        for root in list(self._pending):
            try:
                files = self._files_under(root)
            except (FileNotFoundError, ValueError):
                self._pending.discard(root)
                continue
            outstanding = any(v[2] == root
                              for v in self._inflight.values())
            for f in files:
                n, misplaced = self._satisfy_file(f, root)
                issued += n
                if n or misplaced:
                    outstanding = True
            if not outstanding:
                self._pending.discard(root)
                try:
                    self.fsn.remove_xattr(root, SPS_XATTR)
                except (FileNotFoundError, ValueError):
                    pass
                log.info("SPS: %s satisfied", root)
        return issued

    # ------------------------------------------------------------- helpers

    def _files_under(self, root: str) -> List[str]:
        st = self.fsn.get_file_info(root)
        if st is None:
            raise FileNotFoundError(root)
        if not st["d"]:
            return [root]
        out, stack = [], [root]
        while stack:
            d = stack.pop()
            for e in self.fsn.listing(d):
                (stack if e["d"] else out).append(e["p"])
        return out

    def _wanted(self, path: str) -> List[str]:
        return POLICY_TYPES.get(self.fsn.get_storage_policy(path), ["DISK"])

    def _replicas(self, path: str):
        """[(Block, [DatanodeInfo])] for every non-striped block."""
        info = self.fsn.get_block_locations(path, 0, 1 << 62)
        out = []
        for bw in info["blocks"]:
            if bw.get("ec"):
                continue
            out.append((Block.from_wire(bw["b"]),
                        [DatanodeInfo.from_wire(d) for d in bw["locs"]]))
        return out

    def _satisfy_file(self, path: str, root: str) -> Tuple[int, bool]:
        """Issue moves for one file; returns (moves_issued,
        still_has_misplaced_replicas) from a single locations fetch."""
        wanted = self._wanted(path)
        dn_mgr = self.fsn.bm.dn_manager
        right_type = [n for n in dn_mgr.live_nodes()
                      if n.storage_type in wanted]
        issued = 0
        misplaced = False
        for block, locs in self._replicas(path):
            placed = {d.uuid for d in locs}
            for bad in locs:
                if bad.storage_type in wanted:
                    continue
                misplaced = True
                if not right_type:
                    continue  # no node of the wanted class — keep marker
                key = (block.block_id, bad.uuid)
                if key in self._inflight:
                    continue
                target = next((t for t in right_type
                               if t.uuid not in placed), None)
                if target is None:
                    break
                src = dn_mgr.get(bad.uuid)
                if src is None:
                    continue
                src.transfer_queue.append(
                    (block, [target.public_info()]))
                self._inflight[key] = (block, target.uuid, root,
                                       time.monotonic())
                placed.add(target.uuid)
                issued += 1
        return issued, misplaced

    def _retire_completed(self) -> None:
        """Once the right-typed replica registered, drop the misplaced
        one (mirrors the Mover's add-then-invalidate ordering)."""
        bm = self.fsn.bm
        now = time.monotonic()
        for key, (block, target_uuid, _root, issued_at) in \
                list(self._inflight.items()):
            info = bm.get(block.block_id)
            if info is None:
                del self._inflight[key]
                continue
            if target_uuid in info.locations:
                bad_uuid = key[1]
                try:
                    bm.invalidate_replica(block, bad_uuid)
                except Exception:
                    log.warning("SPS: invalidate of %s on %s failed",
                                block, bad_uuid, exc_info=True)
                del self._inflight[key]
            elif now - issued_at > MOVE_TIMEOUT_S:
                # Lost move (source or target died) — forget it so the
                # next sweep re-issues against the current topology.
                log.info("SPS: move of blk_%d timed out; will retry",
                         block.block_id)
                del self._inflight[key]
