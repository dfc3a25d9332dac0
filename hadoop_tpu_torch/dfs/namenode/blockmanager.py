"""Block → replica map, datanode liveness, replication scheduling, safemode.

The port's copy of ``hadoop_tpu/dfs/namenode/blockmanager.py``, on the
same wire and disk formats.

Parity with the reference's block management layer (ref:
server/blockmanagement/BlockManager.java (5,459 LoC; :2731 processReport),
DatanodeManager.java (2,052; :1673 handleHeartbeat), HeartbeatManager.java:46,
DatanodeAdminManager.java:78, BlockPlacementPolicyDefault.java):

- ``DatanodeDescriptor`` — server-side view of one block server: stored
  blocks, pending invalidation queue, pending transfer (re-replication) work.
- ``DatanodeManager`` — registration, heartbeats, dead-node sweep,
  decommissioning drains.
- ``BlockManager`` — blocks map keyed by id with expected replication and the
  owning file; full/incremental report processing; under-replication priority
  queues worked off by the RedundancyMonitor; excess-replica pruning; corrupt
  replica tracking; safemode (block threshold + auto-exit).

Replica placement is load-balanced-random over live nodes (the topology seam
exists — ``NetworkTopology`` racks — but one TPU-VM pod is one rack; the
reference's rack spread policy degenerates to spread-over-hosts there).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.protocol.records import (Block, DatanodeInfo, DnCommand,
                                             LocatedBlock)
from hadoop_tpu_torch.io import erasurecode as ec
from hadoop_tpu_torch.metrics import metrics_system

log = logging.getLogger(__name__)


class DatanodeDescriptor(DatanodeInfo):
    """NN-side state for one registered datanode.
    Ref: blockmanagement/DatanodeDescriptor.java."""

    __slots__ = ("blocks", "invalidate_queue", "transfer_queue",
                 "recover_queue", "ec_queue", "xceiver_count",
                 "network_location", "cache_queue", "uncache_queue",
                 "cached_blocks")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.blocks: Set[int] = set()
        self.invalidate_queue: List[Block] = []
        self.transfer_queue: List[Tuple[Block, List[DatanodeInfo]]] = []
        self.recover_queue: List[Tuple[Block, int]] = []
        self.ec_queue: List[Dict] = []  # EC_RECONSTRUCT payloads
        self.xceiver_count = 0
        self.network_location = "/default-pod"
        self.cache_queue: List[Block] = []
        self.uncache_queue: List[Block] = []
        self.cached_blocks: Set[int] = set()

    def public_info(self) -> DatanodeInfo:
        info = DatanodeInfo(self.uuid, self.host, self.xfer_port,
                            self.ipc_port, self.capacity, self.dfs_used,
                            self.remaining, self.storage_type,
                            info_port=self.info_port)
        info.state = self.state
        info.num_blocks = len(self.blocks)
        return info


class BlockInfo:
    """Ref: blockmanagement/BlockInfo.java — block + owning file + replicas."""

    __slots__ = ("block", "inode", "expected_replication", "locations",
                 "corrupt_replicas", "under_construction", "rbw_locations")

    def __init__(self, block: Block, inode, expected_replication: int):
        self.block = block
        self.inode = inode  # INodeFile back-reference (BlockCollection)
        self.expected_replication = expected_replication
        self.locations: Set[str] = set()       # datanode uuids (finalized)
        self.corrupt_replicas: Set[str] = set()
        self.under_construction = True
        # Expected pipeline members while under construction — where rbw
        # replicas live, the targets block recovery contacts.
        # Ref: BlockUnderConstructionFeature.expectedLocations.
        self.rbw_locations: Set[str] = set()

    def live_replicas(self) -> int:
        return len(self.locations - self.corrupt_replicas)


class BlockInfoStriped(BlockInfo):
    """A striped block group (ref: blockmanagement/BlockInfoStriped.java):
    k+m storage units, each a single replica on one DN; ``unit_map`` maps
    datanode uuid → unit index. ``expected_replication`` is k+m."""

    __slots__ = ("policy", "unit_map", "unit_lengths")

    def __init__(self, block: Block, inode, policy: ec.ECPolicy):
        super().__init__(block, inode, policy.num_units)
        self.policy = policy
        self.unit_map: Dict[str, int] = {}
        # Reported finalized unit lengths (idx → bytes), the ground truth
        # for recovering the group's logical length after a client crash.
        self.unit_lengths: Dict[int, int] = {}

    def live_units(self) -> Set[int]:
        return {idx for uuid, idx in self.unit_map.items()
                if uuid in self.locations and
                uuid not in self.corrupt_replicas}

    def live_replicas(self) -> int:
        # "Replicas" for health purposes = distinct live units.
        return len(self.live_units())

    def missing_units(self) -> List[int]:
        live = self.live_units()
        return [i for i in range(self.policy.num_units) if i not in live]

    def logical_length(self) -> int:
        """Data bytes implied by the reported data-unit lengths (ref:
        StripedBlockUtil.getSpannedSize's inverse)."""
        return sum(self.unit_lengths.get(i, 0) for i in range(self.policy.k))


class DatanodeManager:
    """Ref: blockmanagement/DatanodeManager.java."""

    def __init__(self, conf: Configuration, block_manager: "BlockManager"):
        self.conf = conf
        self.bm = block_manager
        self.heartbeat_interval_s = conf.get_time_seconds(
            "dfs.heartbeat.interval", 3.0)
        # Ref formula: 2 * recheck + 10 * heartbeat
        self.dead_interval_s = conf.get_time_seconds(
            "dfs.namenode.heartbeat.recheck-interval", 10.0) * 2 \
            + 10 * self.heartbeat_interval_s
        self._nodes: Dict[str, DatanodeDescriptor] = {}  # guarded-by: _lock
        # uuid -> monotonic expiry: DNs the fleet doctor flagged as
        # statistical outliers (report_slow_peers). Placement treats
        # them as last-resort targets until the TTL lapses — a doctor
        # outage fails OPEN (flags decay, placement heals itself).
        # Ref: SlowPeerTracker feeding BlockPlacementPolicyDefault's
        # excludeSlowNodesEnabled path.
        self._slow_nodes: Dict[str, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # Locality tree (ref: DatanodeManager's NetworkTopology + the
        # dnsToSwitchMapping resolver chain)
        from hadoop_tpu_torch.net import NetworkTopology, TopologyResolver
        self.topology = NetworkTopology(TopologyResolver(conf))

    # ---------------------------------------------------------- registration

    def register(self, info: DatanodeInfo) -> DatanodeDescriptor:
        location = self.topology.add(info.host)
        with self._lock:
            node = self._nodes.get(info.uuid)
            if node is None:
                node = DatanodeDescriptor(info.uuid, info.host,
                                          info.xfer_port, info.ipc_port)
                self._nodes[info.uuid] = node
                log.info("Registered datanode %s at %s", node, location)
            node.network_location = location
            node.host = info.host
            node.xfer_port = info.xfer_port
            node.ipc_port = info.ipc_port
            node.info_port = info.info_port
            node.storage_type = info.storage_type
            # Re-registration revives a DEAD node but must NOT cancel an
            # operator-set admin state — rebooting a DN is exactly what
            # maintenance mode exists for (ref: the admin-state survival
            # in registerDatanode/startAdminOperationIfNecessary).
            if node.state == DatanodeInfo.STATE_DEAD:
                node.state = DatanodeInfo.STATE_LIVE
            node.last_heartbeat = time.monotonic()
            return node

    def get(self, uuid: str) -> Optional[DatanodeDescriptor]:
        with self._lock:
            return self._nodes.get(uuid)

    def handle_heartbeat(self, uuid: str, capacity: int, dfs_used: int,
                         remaining: int, xceivers: int,
                         issue_commands: bool = True) -> List[DnCommand]:
        """Ref: DatanodeManager.handleHeartbeat:1673 — refresh stats, hand the
        node its queued work as commands. A standby NN passes
        ``issue_commands=False``: liveness/stats refresh only, queues stay
        intact for whoever becomes active."""
        with self._lock:
            node = self._nodes.get(uuid)
            if node is None:
                return [DnCommand(DnCommand.REREGISTER)]
            node.last_heartbeat = time.monotonic()
            if node.state == DatanodeInfo.STATE_DEAD:
                # Back from the dead: node_died() already purged its
                # replica map, so a silent revival would leave its
                # blocks location-less until the next periodic report.
                # Command a re-registration — the DN responds with an
                # immediate full block report (ref: handleHeartbeat's
                # unregistered-node path returning DNA_REGISTER).
                node.state = DatanodeInfo.STATE_LIVE
                return [DnCommand(DnCommand.REREGISTER)]
            node.capacity = capacity
            node.dfs_used = dfs_used
            node.remaining = remaining
            node.xceiver_count = xceivers
            if not issue_commands:
                return []
            cmds: List[DnCommand] = []
            if node.invalidate_queue:
                cmds.append(DnCommand(DnCommand.INVALIDATE,
                                      blocks=node.invalidate_queue[:100]))
                del node.invalidate_queue[:100]
            if node.transfer_queue:
                work = node.transfer_queue[:10]
                del node.transfer_queue[:10]
                cmds.append(DnCommand(
                    DnCommand.TRANSFER,
                    blocks=[b for b, _ in work],
                    targets=[t for _, t in work]))
            if node.cache_queue:
                cmds.append(DnCommand(DnCommand.CACHE,
                                      blocks=node.cache_queue[:32]))
                del node.cache_queue[:32]
            if node.uncache_queue:
                cmds.append(DnCommand(DnCommand.UNCACHE,
                                      blocks=node.uncache_queue[:32]))
                del node.uncache_queue[:32]
            if node.recover_queue:
                work = node.recover_queue[:10]
                del node.recover_queue[:10]
                cmds.append(DnCommand(
                    DnCommand.RECOVER,
                    blocks=[b for b, _ in work],
                    new_gen_stamps=[gs for _, gs in work]))
            for payload in node.ec_queue[:4]:
                cmds.append(DnCommand(DnCommand.EC_RECONSTRUCT,
                                      extra=payload))
            del node.ec_queue[:4]
            return cmds

    # ------------------------------------------------------------- liveness

    def check_dead_nodes(self) -> List[DatanodeDescriptor]:
        """Mark nodes past the dead interval; returns newly-dead nodes.
        Ref: HeartbeatManager.heartbeatCheck."""
        now = time.monotonic()
        newly_dead = []
        with self._lock:
            for node in self._nodes.values():
                if (node.state == DatanodeInfo.STATE_LIVE
                        and now - node.last_heartbeat > self.dead_interval_s):
                    node.state = DatanodeInfo.STATE_DEAD
                    newly_dead.append(node)
        for node in newly_dead:
            log.warning("Datanode %s declared dead (no heartbeat for %.1fs)",
                        node, self.dead_interval_s)
        return newly_dead

    def live_nodes(self) -> List[DatanodeDescriptor]:
        with self._lock:
            return [n for n in self._nodes.values()
                    if n.state == DatanodeInfo.STATE_LIVE]

    def all_nodes(self) -> List[DatanodeDescriptor]:
        with self._lock:
            return list(self._nodes.values())

    def start_decommission(self, uuid: str) -> None:
        """Ref: DatanodeAdminManager.startDecommission:78."""
        with self._lock:
            node = self._nodes.get(uuid)
        if node is not None and node.state == DatanodeInfo.STATE_LIVE:
            node.state = DatanodeInfo.STATE_DECOMMISSIONING
            log.info("Starting decommission of %s", node)
            self.bm.schedule_drain(node)

    def start_maintenance(self, uuid: str) -> None:
        """Ref: DatanodeAdminManager.startMaintenance — like decommission
        but the node is expected back; replicas are topped up elsewhere
        without invalidating its copies."""
        with self._lock:
            node = self._nodes.get(uuid)
        if node is not None and node.state == DatanodeInfo.STATE_LIVE:
            node.state = DatanodeInfo.STATE_ENTERING_MAINTENANCE
            log.info("Starting maintenance of %s", node)
            self.bm.schedule_drain(node)

    def stop_maintenance(self, uuid: str) -> None:
        with self._lock:
            node = self._nodes.get(uuid)
            if node is not None and node.state in (
                    DatanodeInfo.STATE_ENTERING_MAINTENANCE,
                    DatanodeInfo.STATE_IN_MAINTENANCE):
                node.state = DatanodeInfo.STATE_LIVE

    def check_admin_progress(self) -> None:
        """Promote DECOMMISSIONING → DECOMMISSIONED (and entering →
        in-maintenance) once every block on the node is adequately
        redundant elsewhere. Ref: DatanodeAdminManager.Monitor.check."""
        with self._lock:
            draining = [n for n in self._nodes.values() if n.state in
                        (DatanodeInfo.STATE_DECOMMISSIONING,
                         DatanodeInfo.STATE_ENTERING_MAINTENANCE)]
        for node in draining:
            drained = self.bm.is_node_drained(node)  # slow — outside lock
            with self._lock:
                # Re-check: an operator may have flipped the state while
                # the drain scan ran (stop_maintenance races this monitor).
                if not drained:
                    continue
                if node.state == DatanodeInfo.STATE_DECOMMISSIONING:
                    node.state = DatanodeInfo.STATE_DECOMMISSIONED
                elif node.state == DatanodeInfo.STATE_ENTERING_MAINTENANCE:
                    node.state = DatanodeInfo.STATE_IN_MAINTENANCE
                else:
                    continue
            log.info("Node %s is now %s", node, node.state)

    # ------------------------------------------------------------ slow nodes

    def set_slow_nodes(self, uuids: List[str], ttl_s: float) -> None:
        """Replace-and-arm: the doctor's CURRENT flagged set, each entry
        expiring after ``ttl_s``. A node the doctor stopped flagging is
        cleared immediately (the push is a full report, not a delta)."""
        deadline = time.monotonic() + max(0.0, ttl_s)
        with self._lock:
            self._slow_nodes = {u: deadline for u in uuids}
        if uuids:
            log.info("placement deprioritizing slow datanodes: %s",
                     [u[:8] for u in uuids])

    def slow_node_uuids(self) -> Set[str]:
        now = time.monotonic()
        with self._lock:
            expired = [u for u, t in self._slow_nodes.items() if t < now]
            for u in expired:
                del self._slow_nodes[u]
            return set(self._slow_nodes)

    # ------------------------------------------------------------ placement

    def choose_targets(self, n: int, exclude: Set[str],
                       writer_host: Optional[str] = None,
                       preferred_types: Optional[List[str]] = None
                       ) -> List[DatanodeDescriptor]:
        """Topology-aware target choice, the reference default policy's
        shape (ref: BlockPlacementPolicyDefault.chooseTarget): replica 1
        on the writer's host when possible; replica 2 OFF the first
        replica's pod (survives a pod/ICI-domain loss); replica 3 on the
        SAME pod as replica 2 (one cross-pod transfer, not two); the rest
        load-spread random. Within each constraint the less-loaded of two
        random candidates wins (power-of-two-choices).
        ``preferred_types`` narrows to those storage types when any such
        node is live (falling back to all, like the reference's
        fallback-storage-type chain)."""
        with self._lock:
            candidates = [node for node in self._nodes.values()
                          if node.state == DatanodeInfo.STATE_LIVE
                          and node.uuid not in exclude]
        if preferred_types:
            typed = [c for c in candidates
                     if c.storage_type in preferred_types]
            if typed:
                candidates = typed
        if not candidates:
            return []
        chosen: List[DatanodeDescriptor] = []
        # doctor-flagged nodes are LAST-RESORT targets: every pick
        # prefers the healthy subset of its pool and falls back to the
        # whole pool only when the constraint can't otherwise be met —
        # a mostly-flagged cluster still places n replicas.
        slow = self.slow_node_uuids()

        def pick_from(pool: List[DatanodeDescriptor]) -> None:
            healthy = [c for c in pool if c.uuid not in slow]
            pool = healthy or pool
            a = random.choice(pool)
            b = random.choice(pool)
            pick = a if a.xceiver_count <= b.xceiver_count else b
            chosen.append(pick)
            candidates.remove(pick)

        # replica 1: writer-local when possible (short-circuit win)
        if writer_host is not None:
            local = [c for c in candidates if c.host == writer_host]
            local = [c for c in local if c.uuid not in slow] or local
            if local:
                pick = min(local, key=lambda c: c.xceiver_count)
                chosen.append(pick)
                candidates.remove(pick)
        if candidates and len(chosen) < n and not chosen:
            pick_from(candidates)
        # replica 2: off the first replica's pod when the cluster spans pods
        if candidates and len(chosen) < n:
            first_pod = chosen[0].network_location
            off_pod = [c for c in candidates
                       if c.network_location != first_pod]
            pick_from(off_pod or candidates)
        # replica 3: same pod as replica 2 (one cross-pod hop total)
        if candidates and len(chosen) < n and len(chosen) >= 2:
            second_pod = chosen[1].network_location
            same = [c for c in candidates
                    if c.network_location == second_pod]
            pick_from(same or candidates)
        while candidates and len(chosen) < n:
            pick_from(candidates)
        return chosen

    def sort_by_distance(self, reader_host: Optional[str],
                         nodes: List[DatanodeDescriptor]
                         ) -> List[DatanodeDescriptor]:
        """Read ordering: local, then same-pod, then the rest (ref:
        DatanodeManager.sortLocatedBlocks → NetworkTopology
        .sortByDistance)."""
        if not reader_host:
            return nodes
        return self.topology.sort_by_distance(reader_host, nodes)


class BlockManager:
    """Ref: blockmanagement/BlockManager.java."""

    def __init__(self, conf: Configuration):
        self.conf = conf
        self.min_replication = conf.get_int("dfs.namenode.replication.min", 1)
        self.max_replication = conf.get_int("dfs.replication.max", 512)
        self.dn_manager = DatanodeManager(conf, self)
        self._blocks: Dict[int, BlockInfo] = {}  # guarded-by: _lock
        self._lock = threading.RLock()
        # Under-replication priority queues (ref: LowRedundancyBlocks.java):
        # 0 = highest risk (1 replica), 1 = under-replicated, 2 = queued drains.
        self._needed: List[Set[int]] = [set(), set(), set()]
        self._pending_reconstruction: Dict[int, float] = {}  # id → deadline
        # Standby postponement (ref: BlockManager.PendingDataNodeMessages
        # + shouldPostponeBlocksFromFuture): a standby's editlog tail can
        # lag the DNs' incremental reports, so a received-report for a
        # block the namespace doesn't know yet must be QUEUED, not
        # invalidated — invalidating would delete the only replica of a
        # just-written block after failover. Replayed when the block
        # appears (edit tailing) and drained on transition to active.
        self.postpone_unknown = False
        self._postponed: Dict[int, List[tuple]] = {}  # id → [(Block, uuid)]
        self._postponed_count = 0
        self.POSTPONED_MAX = 100_000
        # How long a scheduled (re)construction may stay outstanding
        # before re-queueing (ref:
        # dfs.namenode.reconstruction.pending.timeout-sec). EC gets 2x:
        # the worker reads k units before writing.
        self._pending_timeout_s = conf.get_time_seconds(
            "dfs.namenode.reconstruction.pending.timeout", 30.0)
        self.safemode = SafeMode(self, conf)
        reg = metrics_system().source("namenode.blocks")
        reg.register_callback_gauge("blocks_total", lambda: len(self._blocks))
        reg.register_callback_gauge(
            "under_replicated", lambda: sum(len(q) for q in self._needed[:2]))
        reg.register_callback_gauge(
            "pending_reconstruction", lambda: len(self._pending_reconstruction))
        self._m_reconstructions = reg.counter("reconstructions_scheduled")

    # ----------------------------------------------------------- block index

    def add_block_collection(self, block: Block, inode,
                             replication: int) -> BlockInfo:
        with self._lock:
            info = BlockInfo(block, inode, replication)
            self._blocks[block.block_id] = info
            replayed = self._replay_postponed_locked(block.block_id)
        if replayed:
            # outside _lock: report_blocks re-enters it via _blocks_safe
            self.safemode.report_blocks()
        return info

    def add_striped_block_collection(self, block: Block, inode,
                                     policy: ec.ECPolicy
                                     ) -> BlockInfoStriped:
        replayed = False
        with self._lock:
            info = BlockInfoStriped(block, inode, policy)
            self._blocks[block.block_id] = info
            # striped units report under unit ids = group id | index —
            # probe the group's width directly instead of scanning the
            # whole postponed dict per group
            width = policy.k + policy.m
            for bid in [block.block_id] + \
                    [block.block_id + i for i in range(width)]:
                replayed |= self._replay_postponed_locked(bid)
        if replayed:
            self.safemode.report_blocks()
        return info

    def _replay_postponed_locked(self, block_id: int) -> bool:
        msgs = self._postponed.pop(block_id, None)
        if not msgs:
            return False
        self._postponed_count -= len(msgs)
        for blk, uuid in msgs:
            node = self.dn_manager.get(uuid)
            if node is not None:
                self._add_stored_block_locked(blk, node)
        return True

    def process_all_postponed(self) -> None:
        """Drain the postponed queue with postponement OFF — run on
        transition to active (ref: processAllPendingDNMessages): by now
        the namespace is fully caught up, so anything still unknown
        really is deletable."""
        with self._lock:
            self.postpone_unknown = False
            pending, self._postponed = self._postponed, {}
            self._postponed_count = 0
            for msgs in pending.values():
                for blk, uuid in msgs:
                    node = self.dn_manager.get(uuid)
                    if node is not None:
                        self._add_stored_block_locked(blk, node)
        if pending:
            self.safemode.report_blocks()

    def _resolve_locked(self, block_id: int) -> Optional[BlockInfo]:  # lint: holds=_lock
        """Map a reported block id to its BlockInfo; a striped unit id
        resolves to its group (ref: BlockManager.getStoredBlock's
        BlockIdManager.convertToStripedID)."""
        info = self._blocks.get(block_id)
        if info is None and ec.is_striped_id(block_id):
            info = self._blocks.get(ec.group_id_of(block_id))
        return info

    def get(self, block_id: int) -> Optional[BlockInfo]:
        with self._lock:
            return self._blocks.get(block_id)

    def remove_block(self, block: Block) -> None:
        """File deleted: forget the block, queue replica invalidation.
        Ref: BlockManager.removeBlock."""
        with self._lock:
            info = self._blocks.pop(block.block_id, None)
            for q in self._needed:
                q.discard(block.block_id)
            self._pending_reconstruction.pop(block.block_id, None)
            # deletion tailed on a standby: postponed reports for this
            # block are moot — free their slots
            stale = self._postponed.pop(block.block_id, None)
            if stale:
                self._postponed_count -= len(stale)
            if info is None:
                return
            # node.blocks mutations stay under bm._lock like every other
            # replica-map touch (process_report iterates node.blocks -
            # reported under this lock; a concurrent discard would blow
            # up that set difference mid-iteration). dn_manager.get only
            # takes the DN-manager lock, which never calls back here.
            for uuid in info.locations:
                node = self.dn_manager.get(uuid)
                if node is None:
                    continue
                if isinstance(info, BlockInfoStriped):
                    idx = info.unit_map.get(uuid, 0)
                    unit = Block(info.block.block_id + idx,
                                 info.block.gen_stamp)
                    node.invalidate_queue.append(unit)
                    node.blocks.discard(unit.block_id)
                else:
                    node.invalidate_queue.append(info.block)
                    node.blocks.discard(block.block_id)

    def num_blocks(self) -> int:
        with self._lock:
            return len(self._blocks)

    # -------------------------------------------------------------- reports

    def process_report(self, uuid: str, blocks: List[Block]) -> None:
        """Full block report: reconcile the DN's replica set with ours.
        Ref: BlockManager.processReport:2731."""
        node = self.dn_manager.get(uuid)
        if node is None:
            return
        reported = {b.block_id: b for b in blocks}
        with self._lock:
            gone = node.blocks - set(reported)
            for bid in gone:
                self._remove_stored_block_locked(bid, node)
            for bid, blk in reported.items():
                self._add_stored_block_locked(blk, node)
        self.safemode.report_blocks()

    def add_stored_block(self, block: Block, uuid: str) -> None:
        """Incremental 'block received' report.
        Ref: BlockManager.addStoredBlock."""
        node = self.dn_manager.get(uuid)
        if node is None:
            return
        with self._lock:
            self._add_stored_block_locked(block, node)
        self.safemode.report_blocks()

    def remove_stored_block(self, block: Block, uuid: str) -> None:
        node = self.dn_manager.get(uuid)
        if node is None:
            return
        with self._lock:
            self._remove_stored_block_locked(block.block_id, node)

    def _add_stored_block_locked(self, block: Block,
                                 node: DatanodeDescriptor) -> None:
        info = self._resolve_locked(block.block_id)
        if info is None:
            if self.postpone_unknown:
                # Past the cap we DROP rather than invalidate: a lost
                # report self-heals at the next full block report, but
                # an invalidate issued from a lagging standby deletes
                # what may be the only replica of a committed block
                # after failover (commands queue on the descriptor and
                # dispatch once active — namenode.py issue_commands).
                if self._postponed_count < self.POSTPONED_MAX:
                    self._postponed.setdefault(block.block_id, []).append(
                        (block, node.uuid))
                    self._postponed_count += 1
                return
            # Replica of a deleted/unknown block → invalidate at the DN.
            node.invalidate_queue.append(block)
            return
        if self.postpone_unknown and \
                block.gen_stamp > info.block.gen_stamp:
            # Replica from the FUTURE relative to our namespace view
            # (pipeline recovery we haven't tailed yet) — same postpone
            # (same drop-past-cap rationale as above).
            if self._postponed_count < self.POSTPONED_MAX:
                self._postponed.setdefault(block.block_id, []).append(
                    (block, node.uuid))
                self._postponed_count += 1
            return
        if block.gen_stamp < info.block.gen_stamp:
            # Stale replica from a failed pipeline — corrupt by definition.
            info.corrupt_replicas.add(node.uuid)
            node.invalidate_queue.append(block)
            return
        if isinstance(info, BlockInfoStriped):
            idx = ec.unit_index_of(block.block_id)
            info.unit_map[node.uuid] = idx
            if block.num_bytes > info.unit_lengths.get(idx, 0):
                info.unit_lengths[idx] = block.num_bytes
        elif block.num_bytes > info.block.num_bytes:
            info.block.num_bytes = block.num_bytes
        info.locations.add(node.uuid)
        info.corrupt_replicas.discard(node.uuid)
        node.blocks.add(block.block_id)
        self._pending_reconstruction.pop(info.block.block_id, None)
        self._update_needed_locked(info)

    def _remove_stored_block_locked(self, block_id: int,
                                    node: DatanodeDescriptor) -> None:
        info = self._resolve_locked(block_id)
        node.blocks.discard(block_id)
        if info is None:
            return
        info.locations.discard(node.uuid)
        info.corrupt_replicas.discard(node.uuid)
        if isinstance(info, BlockInfoStriped):
            info.unit_map.pop(node.uuid, None)
        self._update_needed_locked(info)

    def mark_corrupt(self, block: Block, uuid: str) -> None:
        """Client/scanner found a bad replica. Ref: BlockManager
        .findAndMarkBlockAsCorrupt."""
        node = self.dn_manager.get(uuid)
        with self._lock:
            info = self._resolve_locked(block.block_id)
            if info is None or node is None:
                return
            info.corrupt_replicas.add(uuid)
            # Only invalidate once a healthy replica can replace it.
            if info.live_replicas() > 0:
                node.invalidate_queue.append(info.block)
                info.locations.discard(uuid)
                node.blocks.discard(block.block_id)
            self._update_needed_locked(info)

    # ----------------------------------------------------- replication queue

    def _update_needed_locked(self, info: BlockInfo) -> None:
        live = info.live_replicas()
        bid = info.block.block_id
        for q in self._needed:
            q.discard(bid)
        if info.under_construction:
            return
        if live < info.expected_replication:
            if bid in self._pending_reconstruction:
                return
            # Highest priority: one more loss makes the block unreadable.
            at_risk = live <= (info.policy.k if isinstance(
                info, BlockInfoStriped) else 1)
            self._needed[0 if at_risk else 1].add(bid)
        elif live > info.expected_replication:
            self._process_excess_locked(info)

    def _process_excess_locked(self, info: BlockInfo) -> None:
        """Drop excess replicas, most-loaded node first.
        Ref: BlockManager.processExtraRedundancyBlock."""
        if isinstance(info, BlockInfoStriped):
            return  # units are unique; nothing is "excess"
        nodes = [self.dn_manager.get(u)
                 for u in (info.locations - info.corrupt_replicas)]
        # Only LIVE-state replicas count toward (and are candidates for)
        # excess — copies on draining nodes are already leaving and
        # pruning live ones against them would starve the drain (ref:
        # countNodes' decommissioning vs live split).
        nodes = [n for n in nodes if n is not None
                 and n.state == DatanodeInfo.STATE_LIVE]
        excess = len(nodes) - info.expected_replication
        if excess <= 0:
            return
        # Drop policy-violating replicas first (the mover just created a
        # right-type copy; pruning it instead would undo the migration —
        # ref: the delNodeHint the reference's Dispatcher passes), then
        # most-loaded.
        from hadoop_tpu_torch.dfs.protocol.records import (POLICY_TYPES,
                                                     effective_storage_policy)
        wanted = POLICY_TYPES.get(effective_storage_policy(info.inode),
                                  ["DISK"])
        nodes.sort(key=lambda n: (n.storage_type in wanted, -len(n.blocks)))
        for node in nodes[:excess]:
            node.invalidate_queue.append(info.block)
            info.locations.discard(node.uuid)
            node.blocks.discard(info.block.block_id)

    def schedule_drain(self, node: DatanodeDescriptor) -> None:
        """Queue every block on a decommissioning node for re-replication.
        Striped unit ids resolve to their group."""
        with self._lock:
            for bid in list(node.blocks):
                info = self._resolve_locked(bid)
                if info is not None and not info.under_construction:
                    self._needed[2].add(info.block.block_id)

    def compute_reconstruction_work(self, max_work: int = 64) -> int:
        """RedundancyMonitor pass: assign transfer work to source DNs.
        Ref: BlockManager.computeBlockReconstructionWork."""
        now = time.monotonic()
        scheduled = 0
        with self._lock:
            # Expire pending reconstructions that never completed.
            for bid, deadline in list(self._pending_reconstruction.items()):
                if deadline < now:
                    del self._pending_reconstruction[bid]
                    info = self._blocks.get(bid)
                    if info is not None:
                        self._update_needed_locked(info)
            for q in self._needed:
                for bid in list(q):
                    if scheduled >= max_work:
                        return scheduled
                    info = self._blocks.get(bid)
                    if info is None:
                        q.discard(bid)
                        continue
                    if self._schedule_one_locked(info):
                        q.discard(bid)
                        scheduled += 1
        return scheduled

    def _schedule_one_locked(self, info: BlockInfo) -> bool:
        if isinstance(info, BlockInfoStriped):
            return self._schedule_ec_locked(info)
        live_uuids = info.locations - info.corrupt_replicas
        sources = [self.dn_manager.get(u) for u in live_uuids]
        sources = [s for s in sources if s is not None and s.state in
                   (DatanodeInfo.STATE_LIVE,
                    DatanodeInfo.STATE_DECOMMISSIONING,
                    DatanodeInfo.STATE_ENTERING_MAINTENANCE)]
        if not sources:
            return False  # unrecoverable for now (all replicas lost)
        # Decommission drains count live-elsewhere replicas as deficits too.
        deficit = info.expected_replication - len(
            [s for s in sources if s.state == DatanodeInfo.STATE_LIVE])
        if deficit <= 0:
            return True  # nothing to do (e.g. replicas recovered meanwhile)
        targets = self.dn_manager.choose_targets(
            deficit, exclude=set(info.locations))
        if not targets:
            return False
        src = min(sources, key=lambda s: len(s.transfer_queue))
        src.transfer_queue.append(
            (info.block, [t.public_info() for t in targets]))
        self._pending_reconstruction[info.block.block_id] = (
            time.monotonic() + self._pending_timeout_s)
        self._m_reconstructions.incr()
        return True

    def _schedule_ec_locked(self, info: BlockInfoStriped) -> bool:
        """Schedule reconstruction of missing striped units: the chosen
        target DN reads k surviving units from peers, decodes, and stores
        the missing unit (ref: BlockManager.scheduleReconstruction →
        BlockECReconstructionCommand; worker ErasureCodingWorker.java:47)."""
        # Units whose every holder is leaving (decommissioning) need a new
        # home just like lost ones (ref: DatanodeAdminManager's handling of
        # striped blocks with only decommissioning replicas).
        fully_live: Set[int] = set()
        sources = []
        for uuid, idx in info.unit_map.items():
            if uuid not in info.locations or uuid in info.corrupt_replicas:
                continue
            n = self.dn_manager.get(uuid)
            if n is None or n.state == DatanodeInfo.STATE_DEAD:
                continue
            sources.append((n.public_info().to_wire(), idx))
            if n.state == DatanodeInfo.STATE_LIVE:
                fully_live.add(idx)
        missing = [i for i in range(info.policy.num_units)
                   if i not in fully_live]
        if not missing:
            return True
        if len({idx for _, idx in sources}) < info.policy.k:
            return False  # unrecoverable until more units resurface
        targets = self.dn_manager.choose_targets(
            len(missing), exclude=set(info.unit_map))
        if not targets:
            return False
        for idx, target in zip(missing, targets):
            target.ec_queue.append({
                "group": info.block.to_wire(),
                "policy": info.policy.name,
                "idx": idx,
                "sources": sources,
            })
        self._pending_reconstruction[info.block.block_id] = (
            time.monotonic() + 2 * self._pending_timeout_s)
        self._m_reconstructions.incr()
        return True

    def is_node_drained(self, node: DatanodeDescriptor) -> bool:
        """True when no block on the node still depends on it."""
        n_live = len(self.dn_manager.live_nodes())  # loop-invariant
        with self._lock:
            for bid in list(node.blocks):
                info = self._resolve_locked(bid)
                if info is None or info.under_construction:
                    continue
                others = {u for u in (info.locations - info.corrupt_replicas)
                          if u != node.uuid}
                live_others = [u for u in others
                               if (n := self.dn_manager.get(u)) is not None
                               and n.state == DatanodeInfo.STATE_LIVE]
                if isinstance(info, BlockInfoStriped):
                    unit = ec.unit_index_of(bid)
                    if not any(info.unit_map.get(u) == unit
                               for u in live_others):
                        return False
                elif len(live_others) < min(info.expected_replication,
                                            n_live):
                    return False
            return True

    def blocks_on_node(self, uuid: str, max_blocks: int = 256,
                       min_size: int = 0) -> List[Block]:
        """Blocks stored on a node, biggest first — the balancer's source
        inventory (ref: NamenodeProtocol.getBlocks)."""
        node = self.dn_manager.get(uuid)
        if node is None:
            return []
        out: List[Block] = []
        with self._lock:
            for bid in list(node.blocks):
                info = self._resolve_locked(bid)
                if info is None or info.under_construction or \
                        isinstance(info, BlockInfoStriped):
                    continue  # balancer moves contiguous replicas only
                if info.block.num_bytes >= min_size:
                    out.append(info.block)
        out.sort(key=lambda b: -b.num_bytes)
        return out[:max_blocks]

    def invalidate_replica(self, block: Block, uuid: str) -> bool:
        """Drop one specific replica (mover/balancer cleanup; ref: the
        excess-replica choice the Dispatcher makes via delHints)."""
        node = self.dn_manager.get(uuid)
        with self._lock:
            info = self._resolve_locked(block.block_id)
            if info is None or node is None:
                return False
            if info.live_replicas() <= 1:
                return False  # never drop the last copy
            node.invalidate_queue.append(block)
            info.locations.discard(uuid)
            node.blocks.discard(block.block_id)
            self._update_needed_locked(info)
            return True

    def node_died(self, node: DatanodeDescriptor) -> None:
        """All replicas on a dead node are gone; requeue its blocks."""
        with self._lock:
            for bid in list(node.blocks):
                self._remove_stored_block_locked(bid, node)

    # --------------------------------------------------------------- queries

    def located_block(self, block: Block, offset: int,
                      reader_host: Optional[str] = None) -> LocatedBlock:
        with self._lock:
            info = self._blocks.get(block.block_id)
            if info is None:
                return LocatedBlock(block, [], offset)
            if isinstance(info, BlockInfoStriped):
                locs, indices = [], []
                for uuid in info.locations - info.corrupt_replicas:
                    node = self.dn_manager.get(uuid)
                    if node is not None and \
                            node.state != DatanodeInfo.STATE_DEAD and \
                            uuid in info.unit_map:
                        locs.append(node.public_info())
                        indices.append(info.unit_map[uuid])
                return LocatedBlock(info.block, locs, offset,
                                    corrupt=len(set(indices)) < info.policy.k,
                                    ec_policy=info.policy.name,
                                    indices=indices)
            locs = []
            for uuid in info.locations - info.corrupt_replicas:
                node = self.dn_manager.get(uuid)
                if node is not None and node.state != DatanodeInfo.STATE_DEAD:
                    locs.append(node.public_info())
            random.shuffle(locs)  # spread read load among equals
            if reader_host:
                # closest-first for this reader (ref: DatanodeManager
                # .sortLocatedBlocks); the shuffle above still spreads
                # load within each distance class (sort is stable)
                locs = self.dn_manager.topology.sort_by_distance(
                    reader_host, locs)
            cached = self.cached_holders(info.block.block_id)
            if cached:
                # memory-resident replicas first (ref: cachedLocations)
                locs = sorted(locs,
                              key=lambda d: d.uuid not in cached)
            return LocatedBlock(info.block, locs, offset,
                                corrupt=(not locs and bool(info.locations)),
                                cached_uuids=cached)

    def complete_block(self, block: Block) -> None:
        with self._lock:
            info = self._blocks.get(block.block_id)
            if info is not None:
                info.under_construction = False
                info.block.num_bytes = block.num_bytes
                self._update_needed_locked(info)

    # --------------------------------------------------------------- cache

    def report_cached(self, uuid: str, cached_ids: List[int]) -> None:
        """DN's full cached-set report (ref: DatanodeProtocol
        cacheReport)."""
        node = self.dn_manager.get(uuid)
        if node is not None:
            node.cached_blocks = set(cached_ids)

    def cached_holders(self, block_id: int) -> List[str]:
        with self._lock:
            info = self._blocks.get(block_id)
            if info is None:
                return []
            holders = info.locations - info.corrupt_replicas
        out = []
        for uuid in holders:
            node = self.dn_manager.get(uuid)
            if node is not None and block_id in node.cached_blocks:
                out.append(uuid)
        return out

    def reconcile_cache(self, wanted_block_ids: Set[int]) -> None:
        """CacheReplicationMonitor pass (ref: blockmanagement/
        CacheReplicationMonitor.java): queue CACHE work for directive-
        covered blocks with no cached replica, UNCACHE for cached blocks
        no directive covers."""
        with self._lock:
            want = {bid: self._blocks.get(bid) for bid in wanted_block_ids}
        for bid, info in want.items():
            if info is None:
                continue
            holders = [u for u in (info.locations - info.corrupt_replicas)]
            nodes = [self.dn_manager.get(u) for u in holders]
            nodes = [n for n in nodes
                     if n is not None
                     and n.state == DatanodeInfo.STATE_LIVE]
            if not nodes:
                continue
            if any(bid in n.cached_blocks
                   or any(b.block_id == bid for b in n.cache_queue)
                   for n in nodes):
                continue
            pick = min(nodes, key=lambda n: len(n.cached_blocks))
            pick.cache_queue.append(info.block)
        # uncache anything no directive wants
        for node in list(self.dn_manager._nodes.values()):
            for bid in list(node.cached_blocks):
                if bid not in wanted_block_ids:
                    with self._lock:
                        info = self._blocks.get(bid)
                    if info is not None and not any(
                            b.block_id == bid for b in node.uncache_queue):
                        node.uncache_queue.append(info.block)

    def under_replicated_count(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._needed[:2])


class SafeMode:
    """Startup safemode: reject mutations until enough blocks are reported.
    Ref: blockmanagement/BlockManagerSafeMode.java."""

    def __init__(self, bm: BlockManager, conf: Configuration):
        self.bm = bm
        self.threshold = conf.get_float(
            "dfs.namenode.safemode.threshold-pct", 0.999)
        self.extension_s = conf.get_time_seconds(
            "dfs.namenode.safemode.extension", 0.0)
        self._on = True
        self._manual = False
        self._block_total = 0
        self._reached_at: Optional[float] = None
        self._lock = threading.Lock()

    def set_block_total(self, total: int) -> None:
        with self._lock:
            self._block_total = total
        self.report_blocks()

    def is_on(self) -> bool:
        return self._on

    def enter_manual(self) -> None:
        with self._lock:
            self._on = True
            self._manual = True

    def leave(self, force: bool = False) -> None:
        with self._lock:
            self._on = False
            self._manual = False
        log.info("Safemode is OFF%s", " (forced)" if force else "")

    def _blocks_safe(self) -> int:
        count = 0
        with self.bm._lock:
            for info in self.bm._blocks.values():
                need = info.policy.k if isinstance(info, BlockInfoStriped) \
                    else self.bm.min_replication
                if info.under_construction or info.live_replicas() >= need:
                    count += 1
        return count

    def report_blocks(self) -> None:
        if not self._on or self._manual:
            return
        import math
        with self._lock:
            needed = math.ceil(self.threshold * self._block_total)
            if self._blocks_safe() >= needed:
                if self._reached_at is None:
                    self._reached_at = time.monotonic()
                if time.monotonic() - self._reached_at >= self.extension_s:
                    self._on = False
                    log.info("Safemode is OFF (threshold reached)")
            else:
                self._reached_at = None

    def status(self) -> Dict:
        with self._lock:
            return {"on": self._on, "manual": self._manual,
                    "block_total": self._block_total,
                    "blocks_safe": self._blocks_safe() if self._on else None,
                    "threshold": self.threshold}
