"""DataNode daemon: block store + streaming server + NN heartbeat actor.

The port's copy of ``hadoop_tpu/dfs/datanode/datanode.py``, on the same
wire and disk formats.

Parity with the reference (ref: server/datanode/DataNode.java (3,788 LoC;
:1388 startDataNode, :2975 main), BPServiceActor.java:516 sendHeartBeat /
:643 offerService): registers with the NameNode, heartbeats on an interval
(NN commands ride the response), sends incremental "received/deleted" reports
promptly and full block reports periodically, and executes TRANSFER /
INVALIDATE / RECOVER commands.
"""

from __future__ import annotations

import logging
import os
import threading
import uuid as uuid_mod
from typing import Dict, List, Optional, Tuple

from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.datanode.blockstore import BlockStore
from hadoop_tpu_torch.dfs.datanode.xceiver import DataXceiverServer, push_block
from hadoop_tpu_torch.dfs.protocol.records import Block, DatanodeInfo, DnCommand
from hadoop_tpu_torch.ipc import Client, get_proxy
from hadoop_tpu_torch.service import AbstractService
from hadoop_tpu_torch.util.misc import Daemon

log = logging.getLogger(__name__)

DATA_DIR_DEFAULT = "/tmp/htpu-data"


class DataNodeFaultInjector:
    """Overridable fault-injection points, compiled into the main code the
    way the reference does it (ref: server/datanode/DataNodeFaultInjector
    .java; call site DataXceiver.java:848). Tests install a subclass via
    ``DataNodeFaultInjector.set(instance)``."""

    _instance: "DataNodeFaultInjector" = None  # type: ignore[assignment]

    @classmethod
    def get(cls) -> "DataNodeFaultInjector":
        if cls._instance is None:
            cls._instance = DataNodeFaultInjector()
        return cls._instance

    @classmethod
    def set(cls, inst: Optional["DataNodeFaultInjector"]) -> None:
        cls._instance = inst

    # ---- hooks (no-ops by default) ----
    def before_write_block(self, block: Block) -> None: ...
    def before_packet_write(self, block: Block, pkt: dict) -> None: ...
    def before_read_block(self, block: Block, port: int = 0) -> None: ...
    def corrupt_read_packet(self, block, data, sums) -> Tuple[bytes, bytes]:
        return data, sums
    def before_heartbeat(self, dn: "DataNode") -> None: ...


class DataNode(AbstractService):
    """One actor loop per configured NameNode (ref: BPServiceActor — the
    DN heartbeats/reports to EVERY NN of the nameservice so standbys stay
    block-map-warm and promotion needs no report storm)."""

    def __init__(self, conf: Configuration, data_dir: Optional[str] = None,
                 nn_addr=None):
        super().__init__("DataNode")
        # dfs.datanode.data.dir is a comma list (ref: FsVolumeList);
        # the first entry is the primary/metadata volume
        self.data_dir = data_dir or conf.get_list(
            "dfs.datanode.data.dir", [DATA_DIR_DEFAULT])[0]
        host = conf.get("dfs.datanode.hostname", "127.0.0.1")
        if nn_addr is None:
            from hadoop_tpu_torch.util.misc import parse_addr_list
            self.nn_addrs = parse_addr_list(conf.get(
                "dfs.namenode.rpc-address", "127.0.0.1:8020"))
        elif isinstance(nn_addr, tuple):
            self.nn_addrs = [nn_addr]
        else:
            self.nn_addrs = list(nn_addr)
        self.host = host
        self.uuid = self._load_or_create_uuid()
        self.store: Optional[BlockStore] = None
        self.xceiver: Optional[DataXceiverServer] = None
        self._client: Optional[Client] = None
        self._stop_event = threading.Event()
        self._actors: List["_BPServiceActor"] = []

    def _load_or_create_uuid(self) -> str:
        os.makedirs(self.data_dir, exist_ok=True)
        path = os.path.join(self.data_dir, "VERSION")
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    if line.startswith("datanodeUuid="):
                        return line.split("=", 1)[1].strip()
        u = str(uuid_mod.uuid4())
        with open(path, "w") as f:
            f.write(f"datanodeUuid={u}\n")
        return u

    @property
    def xfer_port(self) -> int:
        return self.xceiver.port

    def datanode_info(self) -> DatanodeInfo:
        stats = self.store.stats()
        http = getattr(self, "http", None)
        return DatanodeInfo(self.uuid, self.host, self.xceiver.port,
                            capacity=stats["capacity"],
                            dfs_used=stats["dfs_used"],
                            remaining=stats["remaining"],
                            storage_type=self.config.get(
                                "dfs.datanode.storage.type", "DISK"),
                            # admin-HTTP port rides registration (ref:
                            # DatanodeID.infoPort) so the NN's
                            # /ws/v1/datanodes roster can point the
                            # fleet doctor at this node's /ws/v1/peers
                            info_port=http.port if http else 0)

    # ------------------------------------------------------------- lifecycle

    def service_init(self, conf: Configuration) -> None:
        # Multi-volume node when dfs.datanode.data.dir lists several
        # directories (ref: a comma list backing FsVolumeList; the old
        # "data.dirs" spelling is a registered DeprecationDelta);
        # single-volume stays on the plain BlockStore.
        dirs = conf.get_list("dfs.datanode.data.dir")
        extra_dirs = dirs if len(dirs) > 1 else []
        n_vols = conf.get_int("dfs.datanode.volumes", 1)
        if not extra_dirs and n_vols > 1:
            extra_dirs = [os.path.join(self.data_dir, f"current{i}")
                          for i in range(n_vols)]
        cap = conf.get_size_bytes("dfs.datanode.capacity", 0)
        sync = conf.get_bool("dfs.datanode.synconclose", False)
        if len(extra_dirs) > 1:
            from hadoop_tpu_torch.dfs.datanode.volumes import VolumeSet
            self.store = VolumeSet(
                [d.strip() for d in extra_dirs], capacity_override=cap,
                sync_on_close=sync,
                policy=conf.get("dfs.datanode.volume-choosing-policy",
                                "available-space"))
        else:
            self.store = BlockStore(
                extra_dirs[0].strip() if extra_dirs
                else os.path.join(self.data_dir, "current"),
                capacity_override=cap, sync_on_close=sync,
                drop_behind_writes=conf.get_bool(
                    "dfs.datanode.drop.cache.behind.writes", False))
        security_keys = None
        if conf.get_bool("dfs.encrypt.data.transfer", False):
            from hadoop_tpu_torch.dfs.protocol.datatransfer import \
                DataEncryptionKeys
            security_keys = DataEncryptionKeys()
        self.xceiver = DataXceiverServer(
            self.store, self._on_block_received, bind_host=self.host,
            port=conf.get_int("dfs.datanode.port", 0),
            security_keys=security_keys,
            required_qop=conf.get("dfs.data.transfer.protection",
                                  "privacy"))
        # Block access tokens: verification-only manager, keys arrive
        # from the NN over DatanodeProtocol.get_block_keys (ref:
        # ExportedBlockKeys at registration + rotation refresh).
        self.block_tokens = None
        if conf.get_bool("dfs.block.access.token.enable", False):
            from hadoop_tpu_torch.dfs.protocol.blocktoken import \
                BlockTokenSecretManager
            self.block_tokens = BlockTokenSecretManager.for_verification()
            self.xceiver.block_tokens = self.block_tokens
        # fd-passing short-circuit server (ref: dfs.domain.socket.path
        # with _PORT placeholder; DataXceiver.requestShortCircuitFds)
        self.domain_server = None
        self._domain_template = conf.get("dfs.domain.socket.path", "")
        self.heartbeat_interval = conf.get_time_seconds(
            "dfs.heartbeat.interval", 3.0)
        self.block_report_interval = conf.get_time_seconds(
            "dfs.blockreport.interval", 6 * 3600.0)
        # Background integrity scanners (0 = disabled).
        # Ref: dfs.datanode.scan.period.hours (VolumeScanner.java:55) and
        # dfs.datanode.directoryscan.interval (DirectoryScanner.java:64).
        self.volume_scan_interval = conf.get_time_seconds(
            "dfs.datanode.scan.period", 3 * 3600.0)
        self.dir_scan_interval = conf.get_time_seconds(
            "dfs.datanode.directoryscan.interval", 6 * 3600.0)
        # ref: dfs.datanode.max.locked.memory
        self.store.max_cache_bytes = conf.get_size_bytes(
            "dfs.datanode.max.locked.memory", 64 * 1024 * 1024)
        self._client = Client(conf)

    def service_start(self) -> None:
        self.xceiver.start()
        if self._domain_template:
            from hadoop_tpu_torch.dfs.datanode.domainsocket import (
                DomainPeerServer, socket_path_for)
            checker = None
            if self.block_tokens is not None:
                from hadoop_tpu_torch.dfs.protocol import blocktoken as bt

                def checker(req, block):
                    self.block_tokens.check_access(
                        req.get("tok"), block.block_id, bt.MODE_READ)
            self.domain_server = DomainPeerServer(
                socket_path_for(self._domain_template, self.xceiver.port),
                self.store.open_for_read, token_checker=checker)
            self.domain_server.start()
            self.xceiver.domain_socket_path = self.domain_server.path
        self.http = None
        if self.config.get_bool("dfs.datanode.http.enabled", True):
            from hadoop_tpu_torch.http.server import HttpServer
            self.http = HttpServer(
                self.config,
                bind=("127.0.0.1",
                      self.config.get_int("dfs.datanode.http-port", 0)),
                daemon_name=f"datanode-{self.uuid[:8]}")
            self.http.add_handler(
                "/blockstats", lambda q, b: (200, self.store.stats()))
            self.http.add_handler(
                "/diskbalancer", self._diskbalancer_endpoint)
            # rolling per-peer pipeline latencies + own service times —
            # what the fleet doctor's slow-node detection scrapes
            self.http.add_handler(
                "/ws/v1/peers",
                lambda q, b: (200,
                              self.xceiver.peer_tracker.to_report(
                                  self.uuid)))
            self.http.start()
        for addr in self.nn_addrs:
            actor = _BPServiceActor(self, addr)
            self._actors.append(actor)
            actor.start()
        if self.volume_scan_interval > 0:
            Daemon(self._volume_scan_loop,
                   f"volume-scanner-{self.uuid[:8]}").start()
        if self.dir_scan_interval > 0:
            Daemon(self._dir_scan_loop,
                   f"directory-scanner-{self.uuid[:8]}").start()
        log.info("DataNode %s up (xfer port %d, NNs %s)", self.uuid[:8],
                 self.xceiver.port, self.nn_addrs)

    def service_stop(self) -> None:
        self._stop_event.set()
        if getattr(self, "http", None) is not None:
            self.http.stop()
        if getattr(self, "domain_server", None) is not None:
            self.domain_server.stop()
        if self.xceiver:
            self.xceiver.stop()
        if self._client:
            self._client.stop()

    # ---------------------------------------------------------- NN reporting

    @property
    def nn_addr(self):
        """First NN address (compat for single-NN callers/tests)."""
        return self.nn_addrs[0]

    @nn_addr.setter
    def nn_addr(self, addr) -> None:
        self.nn_addrs[0] = addr
        if self._actors:
            self._actors[0].nn_addr = addr

    def _on_block_received(self, block: Block) -> None:
        for actor in self._actors:
            actor.note_received(block)

    def _on_block_deleted(self, block: Block) -> None:
        for actor in self._actors:
            actor.note_deleted(block)

    def _diskbalancer_endpoint(self, query, body):
        """report/plan/execute over the admin HTTP surface (the reference
        drives these over ClientDatanodeProtocol:
        submitDiskBalancerPlan/queryDiskBalancerPlan)."""
        from hadoop_tpu_torch.dfs.datanode.volumes import DiskBalancer, VolumeSet
        action = query.get("action", "report")
        if not isinstance(self.store, VolumeSet):
            return 400, {"error": "not a multi-volume datanode"}
        db = DiskBalancer(self.store)
        if action == "report":
            return 200, db.report()
        threshold = float(query.get("threshold", 0.10))
        plan = db.plan(threshold)
        if action == "plan":
            return 200, {"moves": plan}
        if action == "execute":
            return 200, db.execute(plan)
        return 400, {"error": f"unknown action {action!r}"}

    # -------------------------------------------------------------- scanners

    def _report_cached(self) -> None:
        ids = self.store.cached_ids()
        for actor in self._actors:
            try:
                if actor._proxy is not None:
                    actor._proxy.report_cached(self.uuid, ids)
            except Exception as e:  # noqa: BLE001
                log.debug("cache report to %s failed: %s",
                          actor.nn_addr, e)

    def _report_bad_block(self, block: Block) -> None:
        """Self-detected rot → every NN (ref: the VolumeScanner's
        reportBadBlocks path through the BPOS)."""
        for actor in self._actors:
            try:
                if actor._proxy is not None:
                    actor._proxy.report_bad_blocks(
                        [block.to_wire()], [self.uuid])
            except Exception as e:  # noqa: BLE001 — next heartbeat retries
                log.warning("bad-block report to %s failed: %s",
                            actor.nn_addr, e)

    def _volume_scan_loop(self) -> None:
        """Slow CRC sweep: one full pass over finalized replicas per
        period, spread evenly. Ref: VolumeScanner.java:55 (its
        bytes-per-second throttle becomes an even per-period spread)."""
        from hadoop_tpu_torch.util.crc import ChecksumError
        while not self._stop_event.is_set():
            blocks = self.store.all_finalized()
            pause = self.volume_scan_interval / max(len(blocks), 1)
            for block in blocks:
                if self._stop_event.wait(min(pause,
                                             self.volume_scan_interval)):
                    return
                try:
                    self.store.verify_replica(block)
                except ChecksumError as e:
                    log.warning("Volume scanner found rot in %s: %s",
                                block, e)
                    self._report_bad_block(block)
                except IOError:
                    pass  # replica finalized/invalidated mid-scan
            if not blocks and self._stop_event.wait(
                    self.volume_scan_interval):
                return

    def _dir_scan_loop(self) -> None:
        """Memory↔disk reconciliation. Ref: DirectoryScanner.java:64."""
        while not self._stop_event.wait(self.dir_scan_interval):
            try:
                vanished, adopted = self.store.reconcile()
            except OSError as e:
                log.warning("directory scan failed: %s", e)
                continue
            for block in vanished:
                log.warning("Directory scanner: replica %s vanished from "
                            "disk", block)
                # report it DELETED (it is): the NN drops this location
                # and re-replicates from the healthy copies — a bad-block
                # report would dead-end in invalidating a missing file
                self._on_block_deleted(block)
            for block in adopted:
                log.info("Directory scanner: adopted on-disk replica %s",
                         block)
                self._on_block_received(block)

    # -------------------------------------------------------------- commands

    def _execute(self, cmd: DnCommand) -> bool:
        """Returns False to force re-registration."""
        if cmd.action == DnCommand.REREGISTER:
            return False
        if cmd.action == DnCommand.INVALIDATE:
            for b in cmd.blocks:
                if self.store.invalidate(b):
                    self._on_block_deleted(b)
        elif cmd.action == DnCommand.TRANSFER:
            for block, targets in zip(cmd.blocks, cmd.targets):
                Daemon(self._transfer, "dn-transfer",
                       args=(block, targets)).start()
        elif cmd.action == DnCommand.EC_RECONSTRUCT:
            Daemon(self._ec_reconstruct, "dn-ec-worker",
                   args=(cmd.extra,)).start()
        elif cmd.action == DnCommand.CACHE:
            # pin replicas in memory + report the new cached set (ref:
            # FsDatasetCache.cacheBlock + DatanodeProtocol.cacheReport)
            for b in cmd.blocks:
                if not self.store.cache_block(b):
                    log.info("could not cache %s (budget/missing)", b)
            self._report_cached()
        elif cmd.action == DnCommand.UNCACHE:
            for b in cmd.blocks:
                self.store.uncache_block(b.block_id)
            self._report_cached()
        elif cmd.action == DnCommand.RECOVER:
            # Block recovery: bump the stamp and promote the rbw replica to
            # finalized at its current length, then report it.
            # Ref: DataNode.recoverBlocks / BlockRecoveryWorker.
            for block, new_gs in zip(cmd.blocks, cmd.new_gen_stamps):
                try:
                    self.store.update_gen_stamp(block.block_id, new_gs)
                    rep = self.store.finalize_existing(block.block_id)
                    if rep is not None:
                        self._on_block_received(rep.to_block())
                except IOError as e:
                    log.warning("recover of %s failed: %s", block, e)
        return True

    def _ec_reconstruct(self, payload: Dict) -> None:
        """Ref: ErasureCodingWorker.processErasureCodingTasks."""
        from hadoop_tpu_torch.dfs.datanode import ec_worker
        rebuilt = ec_worker.reconstruct(
            self.store, payload, security=self.xceiver._dial_security(),
            block_tokens=self.block_tokens)
        if rebuilt is not None:
            self._on_block_received(rebuilt)

    def _transfer(self, block: Block, targets) -> None:
        try:
            rep = self.store.get_replica(block.block_id)
            if rep is None:
                log.warning("asked to transfer %s but replica not found", block)
                return
            push_block(self.store, rep.to_block(), targets,
                       block_tokens=self.block_tokens,
                       security=self.xceiver._dial_security())
            log.info("Transferred %s to %s", block, targets)
        except Exception as e:  # noqa: BLE001
            log.warning("transfer of %s failed: %s", block, e)


class _BPServiceActor:
    """One DN→NN reporting loop. Ref: server/datanode/BPServiceActor.java
    (:516 sendHeartBeat, :643 offerService)."""

    def __init__(self, dn: DataNode, nn_addr: Tuple[str, int]):
        self.dn = dn
        self.nn_addr = nn_addr
        self._lock = threading.Lock()
        self._received: List[Block] = []
        self._deleted: List[Block] = []
        self._proxy = None
        # Immediate-IBR wake (ref: BPServiceActor.sendImmediateIBR /
        # triggerBlockReportForTests): a finalized replica must reach
        # the NN NOW, not on the next heartbeat tick — the client's
        # completeFile() polls with backoff, so a heartbeat-cadence IBR
        # turns every small-file close into a ~0.75 s stall.
        self._wake = threading.Event()

    def start(self) -> None:
        Daemon(self._offer_service,
               f"bp-actor-{self.dn.uuid[:8]}-{self.nn_addr[1]}").start()

    def note_received(self, block: Block) -> None:
        with self._lock:
            self._received.append(block)
        self._wake.set()

    def note_deleted(self, block: Block) -> None:
        with self._lock:
            self._deleted.append(block)
        self._wake.set()

    def _offer_service(self) -> None:
        """Main actor loop. Ref: BPServiceActor.offerService:643."""
        dn = self.dn
        registered = False
        last_full_report = 0.0
        import time as _time
        self._proxy = get_proxy("DatanodeProtocol", self.nn_addr,
                                client=dn._client)
        # PROVIDED storage: the xceiver resolves block aliases through
        # this NN (any actor's proxy works; last writer wins).
        dn.xceiver.alias_resolver = \
            lambda bid: self._proxy.get_block_alias(bid)
        while not dn._stop_event.is_set():
            try:
                if not registered:
                    self._proxy.register_datanode(
                        dn.datanode_info().to_wire())
                    if dn.xceiver.security_keys is not None:
                        dn.xceiver.security_keys.update(
                            self._proxy.get_data_encryption_keys())
                    if dn.block_tokens is not None:
                        dn.block_tokens.import_keys(
                            self._proxy.get_block_keys())
                    registered = True
                    self._send_full_report()
                    last_full_report = _time.monotonic()
                self._flush_incremental_reports()
                DataNodeFaultInjector.get().before_heartbeat(dn)
                stats = dn.store.stats()
                cmds = self._proxy.send_heartbeat(
                    dn.uuid, stats["capacity"], stats["dfs_used"],
                    stats["remaining"], dn.xceiver.active_xceivers)
                for c in cmds:
                    registered &= dn._execute(DnCommand.from_wire(c))
                if _time.monotonic() - last_full_report > \
                        dn.block_report_interval:
                    self._send_full_report()
                    if dn.xceiver.security_keys is not None:
                        # Piggyback key refresh: the report interval (6h)
                        # is inside the key-rotation window (10h TTL,
                        # rotated at 80%), so a DN never serves with only
                        # expired keys.
                        dn.xceiver.security_keys.update(
                            self._proxy.get_data_encryption_keys())
                    if dn.block_tokens is not None:
                        dn.block_tokens.import_keys(
                            self._proxy.get_block_keys())
                    last_full_report = _time.monotonic()
            except Exception as e:  # noqa: BLE001 — survive NN bounces
                log.debug("heartbeat round to %s failed (%s); will retry",
                          self.nn_addr, e)
                registered = False
                # NN may have restarted on a new address (minicluster) —
                # rebuild the proxy from the current nn_addr.
                self._proxy = get_proxy("DatanodeProtocol", self.nn_addr,
                                        client=dn._client)
            # Sleep until the next heartbeat, but wake early to flush
            # incremental reports the moment a block lands/deletes.
            deadline = _time.monotonic() + dn.heartbeat_interval
            while not dn._stop_event.is_set():
                rem = deadline - _time.monotonic()
                if rem <= 0:
                    break
                if not self._wake.wait(timeout=min(rem, 0.25)):
                    continue
                self._wake.clear()
                try:
                    self._flush_incremental_reports()
                except Exception:  # noqa: BLE001 — NN bounce
                    registered = False
                    break  # next outer iteration rebuilds + re-registers

    def _send_full_report(self) -> None:
        blocks = [b.to_wire() for b in self.dn.store.all_finalized()]
        self._proxy.block_report(self.dn.uuid, blocks)

    def _flush_incremental_reports(self) -> None:
        with self._lock:
            received, self._received = self._received, []
            deleted, self._deleted = self._deleted, []
        if received or deleted:
            try:
                self._proxy.block_received_and_deleted(
                    self.dn.uuid, [b.to_wire() for b in received],
                    [b.to_wire() for b in deleted])
            except Exception:
                # NN unreachable/bouncing: put the reports BACK — a
                # dropped IBR means the NN never learns the replica
                # exists until the next full report (hours).
                with self._lock:
                    self._received[:0] = received
                    self._deleted[:0] = deleted
                # No _wake.set() here: the next heartbeat-cadence flush
                # retries; waking now would busy-spin against a dead NN.
                raise
