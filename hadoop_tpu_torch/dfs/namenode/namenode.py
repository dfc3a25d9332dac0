"""NameNode daemon: RPC surface + background monitors.

The port's copy of ``hadoop_tpu/dfs/namenode/namenode.py``, on the same
RPC protocols, name directory and HTTP pages, so either package's
clients, DataNodes and name directories work with it. With
``dfs.namenode.shared.edits.dir`` set it runs HA over a quorum of
either package's JournalNodes (``dfs/qjournal.py``): it boots standby,
tails the shared edits, and is promoted by the failover controller or
``HAServiceProtocol``; ``dfs.ha.initial-state=observer`` makes it an
observer that serves reads.

Parity with the reference (ref: server/namenode/NameNode.java:722 initialize,
:1701 createNameNode, :1821 main; NameNodeRpcServer.java (2,659 LoC; :781
create)): hosts two RPC protocols on one server —

- ``ClientProtocol`` — namespace + block allocation ops for DFS clients
  (ref: hdfs/protocol/ClientProtocol.java)
- ``DatanodeProtocol`` — registration, heartbeats (commands ride the
  response), full + incremental block reports
  (ref: server/protocol/DatanodeProtocol.java, BPServiceActor's view)

Background: RedundancyMonitor (re-replication work + dead-node sweep,
ref: BlockManager.RedundancyMonitor), lease monitor (ref: LeaseManager
.Monitor), checkpointer (ref: StandbyCheckpointer.java:194 — here a periodic
local checkpoint; in HA the standby checkpoints, ``ha.StandbyCheckpointer``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.namenode import ha
from hadoop_tpu_torch.dfs.namenode.fsnamesystem import FSNamesystem
from hadoop_tpu_torch.dfs.protocol.records import Block, DatanodeInfo
from hadoop_tpu_torch.ipc import Server, current_call, idempotent
from hadoop_tpu_torch.ipc.retry_cache import RetryCache
from hadoop_tpu_torch.security.ugi import AccessControlError
from hadoop_tpu_torch.ipc.errors import RetriableError
from hadoop_tpu_torch.ipc.server import CallContext
from hadoop_tpu_torch.service import AbstractService
from hadoop_tpu_torch.util.misc import Daemon

log = logging.getLogger(__name__)

# ClientProtocol methods that mutate the namespace — everything else is a
# read (ref: the OperationCategory.WRITE annotations in NameNodeRpcServer).
WRITE_METHODS = frozenset({
    "create", "add_block", "abandon_block", "complete", "update_pipeline",
    "mkdirs", "delete", "rename", "set_replication", "set_times",
    "set_permission", "set_owner", "recover_lease", "set_safemode",
    "save_namespace", "decommission_datanode", "set_ec_policy", "msync",
    # Lease renewal and corruption reports mutate active-side state; an
    # observer silently swallowing them would expire live writers.
    "renew_lease", "report_bad_blocks",
    # Namespace-feature mutations.
    "set_quota", "set_xattr", "remove_xattr", "set_acl", "remove_acl",
    "create_encryption_zone", "add_cache_directive",
    "remove_cache_directive",
    "set_storage_policy", "allow_snapshot", "disallow_snapshot",
    "create_snapshot", "delete_snapshot", "rename_snapshot", "concat",
    "truncate",
    # Admin/balancer mutations.
    "start_maintenance", "stop_maintenance", "invalidate_replica",
    "add_provided_file",
})


_dek_insecure_warned = False


def _check_dek_channel(fsn) -> None:
    """Gate data-encryption-key RPCs on the transport that carries them.

    On a secured cluster the DEK is the whole data-plane secret: serving
    it over an unprotected channel makes dfs.encrypt.data.transfer
    security theater (ref: the NN only issues DEKs on Kerberos-secured,
    QoP-protected RPC — SaslDataTransferClient/DataEncryptionKeyFactory).
    So: hadoop.security.authentication=sasl ⇒ the calling connection
    must have negotiated privacy QoP; simple-auth (dev/test) clusters
    get a one-time loud warning instead, matching the reference's
    insecure-cluster posture.
    """
    global _dek_insecure_warned
    secured = fsn.conf.get(
        "hadoop.security.authentication", "simple").lower() == "sasl"
    ctx = current_call()
    qop = getattr(ctx, "sasl_qop", None) if ctx is not None else None
    if secured:
        if qop != "privacy":
            raise AccessControlError(
                "data encryption keys are only served over SASL "
                "privacy-protected RPC on a secured cluster "
                f"(connection qop={qop!r})")
    elif not _dek_insecure_warned:
        _dek_insecure_warned = True
        log.warning(
            "dfs.encrypt.data.transfer is on but RPC authentication is "
            "'simple': encryption keys travel over an unauthenticated "
            "channel and protect only against passive mistakes, not "
            "attackers. Set hadoop.security.authentication=sasl with "
            "hadoop.rpc.protection=privacy for real protection.")


def _check_admin_caller(fsn) -> None:
    """Master-key-grade RPCs are restricted to cluster administrators.

    DEKs (above) are per-connection material every client legitimately
    needs; block-token MASTER keys let the holder mint arbitrary access
    tokens, so handing them to any authenticated client would void
    block-token authorization entirely. The reference keeps getBlockKeys
    on NamenodeProtocol behind service-level ACLs reserved for the
    balancer/admin principals (ref: HDFSPolicyProvider's
    security.namenode.protocol.acl). Admins = the NN's own user plus
    ``dfs.cluster.administrators``.
    """
    ctx = current_call()
    if ctx is None or ctx.user is None:
        return  # in-process embedding (tools linking the NN directly)
    import getpass
    admins = {a.strip() for a in
              (fsn.conf.get("dfs.cluster.administrators", "") or ""
               ).split(",") if a.strip()}
    admins.add(getpass.getuser())
    user = ctx.user
    real = getattr(user, "real_user", None)
    if user.user_name not in admins and \
            (real is None or real.user_name not in admins):
        raise AccessControlError(
            f"user {user.user_name!r} is not a cluster administrator; "
            "block-token master keys are admin-only")


class ClientProtocol:
    """RPC facade over FSNamesystem. Ref: NameNodeRpcServer.java — the thin
    translation layer; at-most-once mutations go through the retry cache."""

    def __init__(self, fsn: FSNamesystem, retry_cache: RetryCache,
                 state_getter=lambda: ha.ACTIVE):
        self.fsn = fsn
        self.retry_cache = retry_cache
        self._state = state_getter

    def _cached(self, fn, *args):
        """Retry-cache wrapper for non-idempotent mutations.
        Ref: FSNamesystem's RetryCache.waitForCompletion call sites."""
        ctx = current_call()
        if ctx is None or not ctx.client_id:
            return fn(*args)
        entry = self.retry_cache.wait_for_completion(ctx.client_id, ctx.call_id)
        if entry.done:
            return entry.payload
        try:
            result = fn(*args)
        except BaseException:
            self.retry_cache.complete(entry, False)
            raise
        self.retry_cache.complete(entry, True, result)
        return result

    # namespace ------------------------------------------------------------

    def create(self, path: str, client_name: str, replication=None,
               block_size=None, overwrite: bool = False):
        return self._cached(
            lambda: self.fsn.create(path, client_name, replication,
                                    block_size, overwrite).to_wire())

    def add_block(self, path: str, client_name: str, previous=None,
                  exclude: Optional[List[str]] = None):
        ctx = current_call()
        writer_host = ctx.address.rsplit(":", 1)[0] if ctx else None
        return self.fsn.add_block(path, client_name, previous,
                                  exclude or [], writer_host).to_wire()

    def abandon_block(self, path: str, client_name: str, block: Dict):
        self.fsn.abandon_block(path, client_name, block)
        return True

    def complete(self, path: str, client_name: str, last=None) -> bool:
        return self.fsn.complete(path, client_name, last)

    def update_pipeline(self, client_name: str, path: str, old_block: Dict,
                        new_gs: int, new_len: int):
        self.fsn.update_pipeline(client_name, path, old_block, new_gs, new_len)
        return True

    @idempotent
    def get_block_locations(self, path: str, offset: int = 0,
                            length: int = 1 << 62):
        info = self.fsn.get_block_locations(path, offset, length)
        if self._state() == ha.OBSERVER and not info.get("uc"):
            # An observer that has tailed the namespace but not yet
            # received the DNs' block reports would answer with zero
            # locations for a COMPLETE file — send the client to the
            # active instead (ref: ObserverRetryOnActiveException in
            # the reference's getBlockLocations path). Under-
            # construction files ("uc" is the top-level flag) are
            # exempt: their in-flight block legitimately has none.
            for b in info.get("blocks", []):
                if not b.get("locs"):
                    raise RetriableError(
                        f"observer has no locations for a block of "
                        f"{path} yet; retry on active")
        return info

    @idempotent
    def get_file_info(self, path: str):
        return self.fsn.get_file_info(path)

    @idempotent
    def listing(self, path: str):
        return self.fsn.listing(path)

    @idempotent
    def content_summary(self, path: str):
        return self.fsn.content_summary(path)

    def mkdirs(self, path: str) -> bool:
        return self._cached(lambda: self.fsn.mkdirs(path))

    def delete(self, path: str, recursive: bool = False) -> bool:
        return self._cached(lambda: self.fsn.delete(path, recursive))

    def rename(self, src: str, dst: str) -> bool:
        return self._cached(lambda: self.fsn.rename(src, dst))

    def set_replication(self, path: str, replication: int) -> bool:
        return self.fsn.set_replication(path, replication)

    def set_times(self, path: str, mtime: float, atime: float):
        self.fsn.set_times(path, mtime, atime)
        return True

    def set_permission(self, path: str, permission: int):
        self.fsn.set_permission(path, permission)
        return True

    def set_owner(self, path: str, owner: str, group: str):
        self.fsn.set_owner(path, owner, group)
        return True

    # namespace features --------------------------------------------------

    def set_quota(self, path: str, ns_quota: int, space_quota: int) -> bool:
        self.fsn.set_quota(path, ns_quota, space_quota)
        return True

    def set_xattr(self, path: str, name: str, value: bytes) -> bool:
        self.fsn.set_xattr(path, name, value)
        return True

    @idempotent
    def get_xattrs(self, path: str, names: Optional[List[str]] = None):
        return self.fsn.get_xattrs(path, names)

    def remove_xattr(self, path: str, name: str) -> bool:
        self.fsn.remove_xattr(path, name)
        return True

    def add_cache_directive(self, path: str) -> int:
        """Ref: ClientProtocol.addCacheDirective."""
        return self.fsn.add_cache_directive(path)

    def remove_cache_directive(self, directive_id: int) -> bool:
        return self.fsn.remove_cache_directive(directive_id)

    @idempotent
    def list_cache_directives(self) -> Dict[str, str]:
        # wirepack map keys are strings
        return {str(k): v
                for k, v in self.fsn.list_cache_directives().items()}

    def create_encryption_zone(self, path: str, key_name: str) -> bool:
        """Ref: ClientProtocol.createEncryptionZone."""
        return self.fsn.create_encryption_zone(path, key_name)

    @idempotent
    def list_encryption_zones(self) -> Dict[str, str]:
        return self.fsn.list_encryption_zones()

    @idempotent
    def get_encryption_info(self, path: str) -> Optional[Dict]:
        """Ref: the FileEncryptionInfo returned with getFileInfo/open."""
        return self.fsn.get_encryption_info(path)

    def set_acl(self, path: str, entries: List[str]) -> bool:
        self.fsn.set_acl(path, entries)
        return True

    @idempotent
    def get_acl(self, path: str):
        return self.fsn.get_acl(path)

    def remove_acl(self, path: str) -> bool:
        self.fsn.remove_acl(path)
        return True

    def set_storage_policy(self, path: str, policy: str) -> bool:
        self.fsn.set_storage_policy(path, policy)
        return True

    def satisfy_storage_policy(self, path: str) -> bool:
        """Queue path for the in-NN StoragePolicySatisfier.
        Ref: ClientProtocol.satisfyStoragePolicy."""
        return self.fsn.sps.satisfy(path)

    @idempotent
    def get_storage_policy(self, path: str) -> str:
        return self.fsn.get_storage_policy(path)

    def allow_snapshot(self, path: str) -> bool:
        self.fsn.allow_snapshot(path)
        return True

    def disallow_snapshot(self, path: str) -> bool:
        self.fsn.disallow_snapshot(path)
        return True

    def create_snapshot(self, path: str, name: str) -> str:
        return self._cached(lambda: self.fsn.create_snapshot(path, name))

    def delete_snapshot(self, path: str, name: str) -> bool:
        self.fsn.delete_snapshot(path, name)
        return True

    def rename_snapshot(self, path: str, old: str, new: str) -> bool:
        self.fsn.rename_snapshot(path, old, new)
        return True

    @idempotent
    def snapshot_diff(self, path: str, from_snap: str, to_snap: str):
        return self.fsn.snapshot_diff(path, from_snap, to_snap)

    def concat(self, target: str, srcs: List[str]) -> bool:
        self._cached(lambda: self.fsn.concat(target, srcs))
        return True

    def truncate(self, path: str, new_length: int) -> bool:
        return self._cached(lambda: self.fsn.truncate(path, new_length))

    def set_ec_policy(self, path: str, policy: Optional[str]) -> bool:
        """Ref: ClientProtocol.setErasureCodingPolicy."""
        return self.fsn.set_ec_policy(path, policy)

    @idempotent
    def get_ec_policy(self, path: str):
        return self.fsn.get_ec_policy(path)

    @idempotent
    def get_ec_policies(self):
        from hadoop_tpu_torch.io.erasurecode import SYSTEM_POLICIES
        return [{"name": p.name, "codec": p.codec, "k": p.k, "m": p.m,
                 "cell": p.cell_size} for p in SYSTEM_POLICIES.values()]

    @idempotent
    def renew_lease(self, client_name: str):
        self.fsn.renew_lease(client_name)
        return True

    def recover_lease(self, path: str, new_holder: str) -> bool:
        return self.fsn.recover_lease(path, new_holder)

    # admin ----------------------------------------------------------------

    @idempotent
    def get_datanode_report(self, state: str = "all"):
        nodes = self.fsn.bm.dn_manager.all_nodes()
        if state == "live":
            nodes = [n for n in nodes if n.state == DatanodeInfo.STATE_LIVE]
        elif state == "dead":
            nodes = [n for n in nodes if n.state == DatanodeInfo.STATE_DEAD]
        return [n.public_info().to_wire() for n in nodes]

    def add_provided_file(self, path: str, external_uri: str,
                          length: int, block_size=None):
        """Mount an external file as PROVIDED storage (fs2img's RPC;
        ref: the aliasmap-backed provided volumes of HDFS-9806)."""
        return self._cached(lambda: self.fsn.add_provided_file(
            path, external_uri, length, block_size))

    @idempotent
    def get_block_alias(self, block_id: int):
        return self.fsn.get_block_alias(block_id)

    @idempotent
    def get_data_encryption_key(self):
        """Current key for a dialing client (ref:
        ClientProtocol.getDataEncryptionKey). None when
        dfs.encrypt.data.transfer is off."""
        dek = self.fsn.data_encryption_keys
        if dek is None:
            return None
        _check_dek_channel(self.fsn)
        return dek.current()

    @idempotent
    def get_stats(self):
        fsn = self.fsn
        return {
            "files": fsn.fsdir.num_inodes(),
            "blocks": fsn.bm.num_blocks(),
            "under_replicated": fsn.bm.under_replicated_count(),
            "live_datanodes": len(fsn.bm.dn_manager.live_nodes()),
            "safemode": fsn.bm.safemode.is_on(),
            "leases": fsn.leases.num_leases(),
            "txid": fsn.editlog.last_txid,
        }

    def set_safemode(self, action: str) -> bool:
        """action: enter | leave | get. Ref: DFSAdmin -safemode."""
        sm = self.fsn.bm.safemode
        if action == "enter":
            sm.enter_manual()
        elif action == "leave":
            sm.leave(force=True)
        return sm.is_on()

    def save_namespace(self) -> str:
        return self.fsn.save_namespace()

    def decommission_datanode(self, uuid: str) -> bool:
        self.fsn.bm.dn_manager.start_decommission(uuid)
        return True

    def start_maintenance(self, uuid: str) -> bool:
        self.fsn.bm.dn_manager.start_maintenance(uuid)
        return True

    def stop_maintenance(self, uuid: str) -> bool:
        self.fsn.bm.dn_manager.stop_maintenance(uuid)
        return True

    @idempotent
    def get_blocks(self, uuid: str, max_blocks: int = 256,
                   min_size: int = 0):
        """Balancer inventory (ref: NamenodeProtocol.getBlocks)."""
        return [b.to_wire() for b in
                self.fsn.bm.blocks_on_node(uuid, max_blocks, min_size)]

    @idempotent
    def get_block_datanodes(self, block: Dict):
        """Current replica holders of one block (balancer/mover probe)."""
        lb = self.fsn.bm.located_block(Block.from_wire(block), 0)
        return [d.to_wire() for d in lb.locations]

    @idempotent
    def get_block_keys(self) -> List[Dict]:
        """Block-token master keys for the balancer/mover (ref:
        NamenodeProtocol.getBlockKeys — the balancer mints its own
        access tokens from the same master keys the DNs verify with).
        Doubly gated: the channel must carry secrets (like DEKs) AND
        the caller must be a cluster administrator — any client holding
        master keys could mint tokens for any block."""
        bt = self.fsn.block_tokens
        if bt is None:
            return []
        _check_dek_channel(self.fsn)
        _check_admin_caller(self.fsn)
        return bt.export_keys()

    def invalidate_replica(self, block: Dict, uuid: str) -> bool:
        return self.fsn.bm.invalidate_replica(Block.from_wire(block), uuid)

    def report_bad_blocks(self, blocks: List[Dict], uuids: List[str]):
        """Client-detected corrupt replicas. Ref: ClientProtocol
        .reportBadBlocks."""
        for b, uuid in zip(blocks, uuids):
            self.fsn.bm.mark_corrupt(Block.from_wire(b), uuid)
        return True

    @idempotent
    def msync(self):
        """State alignment point (ref: ClientProtocol.msync:1844): served
        only by the active (routed there via WRITE_METHODS), the response's
        state id tells the client the latest committed txid so subsequent
        observer reads wait for it."""
        return None

    @idempotent
    def get_service_status(self):
        return {"state": self._state(),
                "safemode": self.fsn.bm.safemode.is_on()}


class DatanodeProtocol:
    """NN side of the DN↔NN protocol. Ref: server/protocol/DatanodeProtocol
    .java; the DN's BPServiceActor (BPServiceActor.java:516,:643) drives it."""

    def __init__(self, fsn: FSNamesystem, state_getter=lambda: ha.ACTIVE):
        self.fsn = fsn
        self._state = state_getter

    def register_datanode(self, info: Dict) -> Dict:
        node = self.fsn.bm.dn_manager.register(DatanodeInfo.from_wire(info))
        return {"uuid": node.uuid}

    @idempotent
    def get_block_alias(self, block_id: int):
        """Provided-block resolution for serving DNs (ref: the
        InMemoryLevelDBAliasMapClient DNs use)."""
        return self.fsn.get_block_alias(block_id)

    @idempotent
    def get_data_encryption_keys(self) -> List[Dict]:
        """Full key set for an accepting DN (ref: the NN handing
        BlockTokenSecretManager keys to DNs via DatanodeProtocol)."""
        dek = self.fsn.data_encryption_keys
        if dek is None:
            return []
        _check_dek_channel(self.fsn)
        return dek.all_wire()

    @idempotent
    def get_block_keys(self) -> List[Dict]:
        """Block-token master keys for a verifying DN (ref:
        DatanodeProtocol handing ExportedBlockKeys at registration and
        on rotation). Same channel gate as DEKs: these keys ARE the
        data-plane authorization secret."""
        bt = self.fsn.block_tokens
        if bt is None:
            return []
        _check_dek_channel(self.fsn)
        return bt.export_keys()

    @idempotent
    def send_heartbeat(self, uuid: str, capacity: int, dfs_used: int,
                       remaining: int, xceivers: int = 0):
        # Standby/observer track liveness but never command DNs — queued
        # work stays put for whoever becomes active (ref: the standby's
        # BPServiceActor ignoring command responses).
        cmds = self.fsn.bm.dn_manager.handle_heartbeat(
            uuid, capacity, dfs_used, remaining, xceivers,
            issue_commands=self._state() == ha.ACTIVE)
        return [c.to_wire() for c in cmds]

    @idempotent
    def report_cached(self, uuid: str, block_ids: List[int]) -> bool:
        """Ref: DatanodeProtocol.cacheReport."""
        self.fsn.bm.report_cached(uuid, block_ids)
        return True

    @idempotent
    def block_report(self, uuid: str, blocks: List[Dict]):
        self.fsn.bm.process_report(uuid, [Block.from_wire(b) for b in blocks])
        return True

    @idempotent
    def block_received_and_deleted(self, uuid: str, received: List[Dict],
                                   deleted: List[Dict]):
        for b in received:
            self.fsn.bm.add_stored_block(Block.from_wire(b), uuid)
        for b in deleted:
            self.fsn.bm.remove_stored_block(Block.from_wire(b), uuid)
        return True

    def report_bad_blocks(self, blocks: List[Dict], uuids: List[str]):
        for b, uuid in zip(blocks, uuids):
            self.fsn.bm.mark_corrupt(Block.from_wire(b), uuid)
        return True

    @idempotent
    def report_slow_peers(self, uuids: List[str],
                          ttl_s: float = 60.0) -> bool:
        """The fleet doctor's slow-node report (ref: the slowPeers leg
        of DatanodeProtocol.sendHeartbeat feeding SlowPeerTracker —
        here the doctor aggregates and pushes the verdict): pipeline
        placement deprioritizes these uuids until the TTL lapses."""
        self.fsn.bm.dn_manager.set_slow_nodes(
            [str(u) for u in uuids], float(ttl_s))
        return True

    def next_generation_stamp(self) -> int:
        return self.fsn.next_gen_stamp()


class HAServiceProtocol:
    """Manual HA admin RPC (ref: HAServiceProtocol.proto +
    NameNode.stateChangeRequest paths; driven by `dfsadmin -transition*`)."""

    def __init__(self, namenode: "NameNode"):
        self.nn = namenode

    def transition_to_active(self) -> bool:
        self.nn.transition_to_active()
        return True

    def transition_to_standby(self) -> bool:
        self.nn.transition_to_standby()
        return True

    def transition_to_observer(self) -> bool:
        self.nn.transition_to_observer()
        return True

    @idempotent
    def get_ha_status(self) -> Dict:
        return {"state": self.nn.ha_state, "nn_id": self.nn.nn_id,
                "last_txid": self.nn.applied_txid()}

    @idempotent
    def monitor_health(self) -> bool:
        return self.nn.is_healthy()


class NameNode(AbstractService):
    """The daemon. Ref: server/namenode/NameNode.java. Non-HA: single
    active with a local journal. HA: a QuorumJournalManager over the
    configured JournalNodes; the node boots standby and is promoted by the
    failover controller (auto) or HAServiceProtocol (manual)."""

    def __init__(self, conf: Configuration, name_dir: Optional[str] = None,
                 nn_id: Optional[str] = None):
        super().__init__("NameNode")
        self._conf_in = conf
        self.name_dir = name_dir or conf.get("dfs.namenode.name.dir",
                                             "/tmp/htpu-name")
        self.nn_id = nn_id or conf.get("dfs.ha.namenode.id", "nn1")
        self.fsn: Optional[FSNamesystem] = None
        self.rpc: Optional[Server] = None
        self.ha_enabled = False
        self.ha_state = ha.ACTIVE
        self.tailer: Optional[ha.EditLogTailer] = None
        self.checkpointer: Optional[ha.StandbyCheckpointer] = None
        self.failover: Optional[ha.FailoverController] = None
        self.fenced_by: Optional[str] = None
        self.http = None
        self._webhdfs = None
        self._ha_lock = threading.RLock()
        self._stop_event = threading.Event()

    @property
    def port(self) -> int:
        return self.rpc.port

    def applied_txid(self) -> int:
        if self.ha_state in (ha.ACTIVE, ha.FENCED) or self.tailer is None:
            return self.fsn.editlog.last_txid
        return self.tailer.last_applied_txid

    def is_healthy(self) -> bool:
        return self.fsn is not None and self.rpc is not None and \
            self.fenced_by is None

    def _fenced(self, e: BaseException) -> None:
        """A newer writer fenced this active's journal (ROADMAP C 24):
        from now on the node is ``fenced``. It answers clients as a
        standby, reports itself unhealthy and refuses every transition,
        since its namespace holds an edit the quorum refused. Hadoop's
        NameNode exits here; this one waits to be stopped and
        restarted. Called from the edit sync of a handler thread: it
        takes no lock, so it cannot wait on a transition that waits on
        that sync."""
        if self.fenced_by is None:
            log.error("NameNode %s fenced, stepping down: %s", self.nn_id, e)
            self.fenced_by = str(e)
        self.ha_state = ha.FENCED

    def _refuse_if_fenced(self) -> None:
        if self.fenced_by is not None:
            from hadoop_tpu_torch.dfs.qjournal import FencedError
            raise FencedError(
                f"NameNode {self.nn_id} was fenced by a newer writer "
                f"({self.fenced_by}); restart it to rejoin")

    def service_init(self, conf: Configuration) -> None:
        os.makedirs(self.name_dir, exist_ok=True)
        shared = conf.get("dfs.namenode.shared.edits.dir", "")
        self.ha_enabled = bool(shared)
        journal = None
        if self.ha_enabled:
            from hadoop_tpu_torch.dfs.qjournal import QuorumJournalManager
            from hadoop_tpu_torch.util.misc import parse_addr_list
            self._jn_addrs = parse_addr_list(shared)
            journal = QuorumJournalManager(self._jn_addrs, conf=conf,
                                           on_fenced=self._fenced)
        self.fsn = FSNamesystem(conf, self.name_dir, journal_manager=journal)
        if self.ha_enabled:
            self.ha_state = ha.STANDBY
            # Standby: DN reports can outrun edit tailing — postpone
            # unknown-block reports instead of invalidating (ref:
            # shouldPostponeBlocksFromFuture set in startStandbyServices).
            self.fsn.bm.postpone_unknown = True
            last = self.fsn.load_from_disk(open_edits=False)
            self.tailer = ha.EditLogTailer(
                self.fsn, interval_s=conf.get_time_seconds(
                    "dfs.ha.tail-edits.period", 0.5))
            self.tailer.last_applied_txid = last
            self.checkpointer = ha.StandbyCheckpointer(
                self.fsn, self.tailer,
                period_s=conf.get_time_seconds(
                    "dfs.namenode.checkpoint.period", 3600.0),
                txns=conf.get_int("dfs.namenode.checkpoint.txns", 1_000_000))
        else:
            self.fsn.load_from_disk()
        bind_host = conf.get("dfs.namenode.rpc-bind-host", "127.0.0.1")
        port = conf.get_int("dfs.namenode.rpc-port", 0)
        self.retry_cache = RetryCache()
        # default the NN's RPC scheduler to decay accounting: priority
        # behavior is unchanged on the default FIFO queue (priorities
        # are computed, the queue ignores them) but per-caller decayed
        # counts exist — which is what /ws/v1/top reads instead of
        # growing an nntop-private second counter
        if not conf.get("dfs.namenode.scheduler.impl", ""):
            conf.set("dfs.namenode.scheduler.impl", "decay")
        self.rpc = Server(
            conf, bind=(bind_host, port),
            num_handlers=conf.get_int("dfs.namenode.handler.count", 8),
            name="namenode",
            state_provider=self.applied_txid,
            queue_prefix="dfs.namenode")
        state = lambda: self.ha_state  # noqa: E731
        from hadoop_tpu_torch.dfs.namenode.audit import maybe_audited
        client_proto = maybe_audited(ClientProtocol(
            self.fsn, self.retry_cache, state), conf)
        self.rpc.register_protocol("ClientProtocol", client_proto,
                                   pre_call=self._client_pre_call)
        # nntop: expose the scheduler's decayed per-caller window at
        # every chassis' /ws/v1/top (obs/top.py)
        from hadoop_tpu_torch.obs.top import register_top_source
        self._top_source = f"namenode.{self.nn_id}.rpc.callers"
        sched = self.rpc._callq.scheduler
        if hasattr(sched, "snapshot"):
            register_top_source(self._top_source, sched.snapshot)
        self.rpc.register_protocol("DatanodeProtocol",
                                   DatanodeProtocol(self.fsn, state))
        self.rpc.register_protocol("HAServiceProtocol",
                                   HAServiceProtocol(self))
        # Admin HTTP + WebHDFS (ref: NameNodeHttpServer.java).
        self.http = None
        self._webhdfs = None
        if conf.get_bool("dfs.namenode.http.enabled", True):
            from hadoop_tpu_torch.dfs.webhdfs import PREFIX, WebHdfsHandler
            from hadoop_tpu_torch.http.server import HttpServer
            self.http = HttpServer(
                conf, bind=("127.0.0.1",
                            conf.get_int("dfs.namenode.http-port", 0)),
                daemon_name=f"namenode-{self.nn_id}")
            self._webhdfs = WebHdfsHandler(self)
            self.http.add_handler(PREFIX, self._webhdfs)
            status_proto = ClientProtocol(self.fsn, self.retry_cache,
                                          lambda: self.ha_state)
            self.http.add_handler(
                "/fsstatus", lambda q, b: (200, status_proto.get_stats()))
            from hadoop_tpu_torch.http.webui import nn_dfshealth_page
            self.http.add_handler("/dfshealth", nn_dfshealth_page(self))
            # the fleet doctor's DN discovery roster: uuid/host/
            # info_port/state plus the currently-deprioritized set
            self.http.add_handler("/ws/v1/datanodes", self._ws_datanodes)

    def _ws_datanodes(self, query, body):
        """DN roster for the fleet doctor: every registered node with
        the admin-HTTP ``info_port`` it advertised at registration."""
        dm = self.fsn.bm.dn_manager
        slow = dm.slow_node_uuids()
        return 200, {"datanodes": [
            {"uuid": n.uuid, "host": n.host, "xfer_port": n.xfer_port,
             "info_port": n.info_port, "state": n.state,
             "slow": n.uuid in slow}
            for n in dm.all_nodes()]}

    def _client_pre_call(self, method: str, ctx: CallContext) -> None:
        """HA gate + observer alignment (ref: NameNodeRpcServer's
        checkOperation + GlobalStateIdContext.receiveRequestState)."""
        ha.check_operation(self.ha_state, method in WRITE_METHODS)
        if self.ha_state == ha.OBSERVER and ctx.client_state_id >= 0:
            deadline = time.monotonic() + 3.0
            while self.applied_txid() < ctx.client_state_id:
                if time.monotonic() > deadline:
                    raise RetriableError(
                        f"observer lagging: applied {self.applied_txid()} "
                        f"< requested {ctx.client_state_id}")
                time.sleep(0.01)

    def service_start(self) -> None:
        self.rpc.start()
        if self.http is not None:
            self.http.start()
        Daemon(self._redundancy_monitor, "nn-redundancy-monitor").start()
        if self.ha_enabled:
            self.tailer.start(self.tailer.last_applied_txid)
            self.checkpointer.start()
            auto = self.config.get_bool(
                "dfs.ha.automatic-failover.enabled", True)
            want_observer = self.config.get(
                "dfs.ha.initial-state", "") == ha.OBSERVER
            if want_observer:
                self.ha_state = ha.OBSERVER
            elif auto:
                from hadoop_tpu_torch.dfs.qjournal import QuorumLease
                lease = QuorumLease(
                    self._jn_addrs, holder=self.nn_id,
                    ttl_s=self.config.get_time_seconds(
                        "dfs.ha.lease-duration", 4.0),
                    conf=self.config)
                self.failover = ha.FailoverController(
                    self, lease, check_interval_s=self.config.get_time_seconds(
                        "dfs.ha.health-check.interval", 0.5))
                self.failover.start()
        else:
            Daemon(self._checkpoint_monitor, "nn-checkpointer").start()
        log.info("NameNode %s up at 127.0.0.1:%d (state %s, name dir %s)",
                 self.nn_id, self.rpc.port, self.ha_state, self.name_dir)

    def service_stop(self) -> None:
        self._stop_event.set()
        if getattr(self, "_top_source", None):
            from hadoop_tpu_torch.obs.top import unregister_top_source
            unregister_top_source(self._top_source)
        if self.failover is not None:
            self.failover.stop()
        if self.ha_enabled and self.ha_state == ha.ACTIVE:
            # answer as a standby from here on (ROADMAP C 24): a client
            # then fails over instead of losing a call in flight when the
            # RPC server closes below
            self.ha_state = ha.STANDBY
        if self.failover is not None:
            self.failover.lease.release()
            self.failover.lease.close()
        if self.tailer is not None:
            self.tailer.stop()
        if self.checkpointer is not None:
            self.checkpointer.stop()
        if self.http is not None:
            self.http.stop()
        if self._webhdfs is not None:
            self._webhdfs.close()
        if self.rpc:
            self.rpc.stop()
        if self.fsn:
            self.fsn.close()

    # ---------------------------------------------------------- transitions

    def transition_to_active(self) -> None:
        """Ref: NameNode.transitionToActive → startActiveServices: final
        tail, fence + recover the quorum journal, open for write."""
        with self._ha_lock:
            self._refuse_if_fenced()
            if self.ha_state == ha.ACTIVE:
                return
            if not self.ha_enabled:
                raise ValueError("HA is not enabled")
            self.tailer.stop()
            self.checkpointer.stop()
            qjm = self.fsn.editlog.journal
            last_committed = qjm.recover()      # epoch fencing happens here
            # Apply anything committed but not yet tailed. Loop: one
            # read_edits pass is capped server-side (~50k records per JN),
            # and a long-lagging standby must fully catch up here, not
            # trip the abort guard below.
            while self.tailer.last_applied_txid < last_committed:
                before = self.tailer.last_applied_txid
                edits = list(qjm.read_edits(before + 1))
                if edits:
                    with self.fsn.lock.write():
                        for rec in edits:
                            self.fsn._apply_edit(rec)
                            self.tailer.last_applied_txid = rec["t"]
                if self.tailer.last_applied_txid == before:
                    break  # no forward progress — the guard below decides
            if self.tailer.last_applied_txid < last_committed:
                # Recovery adopted a tail the quorum cannot serve us — a
                # JN died between accept and this read, or the accept
                # itself was torn. Opening the log here would issue txids
                # past edits this namespace never applied, silently
                # dropping them (and wedging every standby at the gap).
                # Abort; the failover controller retries the transition.
                # Ref: the reference's recoverUnfinalizedSegments +
                # catchupDuringFailover both completing before
                # startActiveServices opens the log.
                self.tailer.start(self.tailer.last_applied_txid)
                self.checkpointer.start()
                raise IOError(
                    f"transition to active aborted: caught up only to txid "
                    f"{self.tailer.last_applied_txid} of recovered tail "
                    f"{last_committed}")
            last = max(last_committed, self.tailer.last_applied_txid)
            self.fsn.editlog.open_for_write(last)
            self.ha_state = ha.ACTIVE
            # Namespace is caught up: replay every postponed DN report
            # (ref: processAllPendingDNMessages in startActiveServices).
            self.fsn.bm.process_all_postponed()
            log.info("NameNode %s is now ACTIVE at txid %d", self.nn_id, last)

    def transition_to_standby(self) -> None:
        """Ref: NameNode.transitionToStandby → startStandbyServices."""
        with self._ha_lock:
            self._refuse_if_fenced()
            if self.ha_state == ha.STANDBY:
                return
            if not self.ha_enabled:
                raise ValueError("HA is not enabled")
            was_active = self.ha_state == ha.ACTIVE
            self.ha_state = ha.STANDBY
            self.fsn.bm.postpone_unknown = True
            # Always stop first: observer→standby must not leave the old
            # tailer/checkpointer threads running beside fresh ones.
            self.tailer.stop()
            self.checkpointer.stop()
            if was_active:
                try:
                    # Finalize our segment but keep the journal manager
                    # alive — the standby tails through it and a later
                    # re-promotion reuses it.
                    self.fsn.editlog.close_segment()
                except Exception:
                    log.exception("closing edit segment on demotion")
                if self.fenced_by is not None:
                    return  # the closing sync was fenced: never tail
                start_from = self.fsn.editlog.last_txid
            else:
                start_from = self.tailer.last_applied_txid
            self.tailer.start(start_from)
            self.checkpointer.start()
            log.info("NameNode %s is now STANDBY", self.nn_id)

    def transition_to_observer(self) -> None:
        with self._ha_lock:
            self._refuse_if_fenced()
            if self.ha_state == ha.ACTIVE:
                self.transition_to_standby()
            self.ha_state = ha.OBSERVER
            log.info("NameNode %s is now OBSERVER", self.nn_id)

    # ------------------------------------------------------------- monitors

    def _redundancy_monitor(self) -> None:
        """Ref: BlockManager.RedundancyMonitor + HeartbeatManager.Monitor +
        LeaseManager.Monitor rolled into one sweep loop. Active-only work;
        liveness sweeps run in every state."""
        interval = self.config.get_time_seconds(
            "dfs.namenode.redundancy.interval", 3.0)
        while not self._stop_event.wait(interval):
            try:
                self.redundancy_pass()
            except Exception:
                log.exception("Redundancy monitor pass failed")

    def redundancy_pass(self) -> None:
        """One monitor sweep, callable synchronously — tests pump this
        directly so reconstruction scheduling is deterministic under
        load instead of racing the background thread's timing (ref: the
        reference triggers BlockManager computation explicitly via
        BlockManagerTestUtil in the same situations)."""
        for node in self.fsn.bm.dn_manager.check_dead_nodes():
            self.fsn.bm.node_died(node)
        if self.ha_state == ha.ACTIVE and \
                not self.fsn.bm.safemode.is_on():
            self.fsn.bm.compute_reconstruction_work()
            self.fsn.bm.dn_manager.check_admin_progress()
            self.fsn.check_leases()
            self.fsn.cache_monitor_pass()
            self.fsn.sps.pass_once()

    def _checkpoint_monitor(self) -> None:
        """Periodic checkpoint by txn count / period (non-HA only; in HA
        the standby checkpoints — ref: StandbyCheckpointer.java:64)."""
        period = self.config.get_time_seconds(
            "dfs.namenode.checkpoint.period", 3600.0)
        txns = self.config.get_int("dfs.namenode.checkpoint.txns", 1_000_000)
        last_ckpt_txid = self.fsn.editlog.last_txid
        while not self._stop_event.wait(min(period, 10.0)):
            try:
                if self.fsn.editlog.last_txid - last_ckpt_txid >= txns:
                    self.fsn.save_namespace()
                    last_ckpt_txid = self.fsn.editlog.last_txid
            except Exception:
                log.exception("Checkpoint failed")
