"""FSNamesystem — the metadata master's brain.

The port's copy of ``hadoop_tpu/dfs/namenode/fsnamesystem.py``, on the
same wire and disk formats.

Parity with the reference (ref: server/namenode/FSNamesystem.java (8,756 LoC;
:766 loadFromDisk, :2598 startFile), NameNodeRpcServer.java:781): composes the
inode tree (inodes.py), edit log (editlog.py), image (fsimage.py), leases
(lease.py), and block manager (blockmanager.py) behind one instrumented RW
lock, with the reference's locking discipline: mutate + log_edit under the
write lock, ``log_sync`` after releasing it (group commit), reads under the
read lock.

Startup = newest image + replay of later edits (ref: FSNamesystem
.loadFromDisk). Every mutation is durable before its RPC returns.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.namenode import editlog as el
from hadoop_tpu_torch.dfs.namenode.blockmanager import BlockManager
from hadoop_tpu_torch.dfs.namenode.editlog import FSEditLog, FileJournalManager
from hadoop_tpu_torch.dfs.namenode.fsimage import FSImage
from hadoop_tpu_torch.dfs.namenode.inodes import (FSDirectory, INodeDirectory,
                                            INodeFile, collect_blocks,
                                            iter_tree, snapshot_copy,
                                            subtree_counts)
from hadoop_tpu_torch.dfs.namenode.lease import LeaseManager
from hadoop_tpu_torch.dfs.namenode.permissions import (EXECUTE as PERM_X,
                                                 READ as PERM_R,
                                                 WRITE as PERM_W)
from hadoop_tpu_torch.dfs.namenode.namesystem_lock import NamesystemLock
from hadoop_tpu_torch.dfs.protocol.records import (
    AlreadyBeingCreatedError, Block, FileStatus, LeaseExpiredError,
    LocatedBlock, NotReplicatedYetError, SafeModeError)
from hadoop_tpu_torch.io import erasurecode as ec
from hadoop_tpu_torch.dfs.protocol.records import QuotaExceededError
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.security.ugi import current_user

log = logging.getLogger(__name__)

# The audit trail (ref: FSNamesystem.java:392 logAuditEvent + the
# "FSNamesystem.audit" logger convention): one line per namespace op with
# the caller's identity and address from the RPC CallContext. Operators
# attach handlers/sinks to THIS logger name — it rotates/routes with
# whatever logging config the deployment already runs, and the
# dynamometer replays it (tools/dynamometer.parse_audit_line tolerates
# the extra fields). ``status`` distinguishes ok from failed(Type) —
# failure lines come from the RPC-facade auditor
# (dfs/namenode/audit.py), success lines from these call sites — and
# ``trace_id`` joins each line to the telemetry plane: grep the audit
# log, assemble the trace at the fleet doctor.
audit_log = logging.getLogger("hadoop_tpu_torch.audit")

AUDIT_ENABLE_KEY = "namenode.audit.enable"

# conf-keyed master switch (namenode.audit.enable, default on —
# the seed always logged); FSNamesystem.__init__ resolves it
_audit_enabled = True


def set_audit_enabled(enabled: bool) -> None:
    global _audit_enabled
    _audit_enabled = bool(enabled)


def log_audit_event(allowed: bool, cmd: str, src: str,
                    dst: Optional[str] = None,
                    status: str = "ok") -> None:
    """Ref: FSNamesystem.logAuditEvent — ugi/ip/cmd/src/dst(+CallerContext
    = the RPC client id, its role here)."""
    if not _audit_enabled or not audit_log.isEnabledFor(logging.INFO):
        return
    from hadoop_tpu_torch.ipc.server import current_call
    from hadoop_tpu_torch.tracing import current_span
    call = current_call()
    ugi = call.user.user_name if call else current_user().user_name
    ip = call.address if call else "local"
    ctx = call.client_id.hex()[:16] if call and call.client_id else "-"
    sp = current_span()
    trace = f"{sp.trace_id:016x}" if sp is not None and sp.sampled \
        else "-"
    audit_log.info(
        "allowed=%s\tugi=%s\tip=%s\tcmd=%s\tsrc=%s\tdst=%s"
        "\tcallerContext=%s\tstatus=%s\ttrace_id=%s",
        str(allowed).lower(), ugi, ip, cmd, src, dst or "null", ctx,
        status, trace)


# Ref: BlockStoragePolicySuite — policy ids the mover acts on. On a
# homogeneous TPU-host fleet these are placement intents, not media types.
STORAGE_POLICIES = ("HOT", "WARM", "COLD", "ALL_SSD", "ONE_SSD",
                    "LAZY_PERSIST", "PROVIDED")


class FSNamesystem:
    def __init__(self, conf: Configuration, name_dir: str,
                 journal_manager=None):
        self.conf = conf
        self.name_dir = name_dir
        self.default_block_size = conf.get_size_bytes("dfs.blocksize",
                                                      128 * 1024 * 1024)
        self.default_replication = conf.get_int("dfs.replication", 3)
        self.lock = NamesystemLock(
            write_warn_threshold_s=conf.get_time_seconds(
                "dfs.namenode.write-lock-reporting-threshold", 1.0))
        self.fsdir = FSDirectory()
        # Permission enforcement (ref: FSNamesystem.isPermissionEnabled
        # + FSPermissionChecker): stored owner/group/mode bits are
        # CHECKED on every namespace op, not just recorded. The
        # NameNode's own user is the superuser; members of the
        # configured supergroup bypass too.
        self._perm_enabled = conf.get_bool("dfs.permissions.enabled",
                                           True)
        self._superuser = current_user().user_name
        # audit-plane master switch (process-global like the logger
        # itself; the last namesystem to init in a shared-process
        # minicluster wins, which is fine — one conf lineage)
        set_audit_enabled(conf.get_bool(AUDIT_ENABLE_KEY, True))
        self._supergroup = conf.get("dfs.permissions.superusergroup",
                                    "supergroup")
        # Server-side group resolution — NEVER the client-asserted UGI
        # groups, which would let any caller claim the supergroup
        # (ref: security/Groups.java).
        from hadoop_tpu_torch.security.groups import Groups
        self._groups = Groups(conf)
        self.image = FSImage(os.path.join(name_dir, "image"))
        # Journal seam: local directory by default, quorum journal in HA
        # (ref: FSEditLog's JournalSet of FileJournalManager/QJM members).
        self.editlog = FSEditLog(journal_manager or FileJournalManager(
            os.path.join(name_dir, "edits")))
        self.leases = LeaseManager(
            soft_limit_s=conf.get_time_seconds("dfs.lease.soft-limit", 60.0),
            hard_limit_s=conf.get_time_seconds("dfs.lease.hard-limit", 1200.0))
        self.bm = BlockManager(conf)
        # Data-transfer encryption keys (ref: BlockTokenSecretManager's
        # DataEncryptionKey minting under dfs.encrypt.data.transfer):
        # clients fetch the current key, DNs fetch the full set.
        self.data_encryption_keys = None
        if conf.get_bool("dfs.encrypt.data.transfer", False):
            # Fail fast on the incompatible combination: on a secured
            # cluster DEKs are only served over privacy-QoP RPC, so
            # anything below privacy would strand every DN/client at
            # key-fetch time with nothing but a DEBUG log to show for
            # it. Surface the misconfiguration at NN startup instead.
            auth = conf.get("hadoop.security.authentication",
                            "simple").lower()
            qop = conf.get("hadoop.rpc.protection",
                           "authentication").lower()
            if auth == "sasl" and qop != "privacy":
                raise ValueError(
                    "dfs.encrypt.data.transfer=true on a secured cluster "
                    "requires hadoop.rpc.protection=privacy (got "
                    f"{qop!r}): data encryption keys are only served "
                    "over privacy-protected RPC")
            from hadoop_tpu_torch.dfs.protocol.datatransfer import \
                DataEncryptionKeys
            self.data_encryption_keys = DataEncryptionKeys()
        # Block access tokens (ref: dfs.block.access.token.enable +
        # BlockTokenSecretManager.java:66): minted into every
        # LocatedBlock, verified by DNs on every data-plane op that
        # names a block — including fd-passing short-circuit grants.
        self.block_tokens = None
        if conf.get_bool("dfs.block.access.token.enable", False):
            from hadoop_tpu_torch.dfs.protocol.blocktoken import \
                BlockTokenSecretManager
            self.block_tokens = BlockTokenSecretManager()
        # PROVIDED storage alias map (ref: hdfs server/aliasmap/
        # InMemoryAliasMap.java + common/blockaliasmap/ — block id →
        # location in an external store; DNs resolve provided reads
        # through it). Persisted with the image; populated by fs2img.
        self.alias_map: Dict[int, Dict] = {}
        self._next_block_id = 1 << 30   # ref: SequentialBlockIdGenerator  # guarded-by: _id_lock
        self._next_group_id = ec.STRIPED_ID_BASE  # striped block groups
        self._gen_stamp = 1000          # ref: GenerationStamp  # guarded-by: _id_lock
        self._id_lock = threading.Lock()
        # paths mid block-recovery, pinned to their INode identity: the
        # sweep must never act on a path that now names a DIFFERENT file
        # (delete + recreate while recovery was in flight)
        self._pending_recovery: Dict[str, INodeFile] = {}  # guarded-by: lock
        # Centralized cache directives (ref: namenode/CacheManager.java):
        # id → path; the cache monitor reconciles DN state against them.
        self.cache_directives: Dict[int, str] = {}
        self._next_cache_id = 1
        from hadoop_tpu_torch.dfs.namenode.sps import StoragePolicySatisfier
        self.sps = StoragePolicySatisfier(self)
        self._snapshot_count = 0             # namespace-wide, for fast paths
        reg = metrics_system().source("namenode.ops")
        self._m = {name: reg.rate(name) for name in
                   ("create", "add_block", "complete", "get_block_locations",
                    "mkdirs", "delete", "rename", "listing", "get_file_info")}
        self._m_files = reg.register_callback_gauge(
            "files_total", self.fsdir.num_inodes)

    # ----------------------------------------------------------- permissions

    @staticmethod
    def check_path_names(*paths: str) -> None:
        """Reject "." / ".." as COMPONENT names on name-CREATING ops
        (ref: DFSUtil.isValidName, validated at the write boundary):
        the namespace walks literally, so a directory literally named
        ".." would make POSIX-normalizing clients and every
        prefix-based rule (trash containment, encryption zones, mount
        tables) address a different node than the one stored. Replay
        and read/delete paths stay permissive so a legacy tree can
        still be cleaned up."""
        for p in paths:
            for c in p.split("/"):
                if c in (".", ".."):
                    raise ValueError(
                        f"invalid path component {c!r} in {p!r}")


    def check_access(self, path: str, *, parent: int = 0,
                     target: int = 0, owner_only: bool = False,
                     sub_dirs: int = 0) -> None:
        """Enforce the stored mode bits for the CURRENT RPC caller
        (ref: FSNamesystem's per-op FSPermissionChecker use). No-op when
        dfs.permissions.enabled=false or the caller is the superuser.

        Group resolution rides Groups' per-user TTL cache; a cache miss
        does the OS lookup while the namesystem lock is held (callers
        invoke this inside their lock block for check/op atomicity) —
        once per user per 5 minutes, the documented trade for not
        threading a pre-lock resolution step through every op."""
        if not self._perm_enabled:
            return
        from hadoop_tpu_torch.dfs.namenode.permissions import FSPermissionChecker
        from hadoop_tpu_torch.ipc.server import current_call
        call = current_call()
        ugi = call.user if call else current_user()
        FSPermissionChecker(
            ugi.user_name, self._groups.groups_for(ugi.user_name),
            self._superuser,
            self._supergroup).check(self.fsdir, path, parent=parent,
                                    target=target, owner_only=owner_only,
                                    sub_dirs=sub_dirs)

    def check_superuser(self, what: str) -> None:
        """Ref: FSPermissionChecker.checkSuperuserPrivilege — admin-class
        ops (quota, chown, snapshot admin, encryption zones)."""
        if not self._perm_enabled:
            return
        from hadoop_tpu_torch.dfs.namenode.permissions import FSPermissionChecker
        from hadoop_tpu_torch.ipc.server import current_call
        from hadoop_tpu_torch.security.ugi import AccessControlError
        call = current_call()
        ugi = call.user if call else current_user()
        pc = FSPermissionChecker(
            ugi.user_name, self._groups.groups_for(ugi.user_name),
            self._superuser, self._supergroup)
        if not pc.is_superuser:
            raise AccessControlError(
                f"Superuser privilege required for {what} "
                f"(user={ugi.user_name})")

    def _check_set_owner_access(self, path: str, inode, owner: str,
                                group: str) -> None:
        """Ref: FSDirAttrOp.setOwner — changing the OWNER is superuser
        territory, but a file's owner may chgrp it to any group they
        belong to (server-resolved, never client-asserted)."""
        if not self._perm_enabled:
            return
        from hadoop_tpu_torch.dfs.namenode.permissions import FSPermissionChecker
        from hadoop_tpu_torch.ipc.server import current_call
        from hadoop_tpu_torch.security.ugi import AccessControlError
        call = current_call()
        ugi = call.user if call else current_user()
        pc = FSPermissionChecker(
            ugi.user_name, self._groups.groups_for(ugi.user_name),
            self._superuser, self._supergroup)
        if pc.is_superuser:
            return
        if owner and owner != inode.owner:
            raise AccessControlError(
                f"Superuser privilege required to change the owner of "
                f"\"{path}\" (user={ugi.user_name})")
        if ugi.user_name != inode.owner:
            raise AccessControlError(
                f"Permission denied: user={ugi.user_name} is not the "
                f"owner of inode \"{path}\" (owner={inode.owner})")
        if group and group not in pc.groups:
            raise AccessControlError(
                f"Permission denied: user={ugi.user_name} does not "
                f"belong to group {group!r}")

    # ------------------------------------------------------------- lifecycle

    def load_from_disk(self, open_edits: bool = True) -> int:
        """Ref: FSNamesystem.loadFromDisk:766 — image then edits replay.
        ``open_edits=False`` loads read-only (HA standby: the tailer keeps
        applying and a later transition opens the journal for write).
        Returns the last applied txid."""
        last_txid = 0
        loaded = self.image.load()
        if loaded is not None:
            last_txid, self.fsdir, extra = loaded
            with self._id_lock:
                self._next_block_id = extra.get(
                    "next_block_id", self._next_block_id)
                self._next_group_id = extra.get(
                    "next_group_id", self._next_group_id)
                self._gen_stamp = extra.get("gen_stamp", self._gen_stamp)
            self.leases.restore_from_image(extra.get("leases", {}))
            self.alias_map = {int(k): v for k, v in
                              extra.get("alias_map", {}).items()}
            self.cache_directives = {
                int(k): v for k, v in
                extra.get("cache_directives", {}).items()}
            self._next_cache_id = extra.get("next_cache_id", 1)
        # Count image-loaded snapshots BEFORE replay: replayed
        # delete-snapshot ops consult the counter for pin checks.
        self._snapshot_count = sum(
            len(n.snapshots or {}) for n in iter_tree(self.fsdir.root)
            if isinstance(n, INodeDirectory))
        replayed = 0
        for rec in self.editlog.journal.read_edits(last_txid + 1):
            self._apply_edit(rec)
            last_txid = rec["t"]
            replayed += 1
        log.info("Loaded namespace: %d inodes, replayed %d edits, txid=%d",
                 self.fsdir.num_inodes(), replayed, last_txid)
        self._rebuild_block_map()
        if open_edits:
            self.editlog.open_for_write(last_txid)
        self.bm.safemode.set_block_total(self.bm.num_blocks())
        return last_txid

    def _rebuild_block_map(self) -> None:
        """Blocks live in inodes after load; register them with the BM
        (locations arrive via block reports, as in the reference). Also
        recover the id/stamp generators past everything ever allocated —
        reusing a block id after restart would collide with live replicas
        (ref: SequentialBlockIdGenerator skipTo on image load)."""
        for node in iter_tree(self.fsdir.root):
            if isinstance(node, INodeFile):
                for b in node.blocks:
                    if b.block_id in self.alias_map:
                        # PROVIDED blocks have no DN replicas: keeping
                        # them out of the BM keeps them out of safemode
                        # accounting and the redundancy queues (ref:
                        # ProvidedStorageMap bypassing block reports).
                        self._track_block_id(b.to_wire())
                        continue
                    info = self._register_block_locked(node, b)
                    info.under_construction = node.under_construction and \
                        b is node.blocks[-1]
                    self._track_block_id(b.to_wire())
            elif isinstance(node, INodeDirectory) and node.snapshots:
                # Snapshot-pinned blocks whose live file is gone must stay
                # known, or block reports would invalidate their replicas.
                for snap in node.snapshots.values():
                    for f in iter_tree(snap):
                        if isinstance(f, INodeFile):
                            for b in f.blocks:
                                info = self._register_block_locked(f, b)
                                info.under_construction = False
                                self._track_block_id(b.to_wire())

    def _register_block_locked(self, inode: INodeFile, b: Block):
        """Idempotently register an inode's block with the block manager
        (replay/tailing path — locations already reported must survive)."""
        info = self.bm.get(b.block_id)
        if info is not None:
            info.block.num_bytes = max(info.block.num_bytes, b.num_bytes)
            if b.gen_stamp > info.block.gen_stamp:
                info.block.gen_stamp = b.gen_stamp
            return info
        if inode.ec_policy:
            return self.bm.add_striped_block_collection(
                b, inode, ec.get_policy(inode.ec_policy))
        return self.bm.add_block_collection(b, inode, inode.replication)

    def save_namespace(self) -> str:
        """Checkpoint. Ref: FSNamesystem.saveNamespace — requires safemode in
        the reference; here we hold the write lock for the (in-memory)
        serialize, then roll the edit log."""
        with self.lock.write():
            txid = self.editlog.last_txid
            path = self.image.save(self.fsdir, txid, self.image_extra())
        self.editlog.roll()
        self.image.purge_old()
        return path

    def image_extra(self) -> Dict:
        """Counters that must survive restart alongside the image — the
        single source for both the local checkpointer and the standby's
        (drift here would lose id/stamp state across failover)."""
        with self._id_lock:
            ids = {"next_block_id": self._next_block_id,
                   "next_group_id": self._next_group_id,
                   "gen_stamp": self._gen_stamp}
        return {
            **ids,
            "leases": self.leases.snapshot_for_image(),
            "cache_directives": dict(self.cache_directives),
            "next_cache_id": self._next_cache_id,
            "alias_map": {str(k): v for k, v in self.alias_map.items()},
        }

    def close(self) -> None:
        try:
            self.editlog.close()
        except Exception:
            log.exception("Error closing edit log")

    # ----------------------------------------------------------- id helpers

    def _new_block_id(self) -> int:
        with self._id_lock:
            self._next_block_id += 1
            return self._next_block_id

    def _new_group_id(self) -> int:
        with self._id_lock:
            self._next_group_id += ec.MAX_UNITS
            return self._next_group_id

    def _track_block_id(self, bw: Dict) -> None:
        """Advance the id/stamp high-water marks past a (re)played block."""
        bid, gs = bw.get("id", 0), bw.get("gs", 0)
        with self._id_lock:
            if ec.is_striped_id(bid):
                if ec.group_id_of(bid) > self._next_group_id:
                    self._next_group_id = ec.group_id_of(bid)
            elif bid > self._next_block_id:
                self._next_block_id = bid
            if gs > self._gen_stamp:
                self._gen_stamp = gs

    def current_gen_stamp(self) -> int:
        with self._id_lock:
            return self._gen_stamp

    def next_gen_stamp(self) -> int:
        with self._id_lock:
            self._gen_stamp += 1
            gs = self._gen_stamp
        # Persisted so restarts never reuse stamps (ref: OP_SET_GENSTAMP_V2).
        txid = self.editlog.log_edit(el.OP_SET_GENSTAMP, {"gs": gs})
        self.editlog.log_sync(txid)
        return gs

    def _check_not_safemode(self, action: str) -> None:
        if self.bm.safemode.is_on():
            raise SafeModeError(
                f"cannot {action}: name node is in safe mode "
                f"({self.bm.safemode.status()})")

    @staticmethod
    def _check_mutable_path(*paths: str) -> None:
        """Snapshot contents are immutable and the .snapshot pseudo-dir is
        not a real inode — every mutating op must reject such paths (ref:
        FSDirectory.verifySnapshotName / the isSnapshotPath checks)."""
        for p in paths:
            if ".snapshot" in [c for c in p.split("/") if c]:
                raise OSError(
                    f"cannot modify {p}: snapshot paths are read-only")

    # ========================================================== client ops

    def create(self, path: str, client_name: str, replication: Optional[int],
               block_size: Optional[int], overwrite: bool) -> FileStatus:
        """Ref: FSNamesystem.startFile:2598."""
        replication = replication or self.default_replication
        block_size = block_size or self.default_block_size
        owner = current_user().user_name
        # EDEK pre-generation OUTSIDE the namesystem lock (the KMS is an
        # HTTP round trip; ref: the reference's EDEKCacheLoader exists for
        # exactly this reason). Re-checked under the lock.
        pre_zone_key = None
        pre_edek = None
        if self._kms() is not None:
            with self.lock.read():
                pre_zone_key = self._zone_key_locked(path)
            if pre_zone_key is not None:
                pre_edek = self._generate_edek_attr(pre_zone_key)
        self.check_path_names(path)
        with self._m["create"].time():
            with self.lock.write():
                self._check_not_safemode("create")
                self._check_mutable_path(path)
                # under the lock so the check is atomic with the op
                # (ref: the reference checks via FSPermissionChecker
                # inside the namesystem lock): ancestors traversable +
                # parent writable; an existing target (overwrite) must
                # itself be writable
                self.check_access(path, parent=PERM_W, target=PERM_W)
                existing = self.fsdir.get_inode(path)
                if existing is not None:
                    if isinstance(existing, INodeDirectory):
                        raise IsADirectoryError(path)
                    holder = self.leases.holder_of(path)
                    if holder is not None and holder != client_name:
                        if not self.leases.is_soft_expired(path):
                            raise AlreadyBeingCreatedError(
                                f"{path} is being written by {holder}")
                        self._recover_lease_locked(path, existing)
                    if not overwrite:
                        raise FileExistsError(path)
                    # Quota BEFORE the overwrite-delete (a rejection must
                    # leave the old file untouched) — but the replace is
                    # inode-neutral: the old file still counts, the new one
                    # takes its slot (ref: overwrite at quota is legal).
                    self._check_quota_locked(path, d_inodes=0, d_space=0)
                    self._delete_locked(path, recursive=False)
                else:
                    self._check_quota_locked(path, d_inodes=1, d_space=0)
                ec_policy = self._effective_ec_policy_locked(path)
                zone_key = self._zone_key_locked(path) \
                    if self._kms() is not None else None
                edek_attr = pre_edek if zone_key == pre_zone_key else None
                if zone_key is not None and edek_attr is None:
                    # zone appeared/changed between the optimistic read
                    # and now (rare) — pay the KMS call under the lock
                    edek_attr = self._generate_edek_attr(zone_key)
                inode = self.fsdir.add_file(path, replication, block_size,
                                            owner=owner)
                inode.ec_policy = ec_policy
                inode.under_construction = True
                inode.client_name = client_name
                self.leases.add_lease(client_name, path)
                txid = self.editlog.log_edit(el.OP_ADD, {
                    "p": path, "rep": replication, "bs": block_size,
                    "cl": client_name, "o": owner, "ov": overwrite,
                    "ec": ec_policy})
                if edek_attr is not None:
                    # atomic with create: same write lock, extra edit
                    # before the sync (ref: startFile's FEInfo handling)
                    inode.xattrs = {self.EDEK_XATTR: edek_attr}
                    txid = self.editlog.log_edit(el.OP_SET_XATTR, {
                        "p": path, "n": self.EDEK_XATTR, "v": edek_attr})
                status = inode.status(path)
            self.editlog.log_sync(txid)
            log_audit_event(True, "create", path)
            return status

    def add_block(self, path: str, client_name: str,
                  previous: Optional[Dict], exclude: List[str],
                  writer_host: Optional[str] = None) -> LocatedBlock:
        """Allocate the next block + choose its pipeline.
        Ref: FSNamesystem.getAdditionalBlock / NameNodeRpcServer.addBlock."""
        with self._m["add_block"].time():
            prev_block = Block.from_wire(previous) if previous else None
            with self.lock.write():
                self._check_not_safemode("add block")
                inode = self._check_lease_locked(path, client_name)
                if prev_block is not None:
                    self._commit_block_locked(inode, prev_block)
                lb = self._retried_block_locked(inode, prev_block,
                                                exclude, writer_host)
                if lb is not None:
                    return self._with_write_token(lb, client_name)
                last = inode.last_block()
                if last is not None:
                    info = self.bm.get(last.block_id)
                    min_rep = ec.get_policy(inode.ec_policy).k \
                        if inode.ec_policy else self.bm.min_replication
                    if info is not None and info.under_construction and \
                            info.live_replicas() < min_rep:
                        raise NotReplicatedYetError(
                            f"last block of {path} not yet minimally "
                            f"replicated ({info.live_replicas()})")
                self._check_quota_locked(
                    path, d_inodes=0,
                    d_space=inode.block_size * (
                        1 if inode.ec_policy else max(1, inode.replication)))
                offset = sum(b.num_bytes for b in inode.blocks)
                if inode.ec_policy:
                    policy = ec.get_policy(inode.ec_policy)
                    block = Block(self._new_group_id(),
                                  self.current_gen_stamp(), 0)
                    targets = self.bm.dn_manager.choose_targets(
                        policy.num_units, set(exclude), None)
                    if len(targets) < policy.k:
                        raise IOError(
                            f"not enough datanodes for {inode.ec_policy} "
                            f"({len(targets)} live, need >={policy.k})")
                    sinfo = self.bm.add_striped_block_collection(
                        block, inode, policy)
                    sinfo.rbw_locations = {t.uuid for t in targets}
                    for i, t in enumerate(targets):
                        sinfo.unit_map[t.uuid] = i
                    lb = LocatedBlock(
                        block, [t.public_info() for t in targets], offset,
                        ec_policy=policy.name,
                        indices=list(range(len(targets))))
                else:
                    from hadoop_tpu_torch.dfs.protocol.records import (
                        POLICY_TYPES, effective_storage_policy)
                    block = Block(self._new_block_id(),
                                  self.current_gen_stamp(), 0)
                    targets = self.bm.dn_manager.choose_targets(
                        inode.replication, set(exclude), writer_host,
                        preferred_types=POLICY_TYPES.get(
                            effective_storage_policy(inode)))
                    if not targets:
                        raise IOError(
                            f"no datanodes available for {path} "
                            f"(live={len(self.bm.dn_manager.live_nodes())})")
                    info = self.bm.add_block_collection(block, inode,
                                                        inode.replication)
                    info.rbw_locations = {t.uuid for t in targets}
                    lb = LocatedBlock(
                        block, [t.public_info() for t in targets], offset)
                inode.blocks.append(block)
                txid = self.editlog.log_edit(el.OP_ADD_BLOCK, {
                    "p": path, "b": block.to_wire()})
            self._with_write_token(lb, client_name)
            self.editlog.log_sync(txid)
            return lb

    def _with_write_token(self, lb: LocatedBlock,
                          client_name: str) -> LocatedBlock:
        if self.block_tokens is not None:
            # the writer needs WRITE (pipeline) + READ (verify/reopen)
            from hadoop_tpu_torch.dfs.protocol import blocktoken as bt
            lb.token = self.block_tokens.generate_token(
                client_name, lb.block.block_id,
                (bt.MODE_READ, bt.MODE_WRITE))
        return lb

    def _retried_block_locked(self, inode: INodeFile,
                              prev_block: Optional[Block],
                              exclude: List[str],
                              writer_host: Optional[str]
                              ) -> Optional[LocatedBlock]:
        """An ``add_block`` retried because its answer was lost (its
        NameNode stopped or failed over mid-call, ROADMAP C 26): the
        file's last block is the one that call allocated, still empty,
        right after ``previous``. Return it, on the targets this
        NameNode chose for it, or on new ones where a new active never
        knew them (ref: FSDirWriteFileOp.analyzeFileState's retry block
        and getAdditionalBlock's new targets for it)."""
        blocks = inode.blocks
        if not blocks or blocks[-1].num_bytes:
            return None
        before = blocks[-2].block_id if len(blocks) > 1 else None
        if before != (prev_block.block_id if prev_block else None):
            return None
        last = blocks[-1]
        info = self.bm.get(last.block_id)
        if info is None or not info.under_construction or \
                info.live_replicas():
            return None
        offset = sum(b.num_bytes for b in blocks[:-1])
        dm = self.bm.dn_manager

        def usable(nodes):
            return nodes and all(n is not None and n.uuid not in exclude
                                 for n in nodes)

        if inode.ec_policy:
            policy = ec.get_policy(inode.ec_policy)
            units = sorted((i, u) for u, i in info.unit_map.items())
            targets = [dm.get(u) for _, u in units]
            if not usable(targets):
                targets = dm.choose_targets(policy.num_units, set(exclude),
                                            None)
                if len(targets) < policy.k:
                    return None
                info.unit_map = {t.uuid: i for i, t in enumerate(targets)}
                info.rbw_locations = {t.uuid for t in targets}
            return LocatedBlock(
                last, [t.public_info() for t in targets], offset,
                ec_policy=policy.name, indices=list(range(len(targets))))
        targets = [dm.get(u) for u in sorted(info.rbw_locations)]
        if not usable(targets):
            from hadoop_tpu_torch.dfs.protocol.records import (
                POLICY_TYPES, effective_storage_policy)
            targets = dm.choose_targets(
                inode.replication, set(exclude), writer_host,
                preferred_types=POLICY_TYPES.get(
                    effective_storage_policy(inode)))
            if not targets:
                return None
            info.rbw_locations = {t.uuid for t in targets}
        return LocatedBlock(last, [t.public_info() for t in targets], offset)

    def abandon_block(self, path: str, client_name: str, block: Dict) -> None:
        """Client gave up on a block (pipeline could not be built).
        Ref: FSNamesystem.abandonBlock."""
        blk = Block.from_wire(block)
        with self.lock.write():
            inode = self._check_lease_locked(path, client_name)
            inode.blocks = [b for b in inode.blocks
                            if b.block_id != blk.block_id]
            self.bm.remove_block(blk)
            txid = self.editlog.log_edit(el.OP_UPDATE_BLOCKS, {
                "p": path, "b": [b.to_wire() for b in inode.blocks]})
        self.editlog.log_sync(txid)

    def complete(self, path: str, client_name: str,
                 last: Optional[Dict]) -> bool:
        """Finalize the file. Ref: FSNamesystem.completeFile."""
        with self._m["complete"].time():
            with self.lock.write():
                inode = self.fsdir.get_inode(path)
                if last is not None and isinstance(inode, INodeFile) and \
                        not inode.under_construction:
                    # a retried complete whose answer was lost (ROADMAP
                    # C 26; ref: FSDirWriteFileOp.completeFileInternal)
                    done = inode.last_block()
                    blk = Block.from_wire(last)
                    if done is not None and \
                            done.block_id == blk.block_id and \
                            done.gen_stamp == blk.gen_stamp:
                        return True
                inode = self._check_lease_locked(path, client_name)
                if last is not None:
                    self._commit_block_locked(inode, Block.from_wire(last))
                lb = inode.last_block()
                if lb is not None:
                    info = self.bm.get(lb.block_id)
                    min_rep = ec.get_policy(inode.ec_policy).k \
                        if inode.ec_policy else self.bm.min_replication
                    if info is not None and \
                            info.live_replicas() < min_rep:
                        return False  # client retries (ref: completeFile loop)
                inode.under_construction = False
                inode.client_name = None
                inode.mtime = time.time()
                self.leases.remove_lease(client_name, path)
                txid = self.editlog.log_edit(el.OP_CLOSE, {
                    "p": path, "b": [b.to_wire() for b in inode.blocks]})
            self.editlog.log_sync(txid)
            return True

    def _commit_block_locked(self, inode: INodeFile, reported: Block) -> None:
        """Record the client-reported final length/genstamp of a block."""
        for b in inode.blocks:
            if b.block_id == reported.block_id:
                b.num_bytes = reported.num_bytes
                b.gen_stamp = max(b.gen_stamp, reported.gen_stamp)
                self.bm.complete_block(b)
                return

    def _check_lease_locked(self, path: str, client_name: str) -> INodeFile:
        inode = self.fsdir.get_inode(path)
        if inode is None or not isinstance(inode, INodeFile):
            raise FileNotFoundError(f"no such file {path}")
        holder = self.leases.holder_of(path)
        if holder != client_name:
            raise LeaseExpiredError(
                f"lease on {path} held by {holder!r}, not {client_name!r}")
        return inode

    def update_pipeline(self, client_name: str, path: str, old_block: Dict,
                        new_gs: int, new_len: int) -> None:
        """Pipeline recovery bumped the gen stamp.
        Ref: FSNamesystem.updatePipeline."""
        blk = Block.from_wire(old_block)
        with self.lock.write():
            inode = self._check_lease_locked(path, client_name)
            for b in inode.blocks:
                if b.block_id == blk.block_id:
                    b.gen_stamp = new_gs
                    b.num_bytes = new_len
                    info = self.bm.get(b.block_id)
                    if info is not None:
                        info.block.gen_stamp = new_gs
                        # Replicas from the failed pipeline are now stale.
                        info.locations.clear()
                    break
            txid = self.editlog.log_edit(el.OP_UPDATE_BLOCKS, {
                "p": path, "b": [b.to_wire() for b in inode.blocks]})
        self.editlog.log_sync(txid)

    def renew_lease(self, client_name: str) -> None:
        self.leases.renew_lease(client_name)

    def recover_lease(self, path: str, new_holder: str) -> bool:
        """Explicit lease recovery (ref: FSNamesystem.recoverLease). Returns
        True when the file is closed and available."""
        with self.lock.write():
            self.check_access(path, target=PERM_W)
            inode = self.fsdir.get_inode(path)
            if inode is None or not isinstance(inode, INodeFile):
                raise FileNotFoundError(path)
            if not inode.under_construction:
                return True
            if not self.leases.is_soft_expired(path):
                raise AlreadyBeingCreatedError(
                    f"{path} lease not yet soft-expired")
            self._recover_lease_locked(path, inode)
            return not inode.under_construction

    def _recover_lease_locked(self, path: str, inode: INodeFile) -> bool:  # lint: holds=lock
        """Release an abandoned under-construction file. Two phases, like the
        reference (ref: FSNamesystem.internalReleaseLease →
        BlockUnderConstructionFeature.initializeBlockRecovery):

        1. The trailing UC block has no finalized replica but known pipeline
           members → issue RECOVER commands (gen-stamp bump; each DN
           finalizes its rbw replica at its length and reports it) and leave
           the file open-pending; a later pass closes it.
        2. Finalized replicas exist (or recovery completed) → commit lengths
           and close. A trailing block nothing durable is known about is
           dropped.

        Returns True when the file is closed.
        """
        holder = self.leases.holder_of(path)
        if holder:
            self.leases.remove_lease(holder, path)
        last = inode.last_block()
        if last is not None:
            info = self.bm.get(last.block_id)
            if info is not None and info.under_construction and \
                    info.live_replicas() == 0:
                if info.rbw_locations and \
                        self._start_block_recovery_locked(path, info):
                    return False  # recovery in flight; close on a later pass
                # Nothing recoverable: drop the trailing block.
                inode.blocks.pop()
                self.bm.remove_block(last)
        self._pending_recovery.pop(path, None)
        inode.under_construction = False
        inode.client_name = None
        from hadoop_tpu_torch.dfs.namenode.blockmanager import BlockInfoStriped
        for b in inode.blocks:
            info = self.bm.get(b.block_id)
            if isinstance(info, BlockInfoStriped) and b.num_bytes == 0:
                # Group length was never committed by the client; derive it
                # from the finalized unit lengths the DNs reported.
                b.num_bytes = info.logical_length()
                info.block.num_bytes = b.num_bytes
            elif info is not None and info.block.num_bytes > b.num_bytes:
                b.num_bytes = info.block.num_bytes  # recovered length
            self.bm.complete_block(b)
        txid = self.editlog.log_edit(el.OP_CLOSE, {
            "p": path, "b": [b.to_wire() for b in inode.blocks]})
        self.editlog.log_sync(txid)
        log.info("Recovered lease on %s (was held by %s)", path, holder)
        return True

    def _start_block_recovery_locked(self, path: str,  # lint: holds=lock
                                     info) -> bool:
        """Queue RECOVER commands to the expected pipeline members.
        Returns False when no member is live (recovery impossible)."""
        nodes = [self.bm.dn_manager.get(u) for u in info.rbw_locations]
        nodes = [n for n in nodes if n is not None
                 and n.state != "dead"]
        if not nodes:
            return False
        if self._pending_recovery.get(path) is info.inode:
            return True  # already issued; waiting for reports
        new_gs = self.next_gen_stamp()
        old_block = Block(info.block.block_id, info.block.gen_stamp,
                          info.block.num_bytes)
        info.block.gen_stamp = new_gs
        for b in info.inode.blocks:
            if b.block_id == info.block.block_id:
                b.gen_stamp = new_gs
        from hadoop_tpu_torch.dfs.namenode.blockmanager import BlockInfoStriped
        for node in nodes:
            if isinstance(info, BlockInfoStriped):
                # DNs store unit replicas, not the group: recover the unit
                # this node was assigned at allocation time.
                idx = info.unit_map.get(node.uuid)
                if idx is None:
                    continue
                unit = Block(old_block.block_id + idx, old_block.gen_stamp)
                node.recover_queue.append((unit, new_gs))
            else:
                node.recover_queue.append((old_block, new_gs))
        self._pending_recovery[path] = info.inode
        log.info("Started block recovery of %s for %s on %d nodes "
                 "(gs %d -> %d)", info.block, path, len(nodes),
                 old_block.gen_stamp, new_gs)
        return True

    def check_pending_recoveries(self) -> None:
        """Second phase of lease recovery: close files whose block recovery
        reported back. Ref: commitBlockSynchronization's role."""
        with self.lock.read():
            pending = list(self._pending_recovery.items())
        for path, expected in pending:
            with self.lock.write():
                inode = self.fsdir.get_inode(path)
                if inode is not expected:
                    # path deleted, or recreated as a DIFFERENT file a
                    # client is actively writing — either way this
                    # recovery no longer applies (force-closing the new
                    # file would drop a live writer's data)
                    self._pending_recovery.pop(path, None)
                    continue
                if not inode.under_construction:
                    self._pending_recovery.pop(path, None)
                    continue
                last = inode.last_block()
                info = self.bm.get(last.block_id) if last else None
                if info is not None and info.live_replicas() > 0:
                    self._recover_lease_locked(path, inode)

    def check_leases(self) -> None:
        """Periodic hard-limit sweep. Ref: LeaseManager.Monitor."""
        for path in self.leases.hard_expired_paths():
            with self.lock.write():
                inode = self.fsdir.get_inode(path)
                # re-verify expiry UNDER the lock: between the snapshot
                # and here the writer may have renewed, or the path may
                # now be a different, actively-written file (delete +
                # recreate) holding a fresh lease
                if isinstance(inode, INodeFile) and \
                        inode.under_construction and \
                        self.leases.is_hard_expired(path):
                    self._recover_lease_locked(path, inode)
        self.check_pending_recoveries()

    # ------------------------------------------------------------ reads

    def add_provided_file(self, path: str, external_uri: str,
                          length: int,
                          block_size: Optional[int] = None) -> Dict:
        """Mount one external file as a PROVIDED-storage DFS file: the
        namespace entry + alias-map blocks, no data copied (ref: the
        fs2img ImageWriter's per-file treatment — here applied to the
        live namesystem, checkpointed with the image).
        """
        # admin surface: injects externally-backed blocks into the
        # namespace (the fs2img tool's op) — superuser only, like the
        # reference's image-import path
        self.check_superuser("addProvidedFile")
        self.check_path_names(path)
        block_size = block_size or self.default_block_size
        owner = current_user().user_name
        with self.lock.write():
            self._check_not_safemode("add provided file")
            self._check_mutable_path(path)
            if self.fsdir.exists(path):
                raise FileExistsError(path)
            inode = self.fsdir.add_file(path, 1, block_size, owner=owner)
            blocks = []
            off = 0
            while off < length or not blocks:
                n = min(block_size, length - off)
                blk = Block(self._new_block_id(),
                            self.current_gen_stamp(), n)
                self.alias_map[blk.block_id] = {
                    "uri": external_uri, "offset": off, "length": n}
                inode.blocks.append(blk)
                blocks.append(blk)
                off += n
                if length == 0:
                    break
            inode.under_construction = False
            txid = self.editlog.log_edit(el.OP_PROVIDED_FILE, {
                "p": path, "uri": external_uri, "len": length,
                "bs": block_size, "o": owner,
                "b": [b.to_wire() for b in blocks]})
        self.editlog.log_sync(txid)
        log_audit_event(True, "addProvidedFile", path)
        return inode.status(path).to_wire()

    def get_block_alias(self, block_id: int) -> Optional[Dict]:
        with self.lock.read():
            alias = self.alias_map.get(block_id)
            return dict(alias) if alias else None

    def get_block_locations(self, path: str, offset: int,
                            length: int) -> Dict:
        """Ref: FSNamesystem.getBlockLocations (+ the sortLocatedBlocks
        call that orders replicas closest-to-reader-first)."""
        from hadoop_tpu_torch.ipc.server import current_call
        call = current_call()
        reader_host = call.address.rsplit(":", 1)[0] if call else None
        log_audit_event(True, "open", path)
        with self._m["get_block_locations"].time():
            with self.lock.read():
                self.check_access(path, target=PERM_R)
                inode = self.fsdir.get_inode(path)
                if inode is None or not isinstance(inode, INodeFile):
                    raise FileNotFoundError(path)
                blocks: List[LocatedBlock] = []
                pos = 0
                for b in inode.blocks:
                    if pos + b.num_bytes > offset and pos < offset + length:
                        if b.block_id in self.alias_map:
                            # PROVIDED block: any DN can serve it by
                            # fetching from the external store (ref:
                            # ProvidedStorageMap fabricating locations
                            # for the provided storage id).
                            locs = [n.public_info() for n in
                                    self.bm.dn_manager.live_nodes()[:3]]
                            blocks.append(LocatedBlock(b, locs, pos))
                        else:
                            blocks.append(self.bm.located_block(
                                b, pos, reader_host=reader_host))
                    pos += b.num_bytes
                if self.block_tokens is not None:
                    from hadoop_tpu_torch.dfs.protocol import blocktoken as bt
                    user = current_user().user_name
                    for lb in blocks:
                        lb.token = self.block_tokens.generate_token(
                            user, lb.block.block_id, (bt.MODE_READ,))
                return {
                    "length": inode.length(),
                    "blocks": [lb.to_wire() for lb in blocks],
                    "uc": inode.under_construction,
                }

    def get_file_info(self, path: str) -> Optional[Dict]:
        with self._m["get_file_info"].time():
            with self.lock.read():
                # traverse only — stat needs x on the ancestors
                self.check_access(path)
                inode = self.fsdir.get_inode(path)
                return None if inode is None else inode.status(path).to_wire()

    def listing(self, path: str) -> List[Dict]:
        with self._m["listing"].time():
            with self.lock.read():
                # listing a directory reads its children (r) and stats
                # them (x); "listing" a file is just a stat — traverse
                # only (ref: FSPermissionChecker READ_EXECUTE on dirs)
                is_dir = isinstance(self.fsdir.get_inode(path),
                                    INodeDirectory)
                self.check_access(
                    path, target=(PERM_R | PERM_X) if is_dir else 0)
                out = [st.to_wire() for st in self.fsdir.listing(path)]
        log_audit_event(True, "listStatus", path)
        return out

    def content_summary(self, path: str) -> Dict:
        from hadoop_tpu_torch.dfs.namenode.inodes import iter_tree
        with self.lock.read():
            self.check_access(path)
            node = self.fsdir.get_inode(path)
            if node is None:
                raise FileNotFoundError(path)
            files = dirs = length = 0
            for n in iter_tree(node):
                if isinstance(n, INodeFile):
                    files += 1
                    length += n.length()
                else:
                    dirs += 1
            return {"files": files, "dirs": dirs, "length": length}

    # ------------------------------------------------------------ mutations

    def mkdirs(self, path: str) -> bool:
        self.check_path_names(path)
        with self._m["mkdirs"].time():
            owner = current_user().user_name
            with self.lock.write():
                self._check_not_safemode("mkdirs")
                self._check_mutable_path(path)
                if not self.fsdir.exists(path):
                    # WRITE on the deepest existing ancestor (ref:
                    # mkdirs' ancestorAccess=WRITE); an already-existing
                    # directory is the idempotent ensure-exists case and
                    # needs only traversal, like the reference
                    self.check_access(path, parent=PERM_W)
                    self._check_quota_locked(path, d_inodes=1, d_space=0)
                else:
                    self.check_access(path)
                self.fsdir.mkdirs(path, owner=owner)
                txid = self.editlog.log_edit(el.OP_MKDIR,
                                             {"p": path, "o": owner})
            self.editlog.log_sync(txid)
            log_audit_event(True, "mkdirs", path)
            return True

    def delete(self, path: str, recursive: bool) -> bool:
        with self._m["delete"].time():
            with self.lock.write():
                self._check_not_safemode("delete")
                self._check_mutable_path(path)
                self.check_access(
                    path, parent=PERM_W,
                    sub_dirs=(PERM_R | PERM_W | PERM_X) if recursive
                    else 0)
                removed = self._delete_locked(path, recursive)
                if not removed:
                    return False
                txid = self.editlog.log_edit(el.OP_DELETE,
                                             {"p": path, "r": recursive})
            self.editlog.log_sync(txid)
            log_audit_event(True, "delete", path)
            return True

    def _delete_locked(self, path: str, recursive: bool) -> bool:
        target = self.fsdir.get_inode(path)
        if target is not None:
            for n in iter_tree(target):
                if isinstance(n, INodeDirectory) and n.snapshots:
                    raise OSError(
                        f"cannot delete {path}: {n.full_path() or '/'} has "
                        f"{len(n.snapshots)} snapshot(s) — delete them "
                        "first (ref: the snapshottable-dir delete guard)")
        node = self.fsdir.delete(path, recursive)
        if node is None:
            return False
        # Open files anywhere under the deleted subtree lose their leases.
        self.leases.remove_under(path)
        blocks = collect_blocks(node)
        # Blocks captured by a snapshot stay alive until the last snapshot
        # referencing them is deleted (ref: snapshot block collection in
        # INodeFile.destroyAndCollectBlocks).
        pinned = self._pinned_block_ids_locked() if blocks else set()
        for b in blocks:
            if b.block_id not in pinned:
                self.bm.remove_block(b)
                # Provided blocks: drop the alias entry too, or it leaks
                # into every future image and keeps the external bytes
                # addressable by block id after delete.
                self.alias_map.pop(b.block_id, None)
        return True

    def rename(self, src: str, dst: str) -> bool:
        self.check_path_names(dst)
        with self._m["rename"].time():
            with self.lock.write():
                self._check_not_safemode("rename")
                self.check_access(src, parent=PERM_W)
                # move-INTO semantics: an existing dst directory IS the
                # parent the file lands in — WRITE must hold on it, not
                # on its parent (ref: FSDirRenameOp resolving the real
                # destination parent)
                if isinstance(self.fsdir.get_inode(dst), INodeDirectory):
                    self.check_access(dst, target=PERM_W)
                else:
                    self.check_access(dst, parent=PERM_W)
                self._check_mutable_path(src, dst)
                actual_dst = self.fsdir.rename(src, dst)
                self.leases.rename_path(src, actual_dst)
                # in-flight block recoveries follow the rename — their
                # phase-1 already stripped the lease, so a stale-keyed
                # entry would strand the file under-construction forever
                prefix = src.rstrip("/") + "/"
                for p in list(self._pending_recovery):
                    if p == src or p.startswith(prefix):
                        self._pending_recovery[actual_dst + p[len(src):]] \
                            = self._pending_recovery.pop(p)
                txid = self.editlog.log_edit(el.OP_RENAME,
                                             {"s": src, "d": dst})
            self.editlog.log_sync(txid)
            log_audit_event(True, "rename", src, dst)
            return True

    def set_replication(self, path: str, replication: int) -> bool:
        self._check_mutable_path(path)
        with self.lock.write():
            self._check_not_safemode("set replication")
            self.check_access(path, target=PERM_W)
            inode = self.fsdir.get_inode(path)
            if inode is None or not isinstance(inode, INodeFile):
                raise FileNotFoundError(path)
            inode.replication = replication
            for b in inode.blocks:
                info = self.bm.get(b.block_id)
                if info is not None:
                    info.expected_replication = replication
                    with self.bm._lock:
                        self.bm._update_needed_locked(info)
            txid = self.editlog.log_edit(el.OP_SET_REPLICATION,
                                         {"p": path, "rep": replication})
        self.editlog.log_sync(txid)
        return True

    # --------------------------------------------------------------- quotas

    def _check_quota_locked(self, path: str, d_inodes: int,
                            d_space: int) -> None:
        """Verify every quota-bearing ancestor of ``path`` can absorb the
        delta (ref: FSDirectory.verifyQuota). Quotas are rare, so usage is
        computed on demand rather than cached. Missing intermediate
        directories count toward the inode delta — they are about to be
        created too."""
        comps = [c for c in path.split("/") if c]
        node = self.fsdir.root
        chain = [node]
        for i, comp in enumerate(comps[:-1]):
            if not isinstance(node, INodeDirectory):
                break
            node = node.get_child(comp)
            if node is None:
                d_inodes += len(comps) - 1 - i  # dirs mkdirs will create
                break
            chain.append(node)
        for d in chain:
            if not isinstance(d, INodeDirectory):
                continue
            if d.ns_quota < 0 and d.space_quota < 0:
                continue
            inodes, space = subtree_counts(d)
            if 0 <= d.ns_quota < inodes + d_inodes:
                raise QuotaExceededError(
                    f"namespace quota of {d.full_path() or '/'} exceeded: "
                    f"quota={d.ns_quota} would-be={inodes + d_inodes}")
            if 0 <= d.space_quota < space + d_space:
                raise QuotaExceededError(
                    f"space quota of {d.full_path() or '/'} exceeded: "
                    f"quota={d.space_quota} would-be={space + d_space}")

    def set_quota(self, path: str, ns_quota: int, space_quota: int) -> None:
        """Ref: FSDirAttrOp.setQuota; -1 clears a dimension."""
        self.check_superuser("setQuota")
        self._check_mutable_path(path)
        with self.lock.write():
            self._check_not_safemode("set quota")
            node = self.fsdir.get_inode(path)
            if not isinstance(node, INodeDirectory):
                raise NotADirectoryError(f"quota target {path}")
            node.ns_quota = ns_quota
            node.space_quota = space_quota
            txid = self.editlog.log_edit(el.OP_SET_QUOTA, {
                "p": path, "nq": ns_quota, "sq": space_quota})
        self.editlog.log_sync(txid)

    # --------------------------------------------------------------- xattrs

    # ----------------------------------------------------- centralized cache

    def add_cache_directive(self, path: str) -> int:
        """Pin a file's blocks in DataNode memory (ref: namenode/
        CacheManager.java addDirective; pools collapse to flat
        directives). Returns the directive id."""
        with self.lock.write():
            self.check_access(path, target=PERM_R)
            node = self.fsdir.get_inode(path)
            if node is None or not isinstance(node, INodeFile):
                raise FileNotFoundError(path)
            did = self._next_cache_id
            self._next_cache_id += 1
            self.cache_directives[did] = path
            txid = self.editlog.log_edit(el.OP_ADD_CACHE_DIRECTIVE,
                                         {"id": did, "p": path})
        self.editlog.log_sync(txid)
        log_audit_event(True, "addCacheDirective", path)
        return did

    def remove_cache_directive(self, directive_id: int) -> bool:
        with self.lock.write():
            existing = self.cache_directives.get(directive_id)
            if existing is None:
                return False
            # same bar as adding one for that path: a user who cannot
            # read the file must not be able to evict its pinned blocks
            self.check_access(existing, target=PERM_R)
            gone = self.cache_directives.pop(directive_id, None)
            if gone is None:
                return False
            txid = self.editlog.log_edit(el.OP_REMOVE_CACHE_DIRECTIVE,
                                         {"id": directive_id})
        self.editlog.log_sync(txid)
        log_audit_event(True, "removeCacheDirective", gone)
        return True

    def list_cache_directives(self) -> Dict[int, str]:
        with self.lock.read():
            return dict(self.cache_directives)

    def cache_monitor_pass(self) -> None:
        """Reconcile DN cache state against the directives (ref:
        CacheReplicationMonitor.rescan)."""
        wanted: set = set()
        with self.lock.read():
            for path in self.cache_directives.values():
                node = self.fsdir.get_inode(path)
                if isinstance(node, INodeFile):
                    wanted.update(b.block_id for b in node.blocks)
        self.bm.reconcile_cache(wanted)

    # ------------------------------------------------------ encryption zones

    ZONE_XATTR = "system.crypto.zone"       # on the zone root: key name
    EDEK_XATTR = "system.crypto.edek"       # on each file: json FEInfo

    def _kms(self):
        """Lazy KMS client (ref: dfs.encryption.key.provider.uri — the NN
        generates EDEKs; it never sees plaintext DEKs)."""
        if getattr(self, "_kms_provider", None) is None:
            uri = self.conf.get("dfs.encryption.key.provider.uri", "")
            if not uri:
                return None
            from hadoop_tpu_torch.crypto.kms import KMSKeyProvider
            addr = uri.split("://", 1)[-1].rstrip("/")
            self._kms_provider = KMSKeyProvider(addr, user="namenode")
        return self._kms_provider

    def create_encryption_zone(self, path: str, key_name: str) -> bool:
        """Mark an EMPTY directory as an encryption zone (ref:
        FSDirEncryptionZoneOp.createEncryptionZone — same constraints:
        directory, empty, not nested inside another zone)."""
        self.check_superuser("createEncryptionZone")
        if self._kms() is None:
            raise ValueError("no KMS configured "
                             "(dfs.encryption.key.provider.uri)")
        self._kms().get_current_key(key_name)  # must exist
        with self.lock.write():
            node = self._inode_or_raise(path)
            if not isinstance(node, INodeDirectory):
                raise NotADirectoryError(path)
            if node.children:
                raise OSError(f"cannot create zone on non-empty {path}")
            if self._zone_key_locked(path) is not None:
                raise OSError(f"{path} is already inside an encryption "
                              "zone")
            if node.xattrs is None:
                node.xattrs = {}
            node.xattrs[self.ZONE_XATTR] = key_name.encode()
            txid = self.editlog.log_edit(el.OP_SET_XATTR, {
                "p": path, "n": self.ZONE_XATTR, "v": key_name.encode()})
        self.editlog.log_sync(txid)
        log_audit_event(True, "createEncryptionZone", path)
        return True

    def _generate_edek_attr(self, key_name: str) -> bytes:
        """EDEK + metadata as the xattr payload (FileEncryptionInfo)."""
        import base64 as _b64
        import json as _json
        ekv = self._kms().generate_encrypted_key(key_name)
        return _json.dumps({
            "key": ekv.key_name, "version": ekv.key_version,
            "iv": _b64.b64encode(ekv.iv).decode(),
            "edek": _b64.b64encode(ekv.edek).decode(),
        }).encode()

    def _zone_key_locked(self, path: str) -> Optional[str]:
        """Nearest ancestor zone's key name (caller holds a lock)."""
        parts = [p for p in path.split("/") if p]
        for i in range(len(parts), -1, -1):
            prefix = "/" + "/".join(parts[:i]) if i else "/"
            node = self.fsdir.get_inode(prefix)
            if node is not None and node.xattrs and \
                    self.ZONE_XATTR in node.xattrs:
                return node.xattrs[self.ZONE_XATTR].decode()
        return None

    def list_encryption_zones(self) -> Dict[str, str]:
        """path → key name for every zone root (ref:
        FSDirEncryptionZoneOp.listEncryptionZones)."""
        out: Dict[str, str] = {}
        with self.lock.read():
            def walk(node, path: str) -> None:
                if node.xattrs and self.ZONE_XATTR in node.xattrs:
                    out[path or "/"] = \
                        node.xattrs[self.ZONE_XATTR].decode()
                if isinstance(node, INodeDirectory):
                    for name, child in node.children.items():
                        walk(child, f"{path}/{name}")
            walk(self.fsdir.root, "")
        return out

    def get_encryption_info(self, path: str) -> Optional[Dict]:
        """The file's FileEncryptionInfo for clients (ref:
        FSDirEncryptionZoneOp.getFileEncryptionInfo): the EDEK + key
        version the client hands to the KMS to obtain the DEK."""
        import json as _json
        with self.lock.read():
            node = self.fsdir.get_inode(path)
            if node is None or node.xattrs is None or \
                    self.EDEK_XATTR not in node.xattrs:
                return None
            return _json.loads(node.xattrs[self.EDEK_XATTR].decode())

    def set_xattr(self, path: str, name: str, value: bytes) -> None:
        """Ref: FSDirXAttrOp.setXAttr — names are namespaced."""
        self._check_mutable_path(path)
        ns = name.split(".", 1)[0]
        if ns not in ("user", "trusted", "system", "security", "raw"):
            raise ValueError(f"xattr name must be namespaced: {name!r}")
        if ns != "user":
            # trusted/system/security/raw carry internal state (EDEKs,
            # provenance): WRITE on the file must not allow forging it
            # (ref: XAttrPermissionFilter restricting these namespaces)
            self.check_superuser(f"setXAttr:{ns}")
        with self.lock.write():
            self.check_access(path, target=PERM_W)
            node = self._inode_or_raise(path)
            if node.xattrs is None:
                node.xattrs = {}
            node.xattrs[name] = value
            txid = self.editlog.log_edit(el.OP_SET_XATTR, {
                "p": path, "n": name, "v": value})
        self.editlog.log_sync(txid)

    def get_xattrs(self, path: str,
                   names: Optional[List[str]] = None) -> Dict[str, bytes]:
        with self.lock.read():
            self.check_access(path, target=PERM_R)
            node = self._inode_or_raise(path)
            attrs = node.xattrs or {}
            if names:
                missing = [n for n in names if n not in attrs]
                if missing:
                    raise ValueError(f"no such xattr(s) {missing} on {path}")
                return {n: attrs[n] for n in names}
            return dict(attrs)

    def remove_xattr(self, path: str, name: str) -> None:
        self._check_mutable_path(path)
        if name.split(".", 1)[0] != "user":
            self.check_superuser("removeXAttr:reserved")
        with self.lock.write():
            self.check_access(path, target=PERM_W)
            node = self._inode_or_raise(path)
            if not node.xattrs or name not in node.xattrs:
                raise ValueError(f"no xattr {name!r} on {path}")
            del node.xattrs[name]
            txid = self.editlog.log_edit(el.OP_REMOVE_XATTR, {
                "p": path, "n": name})
        self.editlog.log_sync(txid)

    # ----------------------------------------------------------------- acls

    def set_acl(self, path: str, entries: List[str]) -> None:
        """Replace the full ACL (ref: FSDirAclOp.setAcl). Entries are
        "type:name:perms" strings ("user:alice:rw-", "group::r--")."""
        self._check_mutable_path(path)
        for e in entries:
            if len(e.split(":")) != 3:
                raise ValueError(f"malformed ACL entry {e!r}")
        with self.lock.write():
            self.check_access(path, owner_only=True)
            node = self._inode_or_raise(path)
            node.acl = list(entries) or None
            txid = self.editlog.log_edit(el.OP_SET_ACL, {
                "p": path, "e": list(entries)})
        self.editlog.log_sync(txid)

    def get_acl(self, path: str) -> List[str]:
        with self.lock.read():
            self.check_access(path)
            return list(self._inode_or_raise(path).acl or [])

    def remove_acl(self, path: str) -> None:
        self.set_acl(path, [])

    # ------------------------------------------------------- storage policy

    def set_storage_policy(self, path: str, policy: str) -> None:
        self._check_mutable_path(path)
        if policy not in STORAGE_POLICIES:
            raise ValueError(
                f"unknown storage policy {policy!r}; known: "
                f"{STORAGE_POLICIES}")
        with self.lock.write():
            self.check_access(path, target=PERM_W)
            node = self._inode_or_raise(path)
            node.storage_policy = policy
            txid = self.editlog.log_edit(el.OP_SET_STORAGE_POLICY, {
                "p": path, "sp": policy})
        self.editlog.log_sync(txid)

    def get_storage_policy(self, path: str) -> str:
        """Effective (inherited) policy; HOT when unset."""
        with self.lock.read():
            node = self._inode_or_raise(path)
            while node is not None:
                if node.storage_policy:
                    return node.storage_policy
                node = node.parent
            return "HOT"

    def _inode_or_raise(self, path: str):
        node = self.fsdir.get_inode(path)
        if node is None:
            raise FileNotFoundError(path)
        return node

    # ------------------------------------------------------------ snapshots

    def allow_snapshot(self, path: str) -> None:
        """Ref: FSDirSnapshotOp.allowSnapshot."""
        self.check_superuser("allowSnapshot")
        with self.lock.write():
            node = self._inode_or_raise(path)
            if not isinstance(node, INodeDirectory):
                raise NotADirectoryError(path)
            node.snapshottable = True
            if node.snapshots is None:
                node.snapshots = {}
            txid = self.editlog.log_edit(el.OP_ALLOW_SNAPSHOT, {"p": path})
        self.editlog.log_sync(txid)

    def disallow_snapshot(self, path: str) -> None:
        self.check_superuser("disallowSnapshot")
        with self.lock.write():
            node = self._inode_or_raise(path)
            if not isinstance(node, INodeDirectory):
                raise NotADirectoryError(path)
            if node.snapshots:
                raise OSError(
                    f"{path} has {len(node.snapshots)} snapshot(s); delete "
                    "them first")
            node.snapshottable = False
            txid = self.editlog.log_edit(el.OP_DISALLOW_SNAPSHOT,
                                         {"p": path})
        self.editlog.log_sync(txid)

    def create_snapshot(self, path: str, name: str) -> str:
        """Ref: FSDirSnapshotOp.createSnapshot — captures the subtree's
        metadata; shared Block objects pin the data against deletion."""
        with self.lock.write():
            self._check_not_safemode("create snapshot")
            self.check_access(path, owner_only=True)
            node = self._inode_or_raise(path)
            if not isinstance(node, INodeDirectory) or not node.snapshottable:
                raise OSError(f"{path} is not snapshottable")
            if name in (node.snapshots or {}):
                raise FileExistsError(f"snapshot {name} exists on {path}")
            node.snapshots[name] = snapshot_copy(node)
            self._snapshot_count += 1
            txid = self.editlog.log_edit(el.OP_CREATE_SNAPSHOT, {
                "p": path, "n": name})
        self.editlog.log_sync(txid)
        return f"{path.rstrip('/')}/.snapshot/{name}"

    def delete_snapshot(self, path: str, name: str) -> None:
        with self.lock.write():
            self.check_access(path, owner_only=True)
            node = self._inode_or_raise(path)
            self._delete_snapshot_locked(node, path, name)
            txid = self.editlog.log_edit(el.OP_DELETE_SNAPSHOT, {
                "p": path, "n": name})
        self.editlog.log_sync(txid)

    def _delete_snapshot_locked(self, node, path: str, name: str) -> None:
        """Drop the snapshot and garbage-collect blocks referenced by
        nothing else — shared by the live path and edit replay so a
        standby's block map tracks the active's."""
        if not isinstance(node, INodeDirectory) or \
                name not in (node.snapshots or {}):
            raise FileNotFoundError(f"snapshot {name} on {path}")
        dropped = node.snapshots.pop(name)
        self._snapshot_count -= 1
        still = self._pinned_block_ids_locked()
        for n in iter_tree(self.fsdir.root):
            if isinstance(n, INodeFile):
                still.update(b.block_id for b in n.blocks)
        for b in collect_blocks(dropped):
            if b.block_id not in still:
                self.bm.remove_block(b)

    def rename_snapshot(self, path: str, old: str, new: str) -> None:
        with self.lock.write():
            self.check_access(path, owner_only=True)
            node = self._inode_or_raise(path)
            if not isinstance(node, INodeDirectory) or \
                    old not in (node.snapshots or {}):
                raise FileNotFoundError(f"snapshot {old} on {path}")
            if new in node.snapshots:
                raise FileExistsError(f"snapshot {new} on {path}")
            node.snapshots[new] = node.snapshots.pop(old)
            txid = self.editlog.log_edit(el.OP_RENAME_SNAPSHOT, {
                "p": path, "o": old, "n": new})
        self.editlog.log_sync(txid)

    def snapshot_diff(self, path: str, from_snap: str,
                      to_snap: str) -> Dict:
        """Paths created/deleted/modified between two snapshots ('' = the
        live tree). Ref: SnapshotDiffReport."""
        def index(root, prefix: str, out: Dict) -> Dict:
            # Keys are paths RELATIVE to the compared root — a snapshot
            # copy and the live dir share no parent chain, so absolute
            # paths would never align.
            out[prefix or "/"] = root
            if isinstance(root, INodeDirectory):
                for name, child in root.children.items():
                    index(child, f"{prefix}/{name}", out)
            return out

        with self.lock.read():
            node = self._inode_or_raise(path)
            if not isinstance(node, INodeDirectory):
                raise NotADirectoryError(path)

            def pick(name):
                if not name:
                    return node
                snap = (node.snapshots or {}).get(name)
                if snap is None:
                    raise FileNotFoundError(f"snapshot {name} on {path}")
                return snap

            a = index(pick(from_snap), "", {})
            b = index(pick(to_snap), "", {})
            base = path.rstrip("/")
            created = sorted(base + p for p in set(b) - set(a))
            deleted = sorted(base + p for p in set(a) - set(b))
            modified = sorted(
                base + p for p in set(a) & set(b)
                if isinstance(a[p], INodeFile) and isinstance(b[p], INodeFile)
                and ([blk.block_id for blk in a[p].blocks],
                     a[p].length()) != ([blk.block_id for blk in b[p].blocks],
                                        b[p].length()))
            return {"created": created, "deleted": deleted,
                    "modified": modified}

    def _pinned_block_ids_locked(self) -> set:
        """Block ids held by ANY snapshot anywhere in the namespace. The
        snapshot counter makes the no-snapshots case O(1) — deletes on a
        snapshot-free namespace must not pay a full tree walk."""
        if self._snapshot_count <= 0:
            return set()
        pinned = set()
        for n in iter_tree(self.fsdir.root):
            if isinstance(n, INodeDirectory) and n.snapshots:
                for snap in n.snapshots.values():
                    pinned.update(b.block_id for b in collect_blocks(snap))
        return pinned

    # ------------------------------------------------------ concat/truncate

    def concat(self, target: str, srcs: List[str]) -> None:
        """Move the blocks of ``srcs`` onto the end of ``target`` and
        delete the sources (ref: FSDirConcatOp — metadata-only append)."""
        with self.lock.write():
            self._check_not_safemode("concat")
            self._check_mutable_path(target, *srcs)
            self.check_access(target, target=PERM_W)
            for s in srcs:
                self.check_access(s, parent=PERM_W, target=PERM_W)
            if len(set(srcs)) != len(srcs) or target in srcs:
                raise ValueError(
                    f"concat sources must be distinct and exclude the "
                    f"target: {target} ← {srcs}")
            tgt = self._inode_or_raise(target)
            if not isinstance(tgt, INodeFile) or tgt.under_construction:
                raise OSError(f"concat target {target} not a closed file")
            if tgt.ec_policy:
                raise OSError("concat of striped files is unsupported")
            for s in srcs:
                src = self._inode_or_raise(s)
                if not isinstance(src, INodeFile) or src.under_construction:
                    raise OSError(f"concat source {s} not a closed file")
                if src.ec_policy:
                    raise OSError("concat of striped files is unsupported")
                if src.block_size != tgt.block_size:
                    raise OSError(f"block size mismatch: {s}")
            for s in srcs:
                src = self.fsdir.get_inode(s)
                for b in src.blocks:
                    info = self.bm.get(b.block_id)
                    if info is not None:
                        info.inode = tgt
                        info.expected_replication = tgt.replication
                tgt.blocks.extend(src.blocks)
                src.blocks = []
                self.fsdir.delete(s, recursive=False)
            tgt.mtime = time.time()
            txid = self.editlog.log_edit(el.OP_CONCAT, {
                "p": target, "s": list(srcs)})
        self.editlog.log_sync(txid)

    def truncate(self, path: str, new_length: int) -> bool:
        """Shrink a file (ref: FSDirTruncateOp). Whole blocks past the cut
        are dropped; the boundary block's length is trimmed in metadata —
        reads clamp to it, so no DN round trip is needed. Returns True
        (immediate completion; the reference's in-progress recovery case
        does not arise)."""
        with self.lock.write():
            self.check_access(path, target=PERM_W)
            self._check_not_safemode("truncate")
            self._check_mutable_path(path)
            inode = self._inode_or_raise(path)
            if not isinstance(inode, INodeFile):
                raise IsADirectoryError(path)
            if inode.under_construction:
                raise OSError(f"{path} is being written")
            if inode.ec_policy:
                raise OSError("truncate of striped files is unsupported")
            if new_length > inode.length():
                raise ValueError(
                    f"truncate length {new_length} > file length "
                    f"{inode.length()}")
            pinned = self._pinned_block_ids_locked()
            if any(b.block_id in pinned for b in inode.blocks):
                # Block objects are shared with snapshot copies; trimming
                # or dropping them would corrupt the captured version (the
                # reference versions the boundary block instead — here the
                # operation is refused, not silently wrong).
                raise OSError(
                    f"cannot truncate {path}: captured in a snapshot")
            pos = 0
            kept: List[Block] = []
            for b in inode.blocks:
                if pos >= new_length:
                    self.bm.remove_block(b)
                    continue
                if pos + b.num_bytes > new_length:
                    b.num_bytes = new_length - pos
                    info = self.bm.get(b.block_id)
                    if info is not None:
                        info.block.num_bytes = b.num_bytes
                kept.append(b)
                pos += b.num_bytes
            inode.blocks = kept
            inode.mtime = time.time()
            txid = self.editlog.log_edit(el.OP_TRUNCATE, {
                "p": path, "l": new_length,
                "b": [b.to_wire() for b in kept]})
        self.editlog.log_sync(txid)
        return True

    # ---------------------------------------------------------- erasure coding

    def _effective_ec_policy_locked(self, path: str) -> Optional[str]:
        """Nearest ancestor directory's EC policy (ref:
        FSDirErasureCodingOp.getErasureCodingPolicy — the EC xattr is
        inherited down the tree)."""
        comps = [c for c in path.split("/") if c]
        node = self.fsdir.root
        policy = node.ec_policy
        for comp in comps[:-1]:
            if not isinstance(node, INodeDirectory):
                break
            node = node.get_child(comp)
            if node is None:
                break
            if getattr(node, "ec_policy", None):
                policy = node.ec_policy
        return policy

    def set_ec_policy(self, path: str, policy_name: Optional[str]) -> bool:
        """Set (or clear, with None) the EC policy on a directory.
        Ref: FSNamesystem.setErasureCodingPolicy."""
        if policy_name:
            ec.get_policy(policy_name)  # validate
        with self.lock.write():
            self._check_not_safemode("set EC policy")
            self.check_access(path, target=PERM_W)
            node = self.fsdir.get_inode(path)
            if node is None:
                raise FileNotFoundError(path)
            if not isinstance(node, INodeDirectory):
                raise NotADirectoryError(
                    f"EC policy can only be set on directories: {path}")
            node.ec_policy = policy_name
            txid = self.editlog.log_edit(el.OP_SET_EC_POLICY, {
                "p": path, "ec": policy_name})
        self.editlog.log_sync(txid)
        return True

    def get_ec_policy(self, path: str) -> Optional[str]:
        """Effective policy for a path (file's own or inherited)."""
        with self.lock.read():
            node = self.fsdir.get_inode(path)
            if node is None:
                raise FileNotFoundError(path)
            own = getattr(node, "ec_policy", None)
            if own:
                return own
            return self._effective_ec_policy_locked(
                path.rstrip("/") + "/_" if isinstance(node, INodeDirectory)
                else path)

    def set_times(self, path: str, mtime: float, atime: float) -> None:
        self._check_mutable_path(path)
        with self.lock.write():
            self.check_access(path, target=PERM_W)
            inode = self.fsdir.get_inode(path)
            if inode is None:
                raise FileNotFoundError(path)
            if mtime >= 0:
                inode.mtime = mtime
            if atime >= 0:
                inode.atime = atime
            txid = self.editlog.log_edit(el.OP_SET_TIMES, {
                "p": path, "mt": mtime, "at": atime})
        self.editlog.log_sync(txid)

    def set_permission(self, path: str, permission: int) -> None:
        self._check_mutable_path(path)
        with self.lock.write():
            self.check_access(path, owner_only=True)
            inode = self.fsdir.get_inode(path)
            if inode is None:
                raise FileNotFoundError(path)
            inode.permission = permission
            txid = self.editlog.log_edit(el.OP_SET_PERMISSION, {
                "p": path, "pm": permission})
        self.editlog.log_sync(txid)

    def set_owner(self, path: str, owner: str, group: str) -> None:
        self._check_mutable_path(path)
        with self.lock.write():
            # traversal first (EXECUTE on every ancestor, like every
            # other op): a caller who cannot reach the path must not
            # learn whether it exists or who owns it
            self.check_access(path)
            inode = self.fsdir.get_inode(path)
            if inode is None:
                raise FileNotFoundError(path)
            self._check_set_owner_access(path, inode, owner, group)
            if owner:
                inode.owner = owner
            if group:
                inode.group = group
            txid = self.editlog.log_edit(el.OP_SET_OWNER, {
                "p": path, "o": owner, "g": group})
        self.editlog.log_sync(txid)

    # ----------------------------------------------------------- replay

    def _apply_edit(self, rec: Dict) -> None:
        """Replay one edit record at startup. Ref: FSEditLogLoader
        .applyEditLogOp."""
        op = rec["op"]
        # Track the id/stamp high-water marks across ALL replayed blocks —
        # including those of files later deleted, whose replicas may still
        # sit on DNs awaiting invalidation; reissuing their ids would collide.
        for bw in ([rec["b"]] if op == el.OP_ADD_BLOCK else
                   rec.get("b", []) if op in (el.OP_UPDATE_BLOCKS, el.OP_CLOSE)
                   else []):
            if isinstance(bw, dict):
                self._track_block_id(bw)
        if op == el.OP_ADD:
            if rec.get("ov") and self.fsdir.exists(rec["p"]):
                # create(overwrite=True) replaced an existing file; replay the
                # implicit delete (its blocks die with it — any replicas left
                # on DNs are invalidated as unknown at report time). Pinned
                # blocks survive, exactly like the live path.
                gone = self.fsdir.delete(rec["p"], recursive=False)
                if gone is not None:
                    pinned = self._pinned_block_ids_locked()
                    for b in collect_blocks(gone):
                        if b.block_id not in pinned:
                            self.bm.remove_block(b)
                            self.alias_map.pop(b.block_id, None)
                holder = self.leases.holder_of(rec["p"])
                if holder:
                    self.leases.remove_lease(holder, rec["p"])
            inode = self.fsdir.add_file(rec["p"], rec["rep"], rec["bs"],
                                        owner=rec.get("o", ""),
                                        ec_policy=rec.get("ec"))
            inode.under_construction = True
            inode.client_name = rec.get("cl")
            if inode.client_name:
                self.leases.add_lease(inode.client_name, rec["p"])
        elif op == el.OP_PROVIDED_FILE:
            inode = self.fsdir.add_file(rec["p"], 1, rec["bs"],
                                        owner=rec.get("o", ""))
            inode.under_construction = False
            off = 0
            for bw in rec.get("b", []):
                blk = Block.from_wire(bw)
                self._track_block_id(bw)
                inode.blocks.append(blk)
                self.alias_map[blk.block_id] = {
                    "uri": rec["uri"], "offset": off,
                    "length": blk.num_bytes}
                off += blk.num_bytes
        elif op == el.OP_ADD_BLOCK:
            inode = self.fsdir.get_inode(rec["p"])
            if isinstance(inode, INodeFile):
                blk = Block.from_wire(rec["b"])
                inode.blocks.append(blk)
                info = self._register_block_locked(inode, blk)
                info.under_construction = True
        elif op == el.OP_UPDATE_BLOCKS:
            inode = self.fsdir.get_inode(rec["p"])
            if isinstance(inode, INodeFile):
                new_blocks = [Block.from_wire(b) for b in rec["b"]]
                kept = {b.block_id for b in new_blocks}
                for old in inode.blocks:
                    if old.block_id not in kept:
                        self.bm.remove_block(old)
                inode.blocks = new_blocks
                for b in inode.blocks:
                    self._register_block_locked(inode, b)
        elif op == el.OP_CLOSE:
            inode = self.fsdir.get_inode(rec["p"])
            if isinstance(inode, INodeFile):
                inode.blocks = [Block.from_wire(b) for b in rec["b"]]
                inode.under_construction = False
                if inode.client_name:
                    self.leases.remove_lease(inode.client_name, rec["p"])
                    inode.client_name = None
                for b in inode.blocks:
                    self._register_block_locked(inode, b)
                    self.bm.complete_block(b)
        elif op == el.OP_MKDIR:
            self.fsdir.mkdirs(rec["p"], owner=rec.get("o", ""))
        elif op == el.OP_DELETE:
            node = self.fsdir.delete(rec["p"], rec.get("r", True))
            if node is not None:
                self.leases.remove_under(rec["p"])
                pinned = self._pinned_block_ids_locked()
                for b in collect_blocks(node):
                    if b.block_id not in pinned:
                        self.bm.remove_block(b)
        elif op == el.OP_RENAME:
            actual = self.fsdir.rename(rec["s"], rec["d"])
            self.leases.rename_path(rec["s"], actual)
        elif op == el.OP_SET_REPLICATION:
            inode = self.fsdir.get_inode(rec["p"])
            if isinstance(inode, INodeFile):
                inode.replication = rec["rep"]
        elif op == el.OP_SET_TIMES:
            inode = self.fsdir.get_inode(rec["p"])
            if inode is not None:
                if rec["mt"] >= 0:
                    inode.mtime = rec["mt"]
                if rec["at"] >= 0:
                    inode.atime = rec["at"]
        elif op == el.OP_SET_PERMISSION:
            inode = self.fsdir.get_inode(rec["p"])
            if inode is not None:
                inode.permission = rec["pm"]
        elif op == el.OP_SET_OWNER:
            inode = self.fsdir.get_inode(rec["p"])
            if inode is not None:
                inode.owner = rec.get("o") or inode.owner
                inode.group = rec.get("g") or inode.group
        elif op == el.OP_SET_EC_POLICY:
            node = self.fsdir.get_inode(rec["p"])
            if isinstance(node, INodeDirectory):
                node.ec_policy = rec.get("ec")
        elif op == el.OP_SET_QUOTA:
            node = self.fsdir.get_inode(rec["p"])
            if isinstance(node, INodeDirectory):
                node.ns_quota = rec.get("nq", -1)
                node.space_quota = rec.get("sq", -1)
        elif op == el.OP_ADD_CACHE_DIRECTIVE:
            self.cache_directives[rec["id"]] = rec["p"]
            self._next_cache_id = max(self._next_cache_id, rec["id"] + 1)
        elif op == el.OP_REMOVE_CACHE_DIRECTIVE:
            self.cache_directives.pop(rec["id"], None)
        elif op == el.OP_SET_XATTR:
            node = self.fsdir.get_inode(rec["p"])
            if node is not None:
                if node.xattrs is None:
                    node.xattrs = {}
                node.xattrs[rec["n"]] = rec["v"]
        elif op == el.OP_REMOVE_XATTR:
            node = self.fsdir.get_inode(rec["p"])
            if node is not None and node.xattrs:
                node.xattrs.pop(rec["n"], None)
        elif op == el.OP_SET_ACL:
            node = self.fsdir.get_inode(rec["p"])
            if node is not None:
                node.acl = list(rec.get("e") or []) or None
        elif op == el.OP_SET_STORAGE_POLICY:
            node = self.fsdir.get_inode(rec["p"])
            if node is not None:
                node.storage_policy = rec.get("sp")
        elif op == el.OP_ALLOW_SNAPSHOT:
            node = self.fsdir.get_inode(rec["p"])
            if isinstance(node, INodeDirectory):
                node.snapshottable = True
                if node.snapshots is None:
                    node.snapshots = {}
        elif op == el.OP_DISALLOW_SNAPSHOT:
            node = self.fsdir.get_inode(rec["p"])
            if isinstance(node, INodeDirectory):
                node.snapshottable = False
        elif op == el.OP_CREATE_SNAPSHOT:
            node = self.fsdir.get_inode(rec["p"])
            if isinstance(node, INodeDirectory) and node.snapshottable:
                node.snapshots[rec["n"]] = snapshot_copy(node)
                self._snapshot_count += 1
        elif op == el.OP_DELETE_SNAPSHOT:
            node = self.fsdir.get_inode(rec["p"])
            try:
                self._delete_snapshot_locked(node, rec["p"], rec["n"])
            except FileNotFoundError:
                pass
        elif op == el.OP_RENAME_SNAPSHOT:
            node = self.fsdir.get_inode(rec["p"])
            if isinstance(node, INodeDirectory) and node.snapshots and \
                    rec["o"] in node.snapshots:
                node.snapshots[rec["n"]] = node.snapshots.pop(rec["o"])
        elif op == el.OP_CONCAT:
            tgt = self.fsdir.get_inode(rec["p"])
            if isinstance(tgt, INodeFile):
                for s in rec.get("s", []):
                    src = self.fsdir.get_inode(s)
                    if isinstance(src, INodeFile):
                        for b in src.blocks:
                            info = self.bm.get(b.block_id)
                            if info is not None:
                                info.inode = tgt
                                info.expected_replication = tgt.replication
                        tgt.blocks.extend(src.blocks)
                        src.blocks = []
                        self.fsdir.delete(s, recursive=False)
        elif op == el.OP_TRUNCATE:
            inode = self.fsdir.get_inode(rec["p"])
            if isinstance(inode, INodeFile):
                new_blocks = [Block.from_wire(b) for b in rec.get("b", [])]
                kept = {b.block_id for b in new_blocks}
                for old in inode.blocks:
                    if old.block_id not in kept:
                        self.bm.remove_block(old)
                inode.blocks = new_blocks
                for b in inode.blocks:
                    info = self.bm.get(b.block_id)
                    if info is not None:
                        info.block.num_bytes = b.num_bytes
        elif op == el.OP_SET_GENSTAMP:
            with self._id_lock:
                self._gen_stamp = max(self._gen_stamp, rec["gs"])
        else:
            log.warning("Unknown edit op %r (txid %d) — skipped", op, rec["t"])
