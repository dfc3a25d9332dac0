"""Write-ahead edit log with batched group-commit sync.

The port's copy of ``hadoop_tpu/dfs/namenode/editlog.py``, on the same
wire and disk formats.

Parity with the reference's journal (ref: server/namenode/FSEditLog.java
(1,888 LoC), :646/:651 logSync; EditLogFileOutputStream.java,
FSEditLogLoader.java): every namespace mutation appends a transaction under
the namesystem lock, then the caller invokes ``log_sync()`` *outside* the
lock; syncs are batched — one fsync covers every txid appended since the last
sync (the group-commit that makes metadata throughput scale with concurrency).

Storage layout (per journal directory):
    edits_inprogress_<first_txid>      — active segment
    edits_<first_txid>-<last_txid>     — finalized segments
    seen_txid                          — highest txid durably begun

Record format: u32-framed wirepack dicts ``{"t": txid, "op": name, ...}``.
A torn tail (partial frame after crash) is truncated on replay, as the
reference's loader tolerates (FSEditLogLoader recovery mode).

Pluggable JournalManager seam: the default writes one local directory; the
quorum journal (qjournal.py) plugs in here the way QuorumJournalManager does.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
from typing import Any, Dict, Iterator, List, Optional

from hadoop_tpu_torch.io.wire import pack, unpack
from hadoop_tpu_torch.metrics import metrics_system

log = logging.getLogger(__name__)

# Edit-log op codes (ref: FSEditLogOpCodes.java)
OP_ADD = "add"                # create file (under construction) + lease
OP_ADD_BLOCK = "add_block"    # allocate next block
OP_UPDATE_BLOCKS = "update_blocks"  # pipeline recovery rewrote block list
OP_CLOSE = "close"            # complete file (finalize blocks + lengths)
OP_MKDIR = "mkdir"
OP_DELETE = "delete"
OP_RENAME = "rename"
OP_SET_REPLICATION = "set_replication"
OP_SET_PERMISSION = "set_permission"
OP_SET_OWNER = "set_owner"
OP_SET_TIMES = "set_times"
OP_SET_QUOTA = "set_quota"
OP_CONCAT = "concat"
OP_TRUNCATE = "truncate"
OP_SYMLINK = "symlink"
OP_REASSIGN_LEASE = "reassign_lease"
OP_SET_GENSTAMP = "set_genstamp"
OP_PROVIDED_FILE = "provided_file"  # fs2img: external file mounted
OP_SET_XATTR = "set_xattr"
OP_REMOVE_XATTR = "remove_xattr"
OP_SET_ACL = "set_acl"
OP_CREATE_SNAPSHOT = "create_snapshot"
OP_DELETE_SNAPSHOT = "delete_snapshot"
OP_RENAME_SNAPSHOT = "rename_snapshot"
OP_ALLOW_SNAPSHOT = "allow_snapshot"
OP_DISALLOW_SNAPSHOT = "disallow_snapshot"
OP_SET_STORAGE_POLICY = "set_storage_policy"
OP_SET_EC_POLICY = "set_ec_policy"
OP_ADD_CACHE_DIRECTIVE = "add_cache_directive"
OP_REMOVE_CACHE_DIRECTIVE = "remove_cache_directive"


class EditLogFaultInjector:
    """Overridable fault point at the edit-log group-commit boundary (ref:
    the reference's injector-singleton pattern — CheckpointFaultInjector
    .java / JournalFaultInjector.java). ``before_sync`` raising simulates
    journal IO failure at exactly the durability point."""

    _instance: "EditLogFaultInjector" = None  # type: ignore[assignment]

    @classmethod
    def get(cls) -> "EditLogFaultInjector":
        if cls._instance is None:
            cls._instance = EditLogFaultInjector()
        return cls._instance

    @classmethod
    def set(cls, inst) -> None:
        cls._instance = inst

    def before_sync(self, txid: int) -> None: ...


class JournalManager:
    """Seam for pluggable journals (local dir / quorum).
    Ref: server/namenode/JournalManager.java."""

    def start_segment(self, first_txid: int) -> None: ...
    def journal(self, records: bytes, first_txid: int, count: int) -> None: ...
    def sync(self) -> None: ...
    def finalize_segment(self, first_txid: int, last_txid: int) -> None: ...
    def discard_inprogress(self, first_txid: int) -> None: ...
    def read_edits(self, from_txid: int) -> Iterator[Dict]: ...
    def write_seen_txid(self, txid: int) -> None: ...
    def read_seen_txid(self) -> int: ...
    def close(self) -> None: ...


class FileJournalManager(JournalManager):
    """One local journal directory. Ref: server/namenode/FileJournalManager.java."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._f = None
        self._inprogress_first: Optional[int] = None

    # ------------------------------------------------------------- writing

    def start_segment(self, first_txid: int) -> None:
        assert self._f is None, "segment already open"
        path = os.path.join(self.dir, f"edits_inprogress_{first_txid}")
        if os.path.exists(path):
            # Crash recovery: a torn partial frame at the tail must be
            # physically truncated before appending, or edits written after
            # it would be unreachable on the next replay (the reader stops
            # at the first bad frame). Ref: EditLogFileOutputStream recovery
            # + FSEditLogLoader recovery mode.
            valid = _valid_prefix_len(path)
            if valid < os.path.getsize(path):
                log.warning("Truncating torn edit segment %s from %d to %d "
                            "bytes", path, os.path.getsize(path), valid)
                with open(path, "r+b") as f:
                    f.truncate(valid)
        self._f = open(path, "ab")
        self._inprogress_first = first_txid

    def journal(self, records: bytes, first_txid: int, count: int) -> None:
        self._f.write(records)

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())

    def finalize_segment(self, first_txid: int, last_txid: int) -> None:
        assert self._inprogress_first == first_txid
        self._f.close()
        self._f = None
        src = os.path.join(self.dir, f"edits_inprogress_{first_txid}")
        dst = os.path.join(self.dir, f"edits_{first_txid}-{last_txid}")
        os.rename(src, dst)
        self._inprogress_first = None

    def discard_inprogress(self, first_txid: int) -> None:
        self.close()
        p = os.path.join(self.dir, f"edits_inprogress_{first_txid}")
        if os.path.exists(p):
            os.remove(p)

    def write_seen_txid(self, txid: int) -> None:
        tmp = os.path.join(self.dir, "seen_txid.tmp")
        with open(tmp, "w") as f:
            f.write(str(txid))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.dir, "seen_txid"))

    def read_seen_txid(self) -> int:
        p = os.path.join(self.dir, "seen_txid")
        if not os.path.exists(p):
            return 0
        with open(p) as f:
            return int(f.read().strip() or 0)

    # ------------------------------------------------------------- reading

    def segments(self) -> List[tuple]:
        """Sorted (first_txid, last_txid_or_None, path)."""
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("edits_inprogress_"):
                out.append((int(name.rsplit("_", 1)[1]), None,
                            os.path.join(self.dir, name)))
            elif name.startswith("edits_") and "-" in name:
                rng = name[len("edits_"):]
                first, last = rng.split("-")
                out.append((int(first), int(last),
                            os.path.join(self.dir, name)))
        return sorted(out)

    def read_edits(self, from_txid: int) -> Iterator[Dict]:
        for first, last, path in self.segments():
            if last is not None and last < from_txid:
                continue
            yield from _read_segment_file(path, from_txid)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


def _valid_prefix_len(path: str) -> int:
    """Byte length of the longest prefix of whole, decodable frames."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    n = len(data)
    while n - off >= 4:
        (flen,) = struct.unpack_from(">I", data, off)
        if n - off - 4 < flen:
            break
        try:
            unpack(data[off + 4: off + 4 + flen])
        except Exception:
            break
        off += 4 + flen
    return off


def _read_segment_file(path: str, from_txid: int) -> Iterator[Dict]:
    """Frame-by-frame read tolerating a torn tail (crash mid-write)."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    n = len(data)
    while n - off >= 4:
        (flen,) = struct.unpack_from(">I", data, off)
        if n - off - 4 < flen:
            break  # torn tail — ignore, as recovery does
        try:
            rec = unpack(data[off + 4: off + 4 + flen])
        except Exception:  # torn/corrupt tail
            break
        off += 4 + flen
        if rec.get("t", 0) >= from_txid:
            yield rec


class FSEditLog:
    """Transaction log with group commit. Ref: FSEditLog.java.

    Usage (mirrors the reference's discipline):
        with namesystem write lock:
            txid = editlog.log_edit(OP_MKDIR, {"path": ...})
        # lock released
        editlog.log_sync(txid)        # batched fsync up to >= txid
    """

    def __init__(self, journal: JournalManager):
        self.journal = journal
        self._lock = threading.Lock()        # append ordering
        self._sync_lock = threading.Lock()   # one syncer at a time
        self._cond = threading.Condition(self._lock)
        self._txid = 0
        self._synced_txid = 0
        self._buf = bytearray()              # appended, not yet written
        self._buf_first_txid: Optional[int] = None
        self._buf_count = 0
        self._segment_first: Optional[int] = None
        self._open = False
        reg = metrics_system().source("namenode.editlog")
        self._m_txns = reg.counter("transactions")
        self._m_syncs = reg.counter("syncs")
        self._m_sync_time = reg.rate("sync")
        self._m_batched = reg.counter("transactions_batched_in_sync")

    # ------------------------------------------------------------ lifecycle

    def open_for_write(self, last_loaded_txid: int) -> None:
        self._txid = last_loaded_txid
        self._synced_txid = last_loaded_txid
        self._segment_first = self._txid + 1
        self.journal.start_segment(self._segment_first)
        self.journal.write_seen_txid(self._txid + 1)
        self._open = True

    def close(self) -> None:
        self.close_segment()
        self.journal.close()

    def close_segment(self) -> None:
        """Flush + finalize the open segment WITHOUT closing the journal
        manager — demotion to standby keeps tailing through the same
        QuorumJournalManager (ref: FSEditLog.close vs. the standby's
        continued use of the shared journal)."""
        if not self._open:
            return
        # _sync_lock serializes against concurrent log_sync; the internal
        # flush covers any buffered edits. A log_edit racing close() would be
        # a namesystem bug (mutations after shutdown), not an editlog one.
        with self._sync_lock:
            last = self._flush_and_sync_locked()
            first = self._segment_first
            self._open = False
            if first is not None and last >= first:
                self.journal.finalize_segment(first, last)

    def roll(self) -> int:
        """Finalize the current segment and start a new one (checkpointing
        boundary). Ref: FSEditLog.rollEditLog. Returns first txid of the new
        segment.

        Holds _sync_lock across flush + finalize + restart so a concurrent
        log_sync can neither write into a closing segment nor observe the
        journal handle mid-swap; the txid boundary is captured atomically
        with the buffer drain, so every txid <= boundary is in the finalized
        segment and every later txid lands in the new one."""
        with self._sync_lock:
            last = self._flush_and_sync_locked()
            first = self._segment_first
            new_first = last + 1
            self._segment_first = new_first
            if last >= first:
                self.journal.finalize_segment(first, last)
            else:
                # Empty in-progress segment: remove and restart.
                self.journal.discard_inprogress(first)
            self.journal.start_segment(new_first)
            self.journal.write_seen_txid(new_first)
            return new_first

    # -------------------------------------------------------------- logging

    @property
    def last_txid(self) -> int:
        return self._txid

    @property
    def synced_txid(self) -> int:
        return self._synced_txid

    def log_edit(self, op: str, payload: Dict[str, Any]) -> int:
        """Append one transaction to the in-memory buffer; returns its txid.
        Called under the namesystem write lock (ordering guarantee)."""
        assert self._open, "edit log not open"
        rec = dict(payload)
        with self._lock:
            self._txid += 1
            rec["t"] = self._txid
            rec["op"] = op
            data = pack(rec)
            self._buf += struct.pack(">I", len(data)) + data
            if self._buf_first_txid is None:
                self._buf_first_txid = self._txid
            self._buf_count += 1
            self._m_txns.incr()
            return self._txid

    def log_sync(self, txid: Optional[int] = None) -> None:
        """Group commit: returns once txid (default: latest) is durable.
        Ref: FSEditLog.logSync:646 — the double-checked batching dance."""
        if txid is None:
            txid = self._txid
        if self._synced_txid >= txid:
            return
        with self._sync_lock:
            # Re-check: a concurrent syncer may have covered us while we
            # waited for the sync lock — that's the batching win.
            if self._synced_txid >= txid:
                return
            self._flush_and_sync_locked()

    def _flush_and_sync_locked(self) -> int:
        """Drain the buffer + fsync. Caller holds _sync_lock. Returns the
        txid boundary covered (atomic with the buffer capture)."""
        EditLogFaultInjector.get().before_sync(self._txid)
        with self._lock:
            buf = bytes(self._buf)
            first = self._buf_first_txid
            count = self._buf_count
            sync_to = self._txid
            self._buf = bytearray()
            self._buf_first_txid = None
            self._buf_count = 0
        if buf:
            self.journal.journal(buf, first, count)
        if self._open:
            with self._m_sync_time.time():
                self.journal.sync()
        self._synced_txid = sync_to
        self._m_syncs.incr()
        if count > 1:
            self._m_batched.incr(count - 1)
        return sync_to
