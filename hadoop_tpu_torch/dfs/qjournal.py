"""Quorum journal: JournalNode daemons + QuorumJournalManager client.

The port's copy of ``hadoop_tpu/dfs/qjournal.py``, on the same RPCs
(``JournalProtocol``), segment files, ``epoch``, ``segment_epochs`` and
``committed_txid`` files, so a quorum may mix either package's
JournalNodes and either package's writers. A reference JournalNode's
``FencedError`` comes back to the port as the port's (registered under
its bare name as well).

Parity with the reference's QJM (ref: hadoop-hdfs qjournal/server/
Journal.java, JournalNode.java, JournalNodeRpcServer.java; client
qjournal/client/QuorumJournalManager.java, AsyncLoggerSet): the edit log
is replicated to N journal daemons and a write is durable once a majority
acks it. Writer exclusivity is epoch-fenced: becoming the writer bumps an
epoch on a quorum (``new_epoch``), and every journal RPC carries it — a
deposed writer's appends are rejected, which is the split-brain guard
(ref: Journal.checkRequest's epoch validation).

Recovery on writer takeover follows the reference's prepare/accept shape
(ref: QuorumJournalManager.recoverUnfinalizedSegments, Journal
.prepareRecovery/.acceptRecovery): ``new_epoch`` collects each JN's tail
state *including the writer epoch of its latest segment*; the recovering
writer adopts the tail of the highest-epoch (then longest) responder,
reconstructs the committed suffix by a union read that prefers
higher-epoch record content, and then — the accept phase — rewrites every
responding JN's unfinalized tail to exactly the adopted state (dropping
stale in-progress segments from deposed writers) before the log opens for
write. Any txid acked to a client lived on a majority, so the adopted
tail always contains it; after accept, the adopted tail itself lives on a
majority, so tailing readers can always reach it.

The JournalNodes double as the failover lock service: a lease named
``active`` granted by a majority elects the active NameNode (the ZKFC/
ZooKeeper analog — ref: ha/ActiveStandbyElector.java — reimagined on the
quorum that already exists instead of an external ensemble).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.namenode.editlog import (FileJournalManager,
                                             JournalManager)
from hadoop_tpu_torch.ipc import Client, Server, get_proxy, idempotent
from hadoop_tpu_torch.ipc.errors import (RpcError, StandbyError,
                                         register_exception)
from hadoop_tpu_torch.service import AbstractService

log = logging.getLogger(__name__)


@register_exception
class FencedError(IOError):
    """Request carried a stale epoch — the caller has been superseded.
    Ref: qjournal JournalOutOfSyncException / IOException('epoch ...')."""


register_exception(FencedError, FencedError.__name__)


class JournalFaultInjector:
    """Overridable fault points compiled into the JN main path, the way
    the reference does it (ref: qjournal/server/JournalFaultInjector.java
    — injectors are singletons tests subclass). Hooks raise to simulate
    IO failure at the exact point; default is a no-op."""

    _instance: "JournalFaultInjector" = None  # type: ignore[assignment]

    @classmethod
    def get(cls) -> "JournalFaultInjector":
        if cls._instance is None:
            cls._instance = JournalFaultInjector()
        return cls._instance

    @classmethod
    def set(cls, inst) -> None:
        cls._instance = inst

    # ---- hooks (no-ops by default); jn_port identifies WHICH node ----
    def before_journal(self, jn_port: int, first_txid: int) -> None: ...
    def before_finalize(self, jn_port: int, first_txid: int) -> None: ...
    def before_accept(self, jn_port: int, first_txid: int) -> None: ...
    def before_start_segment(self, jn_port: int, first_txid: int) -> None:
        ...


class _Journal:
    """One journal's state on a JournalNode. Ref: qjournal/server/Journal
    .java — promised/writer epochs are durable so fencing survives
    restarts."""

    def __init__(self, storage_dir: str):
        self.fjm = FileJournalManager(storage_dir)
        self._epoch_file = os.path.join(storage_dir, "epoch")
        self._seg_epoch_file = os.path.join(storage_dir, "segment_epochs")
        self._committed_file = os.path.join(storage_dir, "committed_txid")
        self.promised_epoch = self._load_epoch()
        self.writer_epoch = 0
        self.segment_epochs = self._load_segment_epochs()
        self.last_txid = self._scan_last_txid()
        self.committed_txid = self._load_committed()
        self.lock = threading.Lock()

    def _load_committed(self) -> int:
        try:
            with open(self._committed_file) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def update_committed(self, txid: int) -> None:
        """Advance the known quorum-commit point (monotonic). Best-effort
        durable like the reference's BestEffortLongFile-backed
        committedTxnId — losing it is safe (reads just stall until the
        next writer sync/recovery re-teaches it), an fsync per batch here
        would double the sync cost for no correctness gain."""
        if txid <= self.committed_txid:
            return
        self.committed_txid = txid
        try:
            with open(self._committed_file, "w") as f:
                f.write(str(txid))
        except OSError:
            pass

    def _load_epoch(self) -> int:
        try:
            with open(self._epoch_file) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def persist_epoch(self, epoch: int) -> None:
        tmp = self._epoch_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(epoch))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._epoch_file)
        self.promised_epoch = epoch

    def _load_segment_epochs(self) -> Dict[int, int]:
        """first_txid → writer epoch of that segment. Ref: the per-segment
        lastWriterEpoch the reference persists in its paxos metadata dir
        (Journal.java PersistedRecoveryPaxosData)."""
        try:
            with open(self._seg_epoch_file) as f:
                return {int(k): int(v) for k, v in
                        (ln.split() for ln in f if ln.strip())}
        except (OSError, ValueError):
            return {}

    def record_segment_epoch(self, first_txid: int, epoch: int) -> None:
        self.segment_epochs[first_txid] = epoch
        # Drop entries for segments no longer on disk.
        firsts = {s[0] for s in self.fjm.segments()} | {first_txid}
        self.segment_epochs = {k: v for k, v in self.segment_epochs.items()
                               if k in firsts}
        tmp = self._seg_epoch_file + ".tmp"
        with open(tmp, "w") as f:
            for k, v in sorted(self.segment_epochs.items()):
                f.write(f"{k} {v}\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._seg_epoch_file)

    def _scan_last_txid(self) -> int:
        last = 0
        for rec in self.fjm.read_edits(1):
            if rec["t"] > last:
                last = rec["t"]
        return last

    def contiguous_finalized_tail(self) -> int:
        """Highest txid C such that FINALIZED segments cover [1..C] with no
        hole. Everything past C is replaceable during recovery's accept
        phase (finalized data is quorum-committed; in-progress data is
        not)."""
        c = 0
        for first, last, _path in self.fjm.segments():
            if last is None:
                continue
            if first > c + 1:
                break  # hole — a skipped segment this JN never received
            c = max(c, last)
        return c

    def tail_epoch(self) -> int:
        """Writer epoch of the latest segment on disk (0 if none)."""
        segs = self.fjm.segments()
        if not segs:
            return 0
        return self.segment_epochs.get(segs[-1][0], 0)

    def check_epoch(self, epoch: int) -> None:
        if epoch < self.promised_epoch:
            raise FencedError(
                f"epoch {epoch} < promised {self.promised_epoch}")


class JournalProtocol:
    """RPC surface of a JournalNode. Ref: qjournal/protocol/
    QJournalProtocol.java."""

    def __init__(self, node: "JournalNode"):
        self.node = node

    def _journal(self, jid: str) -> _Journal:
        return self.node.get_journal(jid)

    @idempotent
    def get_state(self, jid: str) -> Dict:
        j = self._journal(jid)
        with j.lock:
            return {"promised": j.promised_epoch, "last_txid": j.last_txid}

    def new_epoch(self, jid: str, epoch: int) -> Dict:
        """Promise the epoch (if newer); returns this JN's tail state —
        last txid seen, the contiguous finalized prefix end, and the writer
        epoch of its latest segment. Ref: Journal.newEpoch +
        getJournalState/prepareRecovery's segment state."""
        j = self._journal(jid)
        with j.lock:
            if epoch <= j.promised_epoch:
                raise FencedError(
                    f"epoch {epoch} <= promised {j.promised_epoch}")
            j.persist_epoch(epoch)
            # A segment left open by the deposed writer stays on disk; the
            # recovering writer rewrites/finalizes through accept_tail.
            j.fjm.close()
            return {"last_txid": j.last_txid,
                    "ctail": j.contiguous_finalized_tail(),
                    "tail_epoch": j.tail_epoch(),
                    # the writer-taught quorum commit point: recovery's
                    # adoption floor (a responder missing committed txids
                    # must never be the adopted tail)
                    "committed": j.committed_txid}

    def start_segment(self, jid: str, epoch: int, first_txid: int) -> bool:
        j = self._journal(jid)
        with j.lock:
            j.check_epoch(epoch)
            JournalFaultInjector.get().before_start_segment(
                self.node.port, first_txid)
            if 0 < j.last_txid < first_txid - 1:
                # This JN missed txids (e.g. its recovery accept failed):
                # opening the new segment here would stamp its tail with
                # the NEWEST epoch while holding the OLDEST data, making
                # it outrank complete JNs at the next recovery's adoption
                # and destroy committed edits. Refuse; the writer's
                # quorum doesn't need us, and a later accept will resync.
                raise IOError(
                    f"refusing gap: segment {first_txid} after local "
                    f"last {j.last_txid}")
            j.writer_epoch = epoch
            j.fjm.close()
            # Drop any stale in-progress segment at this boundary — the new
            # writer's stream replaces it.
            p = os.path.join(j.fjm.dir, f"edits_inprogress_{first_txid}")
            if os.path.exists(p):
                os.remove(p)
            j.fjm.start_segment(first_txid)
            j.record_segment_epoch(first_txid, epoch)
            return True

    def accept_tail(self, jid: str, epoch: int, first_txid: int,
                    records: bytes, count: int, last_txid: int) -> bool:
        """Recovery accept phase (ref: Journal.acceptRecovery): replace
        everything past this JN's committed prefix with the adopted tail.
        Drops ALL segments at/after ``first_txid`` (stale in-progress
        writes from deposed writers, holed finalized segments) and writes
        the adopted records as one finalized segment stamped with the
        recovery epoch. Idempotent: re-accepting the same tail is a no-op
        rewrite."""
        j = self._journal(jid)
        with j.lock:
            j.check_epoch(epoch)
            JournalFaultInjector.get().before_accept(
                self.node.port, first_txid)
            j.fjm.close()
            for first, last, path in j.fjm.segments():
                # Drop everything past the committed prefix AND any
                # in-progress segment wherever it starts — post-accept, a
                # JN holds only finalized, adopted data.
                if first >= first_txid or last is None:
                    os.remove(path)
                    j.segment_epochs.pop(first, None)
            if last_txid >= first_txid:
                if count != last_txid - first_txid + 1:
                    raise IOError(
                        f"accept_tail record count {count} does not cover "
                        f"[{first_txid}, {last_txid}]")
                j.fjm.start_segment(first_txid)
                j.fjm.journal(records, first_txid, count)
                j.fjm.sync()
                j.fjm.finalize_segment(first_txid, last_txid)
                j.record_segment_epoch(first_txid, epoch)
            j.last_txid = j._scan_last_txid()
            # NOTE: committed_txid is deliberately NOT advanced here — the
            # adopted tail is only committed once a MAJORITY has accepted
            # it. The writer teaches the commit point via commit_point()
            # after its accept round succeeds (a lone accepted JN must not
            # feed still-uncommitted txids to tailers through the commit
            # gate if the rest of the round tears).
            return True

    def commit_point(self, jid: str, epoch: int, txid: int) -> bool:
        """Writer-taught quorum commit point (ref: the committedTxnId
        piggyback; sent explicitly after recovery's accept round and after
        quorum-acked syncs)."""
        j = self._journal(jid)
        with j.lock:
            j.check_epoch(epoch)
            j.update_committed(txid)
            return True

    def journal(self, jid: str, epoch: int, records: bytes,
                first_txid: int, count: int, last_txid: int,
                committed_txid: int = 0) -> bool:
        """Append + fsync one batch. The JN always syncs — quorum ack means
        durable on a majority (ref: Journal.journal's sync). The writer
        piggybacks its commit point (highest quorum-acked txid) the way
        the reference piggybacks committedTxnId on every journal RPC."""
        j = self._journal(jid)
        with j.lock:
            j.check_epoch(epoch)
            JournalFaultInjector.get().before_journal(
                self.node.port, first_txid)
            j.fjm.journal(records, first_txid, count)
            j.fjm.sync()
            if last_txid > j.last_txid:
                j.last_txid = last_txid
            j.update_committed(committed_txid)
            return True

    def finalize_segment(self, jid: str, epoch: int, first_txid: int,
                         last_txid: int) -> bool:
        j = self._journal(jid)
        with j.lock:
            j.check_epoch(epoch)
            JournalFaultInjector.get().before_finalize(
                self.node.port, first_txid)
            j.fjm.finalize_segment(first_txid, last_txid)
            # A writer only finalizes a fully quorum-synced segment.
            j.update_committed(last_txid)
            return True

    def discard_inprogress(self, jid: str, epoch: int,
                           first_txid: int) -> bool:
        j = self._journal(jid)
        with j.lock:
            j.check_epoch(epoch)
            j.fjm.close()
            p = os.path.join(j.fjm.dir, f"edits_inprogress_{first_txid}")
            if os.path.exists(p):
                os.remove(p)
            return True

    @idempotent
    def get_edits(self, jid: str, from_txid: int,
                  max_count: int = 50_000) -> Dict:
        """Serve edits for standby tailing / recovery (ref:
        Journal.getJournaledEdits + JournaledEditsCache). Returns
        ``{"records": [...], "committed": <this JN's known commit point>}``.
        Each record is annotated with ``"_e"`` — the writer epoch of the
        segment it came from — so quorum readers can prefer the newest
        writer's content for a txid over a deposed writer's stale copy
        (the role the reference's per-segment lastWriterEpoch plays in
        recovery). Tailing readers must additionally gate on ``committed``
        — records past the quorum commit point may be uncommitted
        proposals (recovery reads them; tailers must not apply them)."""
        j = self._journal(jid)
        from hadoop_tpu_torch.dfs.namenode.editlog import _read_segment_file
        best: Dict[int, Dict] = {}
        for first, last, path in j.fjm.segments():
            if last is not None and last < from_txid:
                continue
            if len(best) >= max_count and first > max(best):
                break  # later segments only add txids past the cap window
            epoch = j.segment_epochs.get(first, 0)
            for rec in _read_segment_file(path, from_txid):
                t = rec["t"]
                # The same txid can exist twice on one JN: a retried quorum
                # batch re-appended it (same content — writers are single-
                # stream, so same-epoch copies are identical), or a stale
                # segment from a deposed writer overlaps a newer one
                # (divergent content). Higher segment epoch wins.
                cur = best.get(t)
                if cur is None or epoch > cur["_e"]:
                    rec = dict(rec)
                    rec["_e"] = epoch
                    best[t] = rec
        return {"records": [best[t] for t in sorted(best)[:max_count]],
                "committed": j.committed_txid}

    # ------------------------------------------------- active-lease service

    @idempotent
    def acquire_lease(self, name: str, holder: str, ttl_s: float) -> Dict:
        """Grant/renew if free, expired, or already held by ``holder``."""
        return self.node.acquire_lease(name, holder, ttl_s)

    def release_lease(self, name: str, holder: str) -> bool:
        return self.node.release_lease(name, holder)


class JournalNode(AbstractService):
    """The daemon. Ref: qjournal/server/JournalNode.java."""

    def __init__(self, conf: Configuration, storage_dir: Optional[str] = None):
        super().__init__("JournalNode")
        self.storage_dir = storage_dir or conf.get(
            "dfs.journalnode.edits.dir", "/tmp/htpu-journal")
        self._journals: Dict[str, _Journal] = {}
        self._jlock = threading.Lock()
        self._leases: Dict[str, Tuple[str, float]] = {}  # name → (holder, exp)
        self._lease_lock = threading.Lock()
        self.rpc: Optional[Server] = None

    @property
    def port(self) -> int:
        return self.rpc.port

    def get_journal(self, jid: str) -> _Journal:
        with self._jlock:
            j = self._journals.get(jid)
            if j is None:
                j = _Journal(os.path.join(self.storage_dir, jid))
                self._journals[jid] = j
            return j

    def acquire_lease(self, name: str, holder: str, ttl_s: float) -> Dict:
        now = time.monotonic()
        with self._lease_lock:
            cur = self._leases.get(name)
            if cur is None or cur[1] < now or cur[0] == holder:
                self._leases[name] = (holder, now + ttl_s)
                return {"granted": True, "holder": holder}
            return {"granted": False, "holder": cur[0]}

    def release_lease(self, name: str, holder: str) -> bool:
        with self._lease_lock:
            if self._leases.get(name, ("", 0))[0] == holder:
                del self._leases[name]
                return True
            return False

    def service_init(self, conf: Configuration) -> None:
        os.makedirs(self.storage_dir, exist_ok=True)
        self.rpc = Server(
            conf, bind=("127.0.0.1",
                        conf.get_int("dfs.journalnode.rpc-port", 0)),
            num_handlers=conf.get_int("dfs.journalnode.handler.count", 4),
            name="journalnode")
        self.rpc.register_protocol("JournalProtocol", JournalProtocol(self))

    def service_start(self) -> None:
        self.rpc.start()
        log.info("JournalNode up at 127.0.0.1:%d (%s)", self.rpc.port,
                 self.storage_dir)

    def service_stop(self) -> None:
        if self.rpc:
            self.rpc.stop()


# ======================================================================
# Client side
# ======================================================================

def _journal_proxies(addrs, client) -> list:
    """One stub a JournalNode, making one attempt a call as the
    reference's stubs do (ROADMAP C 25): the quorum math takes a down
    JournalNode's refusal. The port's ``RpcProxy`` retries a refused
    call three times with backoff by default, which made every edit
    sync wait 0.35-1 s while one JournalNode was down, and kept the
    NameNode's handlers from DataNode heartbeats."""
    return [get_proxy("JournalProtocol", a, client=client, max_retries=0)
            for a in addrs]


class QuorumJournalManager(JournalManager):
    """Journal manager writing to a JN quorum. Plugs into FSEditLog via the
    JournalManager seam (ref: QuorumJournalManager.java + AsyncLoggerSet).

    ``recover()`` must run (after winning election) before
    ``FSEditLog.open_for_write``; it fences prior writers and repairs the
    shared log to a consistent finalized tail.
    """

    def __init__(self, addrs: List[Tuple[str, int]], jid: str = "ns",
                 conf: Optional[Configuration] = None,
                 on_fenced: Optional[Callable[[FencedError], None]] = None):
        self.addrs = list(addrs)
        self.jid = jid
        self.conf = conf or Configuration()
        # the NameNode's step-down when the quorum refuses a sync
        # (ROADMAP C 24); without it the FencedError reaches the caller
        self.on_fenced = on_fenced
        self.epoch = 0
        self._client = Client(self.conf)
        self._proxies = _journal_proxies(self.addrs, self._client)
        self._pool = ThreadPoolExecutor(
            max_workers=len(self.addrs), thread_name_prefix="qjm")
        self._seen_txid = 0
        self._segment_first: Optional[int] = None
        self._last_txid = 0
        self._buf = bytearray()
        self._buf_first: Optional[int] = None
        self._buf_count = 0
        self._buf_last = 0
        self._committed = 0         # highest quorum-acked txid
        self._fetch_batch = 50_000  # per-get_edits cap (tests shrink it)

    @property
    def majority(self) -> int:
        return len(self.addrs) // 2 + 1

    # ---------------------------------------------------------- quorum call

    def _call_all(self, method: str, *args) -> List[Tuple[int, object]]:
        """Invoke on every JN in parallel; returns [(index, result|exc)]."""
        futs = {i: self._pool.submit(getattr(p, method), *args)
                for i, p in enumerate(self._proxies)}
        out: List[Tuple[int, object]] = []
        for i, f in futs.items():
            try:
                out.append((i, f.result(timeout=15.0)))
            except Exception as e:  # noqa: BLE001 — quorum math handles it
                out.append((i, e))
        return out

    def _quorum(self, method: str, *args) -> List[Tuple[int, object]]:
        """Like _call_all but raises unless a majority succeeded. A fencing
        rejection from ANY node aborts immediately — this writer is stale."""
        results = self._call_all(method, *args)
        good = [(i, r) for i, r in results if not isinstance(r, Exception)]
        for _, r in results:
            if isinstance(r, Exception) and "FencedError" in type(r).__name__:
                raise r
            if isinstance(r, Exception) and "epoch" in str(r) and \
                    "promised" in str(r):
                raise FencedError(str(r))
        if len(good) < self.majority:
            errs = [f"{self.addrs[i]}: {r}" for i, r in results
                    if isinstance(r, Exception)]
            raise IOError(
                f"quorum {method} failed ({len(good)}/{len(self.addrs)} ok): "
                f"{errs}")
        return good

    # ------------------------------------------------------------- recovery

    def recover(self) -> int:
        """Fence prior writers and repair the shared log; returns the last
        committed txid. Ref: QuorumJournalManager.recoverUnfinalizedSegments
        (prepareRecovery/acceptRecovery).

        Three phases:
        1. **Prepare** — ``new_epoch`` on a quorum fences older writers and
           collects each responder's tail state (last txid, contiguous
           finalized prefix, tail-segment writer epoch).
        2. **Adopt** — the tail of the responder whose latest segment has
           the highest writer epoch (ties: longest) is the recovered log.
           Its content for [min_ctail+1 .. last] is reconstructed by a
           union read over all responders, preferring the record written
           at the highest epoch for each txid (a lone stale copy from a
           deposed writer always loses to the rewrite that superseded it).
        3. **Accept** — every responding JN's unfinalized tail is rewritten
           to exactly the adopted records and finalized; stale in-progress
           segments are dropped. This must succeed on a majority, which
           guarantees later quorum reads can serve the whole adopted tail
           even if the original best responder dies.
        """
        states = self._quorum("get_state", self.jid)
        max_promised = max(r["promised"] for _, r in states)
        self.epoch = max_promised + 1
        acks = self._quorum("new_epoch", self.jid, self.epoch)
        # Adoption floor: no responder that is MISSING quorum-committed
        # txids may define the recovered tail, whatever its tail epoch —
        # a JN can carry a newer-epoch stamp with older data (its accept
        # failed, or it rejoined late), and adopting it would truncate
        # client-acked edits on its peers. Any quorum intersects the
        # majority that acked those commits, so an eligible responder
        # always exists; an empty eligible set means storage corruption
        # and must abort rather than "recover" by destroying data.
        floor = max(r.get("committed", 0) for _, r in acks)
        eligible = [(i, r) for i, r in acks if r["last_txid"] >= floor]
        if not eligible:
            raise IOError(
                f"no recovery candidate holds the committed txid {floor} "
                f"(tails: {[(self.addrs[i], r['last_txid']) for i, r in acks]})")
        best_i, best = max(
            eligible, key=lambda t: (t[1]["tail_epoch"], t[1]["last_txid"]))
        last = best["last_txid"]
        self._last_txid = last
        self._seen_txid = last
        if last > 0:
            self._accept_phase(best_i, acks, last)
        self._committed = last
        return last

    def _fetch_edits(self, proxy, from_txid: int, through: int) -> List[Dict]:
        """Fetch [from_txid..through] from one JN, looping past the
        per-call cap. Stops early if the JN has a gap/short tail."""
        out: List[Dict] = []
        nxt = from_txid
        while nxt <= through:
            batch = proxy.get_edits(self.jid, nxt, self._fetch_batch)
            batch = [r for r in batch["records"]
                     if nxt <= r["t"] <= through]
            if not batch:
                break
            out.extend(batch)
            top = max(r["t"] for r in batch)
            if top < nxt:  # defensive: no forward progress
                break
            nxt = top + 1
        return out

    def _accept_phase(self, best_i: int, acks, last: int) -> None:
        """Rewrite every responder's unfinalized tail to the adopted log
        (ref: Journal.acceptRecovery + JournalNodeSyncer, driven by the
        recovering writer). Raises unless a majority accepted — a torn
        accept would let a later reader observe a tail the quorum cannot
        serve.

        The adopted content for each txid is the highest-writer-epoch copy
        among responders (a deposed writer's stale copy always loses to
        the rewrite that superseded it; same-epoch copies are identical
        because a writer is single-stream). Fetching is two-phase to keep
        a fresh/empty JN from forcing a full-log pull from everyone: the
        optimistic pass reads the full suffix only from the adopted best
        responder and just each responder's own unfinalized tail from the
        rest; if that leaves holes (the best responder itself had a gap),
        a full-range pass over all responders fills them before giving up."""
        import struct as _struct
        from hadoop_tpu_torch.io.wire import pack
        min_ctail = min(st["ctail"] for _i, st in acks)

        def merge(into: Dict[int, Dict], recs: List[Dict]) -> None:
            for rec in recs:
                cur = into.get(rec["t"])
                if cur is None or rec.get("_e", 0) > cur.get("_e", 0):
                    into[rec["t"]] = rec

        union: Dict[int, Dict] = {}
        best_recs: List[Dict] = []
        for i, st in acks:
            frm = min_ctail + 1 if i == best_i else st["ctail"] + 1
            try:
                recs = self._fetch_edits(self._proxies[i], frm, last)
            except Exception as e:
                # Abort, don't degrade: every ack-er is a potential sole
                # holder of a committed txid's adopted-content copy. If
                # its read fails, a lower-epoch stale copy from another
                # responder could silently win the union and be rewritten
                # onto the quorum — destroying a client-acked edit. The
                # failover controller retries recovery from scratch.
                raise IOError(
                    f"recovery union read from JN {self.addrs[i]} failed: "
                    f"{e}") from e
            if i == best_i:
                best_recs = recs
            merge(union, recs)
        # Any txid the best responder itself could not supply (a hole in
        # its log) must be re-sought across every responder's FULL range:
        # its committed copy may sit in another JN's finalized prefix,
        # outside the restricted tail range fetched above, and a stale
        # unfinalized copy must not win the union unopposed.
        best_has = {r["t"] for r in best_recs}
        if any(t not in best_has for t in range(min_ctail + 1, last + 1)):
            for i, _st in acks:
                if i == best_i:
                    continue
                merge(union, self._fetch_edits(
                    self._proxies[i], min_ctail + 1, last))
        missing = [t for t in range(min_ctail + 1, last + 1)
                   if t not in union]
        if missing:
            raise IOError(
                f"recovery cannot reconstruct txids {missing[:10]}"
                f"{'...' if len(missing) > 10 else ''} of adopted tail "
                f"[{min_ctail + 1}..{last}] — refusing to adopt a log "
                f"with holes")
        # Pack each record once; per-JN blobs are suffix joins.
        frames: Dict[int, bytes] = {}
        for t in range(min_ctail + 1, last + 1):
            rec = {k: v for k, v in union[t].items() if k != "_e"}
            data = pack(rec)
            frames[t] = _struct.pack(">I", len(data)) + data
        ok = 0
        for i, st in acks:
            frm = st["ctail"] + 1
            try:
                blob = b"".join(frames[t] for t in range(frm, last + 1))
                self._proxies[i].accept_tail(
                    self.jid, self.epoch, frm, blob, last - frm + 1, last)
                ok += 1
            except Exception as e:  # noqa: BLE001 — majority math below
                log.warning("Recovery accept on JN %s failed: %s",
                            self.addrs[i], e)
        if ok < self.majority:
            raise IOError(
                f"recovery accept reached only {ok}/{len(self.addrs)} "
                f"journals (need {self.majority})")
        # A majority holds the adopted tail — it is now committed. Teach
        # the commit point (best-effort: the same-epoch-majority read rule
        # already covers responders this misses).
        for i, r in self._call_all("commit_point", self.jid, self.epoch,
                                   last):
            if isinstance(r, Exception):
                log.debug("commit_point to JN %s failed: %s",
                          self.addrs[i], r)

    # --------------------------------------------------- JournalManager API

    def start_segment(self, first_txid: int) -> None:
        assert self.epoch > 0, "recover() must run before writing"
        self._quorum("start_segment", self.jid, self.epoch, first_txid)
        self._segment_first = first_txid

    def journal(self, records: bytes, first_txid: int, count: int) -> None:
        self._buf += records
        if self._buf_first is None:
            self._buf_first = first_txid
        self._buf_count += count
        self._buf_last = max(self._buf_last, first_txid + count - 1)

    def sync(self) -> None:
        """The quorum commit point: the buffered batch must land on a
        majority before log_sync returns to the mutating caller. On quorum
        failure the buffer is RETAINED so a later sync retries the same
        batch — dropping it would mark in-memory mutations durable that
        never reached the journal. (JN re-appends of an already-stored
        txid are deduplicated at read time.)"""
        if not self._buf:
            return
        try:
            self._quorum("journal", self.jid, self.epoch, bytes(self._buf),
                         self._buf_first, self._buf_count, self._buf_last,
                         self._committed)
        except FencedError as e:
            if self.on_fenced is None:
                raise
            # a newer writer recovered the journal: the caller's edit
            # never committed, so its client fails over and retries on
            # the new active (the reference sends the FencedError, which
            # its client takes for the call's failure)
            self.on_fenced(e)
            raise StandbyError(
                f"fenced by a newer writer, no longer active: {e}") from e
        self._last_txid = max(self._last_txid, self._buf_last)
        # Quorum ack ⇒ this batch is committed; the commit point rides
        # the NEXT journal/finalize RPC to the JNs (ref: the piggybacked
        # committedTxnId in QJournalProtocol requests).
        self._committed = max(self._committed, self._buf_last)
        self._buf = bytearray()
        self._buf_first = None
        self._buf_count = 0

    def finalize_segment(self, first_txid: int, last_txid: int) -> None:
        self._quorum("finalize_segment", self.jid, self.epoch, first_txid,
                     last_txid)
        self._segment_first = None

    def discard_inprogress(self, first_txid: int) -> None:
        self._quorum("discard_inprogress", self.jid, self.epoch, first_txid)

    def read_edits(self, from_txid: int) -> Iterator[Dict]:
        """Serve only QUORUM-COMMITTED edits: a txid counts as committed
        when a majority of JNs hold it (every acked batch landed on a
        majority, so this is a sound commit witness). A txid present on a
        lone JN may be an abandoned write from a dead deposed writer —
        replaying it would diverge the tailer from what recovery keeps
        (ref: the committed-txn filter in getJournaledEdits / the
        maxSeenTxId vs committedTxnId distinction).

        A txid is served when EITHER (a) it is at or below the quorum
        commit point some responder reports (the writer piggybacks it;
        recovery's accept stamps it), or (b) a majority of responders hold
        it *at the chosen epoch* — durable on a majority is the commit
        criterion, and counting only same-epoch copies keeps a deposed
        writer's stale record from teaming up with an unrelated newer copy
        to fake a majority. Content is always the highest-segment-epoch
        copy: a JN that slept through a recovery and resurfaced with a
        divergent record cannot shadow the quorum's adopted copy (ref: the
        acceptRecovery rewrite that prevents this on-disk; this is the
        read-side belt to that suspender)."""
        results = self._call_all("get_edits", self.jid, from_txid)
        holders: Dict[int, int] = {}  # txid → #copies at the chosen epoch
        records: Dict[int, Dict] = {}
        committed = 0
        for _, r in results:
            if not isinstance(r, dict):
                continue
            committed = max(committed, r.get("committed", 0))
            for rec in r["records"]:
                t = rec["t"]
                cur = records.get(t)
                if cur is None or rec.get("_e", 0) > cur.get("_e", 0):
                    records[t] = rec
                    holders[t] = 1
                elif rec.get("_e", 0) == cur.get("_e", 0):
                    holders[t] += 1
        # Contiguous committed prefix from from_txid.
        t = from_txid
        while t in records and (t <= committed or
                                holders.get(t, 0) >= self.majority):
            yield {k: v for k, v in records[t].items() if k != "_e"}
            t += 1

    # seen_txid: QJM tracks it in memory; the authoritative value for
    # startup comes from the image + JN replay, so a local file is not
    # load-bearing (the reference keeps it in each storage dir).
    def write_seen_txid(self, txid: int) -> None:
        self._seen_txid = txid

    def read_seen_txid(self) -> int:
        return self._seen_txid

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self._client.stop()


class QuorumLease:
    """Majority-lease election over the JN set — the elector used for
    automatic NN failover (ref: ha/ActiveStandbyElector.java, with the JN
    quorum standing in for the ZooKeeper ensemble)."""

    def __init__(self, addrs: List[Tuple[str, int]], holder: str,
                 name: str = "active", ttl_s: float = 6.0,
                 conf: Optional[Configuration] = None):
        self.addrs = addrs
        self.holder = holder
        self.name = name
        self.ttl_s = ttl_s
        self._client = Client(conf or Configuration())
        self._proxies = _journal_proxies(addrs, self._client)
        self._pool = ThreadPoolExecutor(max_workers=len(addrs),
                                        thread_name_prefix="lease")

    @property
    def majority(self) -> int:
        return len(self.addrs) // 2 + 1

    def try_acquire(self) -> bool:
        """Acquire/renew on a majority. Not atomic across JNs — but two
        candidates can each win only disjoint minorities plus at most one
        shared grant round; the loser sees < majority and backs off, and
        journal-epoch fencing protects the data path regardless."""
        futs = [self._pool.submit(p.acquire_lease, self.name, self.holder,
                                  self.ttl_s) for p in self._proxies]
        granted = 0
        for f in futs:
            try:
                if f.result(timeout=5.0).get("granted"):
                    granted += 1
            except (RpcError, OSError, TimeoutError) as e:
                log.debug("lease grant unavailable: %s", e)
        return granted >= self.majority

    def release(self) -> None:
        futs = [self._pool.submit(p.release_lease, self.name, self.holder)
                for p in self._proxies]
        for f in futs:
            try:
                f.result(timeout=5.0)
            except (RpcError, OSError, TimeoutError) as e:
                log.debug("lease release failed: %s", e)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        self._client.stop()
