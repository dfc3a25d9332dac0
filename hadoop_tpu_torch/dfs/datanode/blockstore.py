"""On-disk replica store.

The port's copy of ``hadoop_tpu/dfs/datanode/blockstore.py``, on the
same wire and disk formats.

Parity with the reference's dataset layer (ref:
server/datanode/fsdataset/impl/FsDatasetImpl.java:136, ReplicaInfo state
machine, BlockMetadataHeader): replicas live as a data file + a ``.meta``
side file (DataChecksum header + one CRC per chunk). Under-construction
replicas ("rbw" — replica being written) live in ``rbw/`` and move to
``finalized/`` atomically on completion.

Layout:  <dir>/rbw/blk_<id>            + blk_<id>.meta
         <dir>/finalized/blk_<id>      + blk_<id>.meta
(The gen stamp is recorded inside the meta header trailer, not the filename,
so recovery-time stamp bumps are a metadata rewrite, not a data copy.)
"""

from __future__ import annotations

import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

from hadoop_tpu_torch.dfs.protocol.records import Block, ReplicaNotFoundError
from hadoop_tpu_torch.util.crc import DataChecksum

_META_MAGIC = b"HTPM"


class Replica:
    FINALIZED = "finalized"
    RBW = "rbw"

    __slots__ = ("block_id", "gen_stamp", "num_bytes", "state")

    def __init__(self, block_id: int, gen_stamp: int, num_bytes: int,
                 state: str):
        self.block_id = block_id
        self.gen_stamp = gen_stamp
        self.num_bytes = num_bytes
        self.state = state

    def to_block(self) -> Block:
        return Block(self.block_id, self.gen_stamp, self.num_bytes)


class _OpenReplica:
    """An rbw replica with open file handles, fed packet by packet.

    Block recovery may *steal* an open writer (ref: ReplicaInPipeline
    .stopWriter): the store flushes + closes the handles under ``_io_lock``
    and marks the writer stolen; the feeding xceiver's next write raises and
    its teardown becomes a no-op, so recovery never races buffered data or
    moves files out from under live handles."""

    def __init__(self, store: "BlockStore", block: Block, checksum: DataChecksum):
        self.store = store
        self.block_id = block.block_id
        self.gen_stamp = block.gen_stamp
        self.checksum = checksum
        self.data_path = store._path(Replica.RBW, block.block_id)
        self.meta_path = self.data_path + ".meta"
        self._data_f = open(self.data_path, "wb")
        self._meta_f = open(self.meta_path, "wb")
        self._meta_f.write(_META_MAGIC + struct.pack(">q", block.gen_stamp)
                           + checksum.header())
        self.num_bytes = 0
        self.stolen = False
        # Bytes of the current incomplete trailing chunk. A client hflush
        # can end a packet mid-chunk (ref: BlockReceiver's partial-chunk
        # handling); the next packet then starts unaligned, so its
        # packet-relative sums can't be appended verbatim — the straddling
        # chunk's CRC is recomputed over (partial + new) instead.
        self._partial = b""
        # NativeIO drop-behind-writes discipline (ref: BlockReceiver's
        # manageWriterOsCache under dfs.datanode.drop.cache.behind.writes
        # + sync.behind.writes, both OFF by default like the reference —
        # right for archival/streaming ingest, wrong for write-then-read
        # workloads like shuffle spills): kick writeback for the newest
        # window, evict only the PREVIOUS (already-synced) one so
        # DONTNEED hits clean pages.
        self._drop_behind = getattr(store, "drop_behind_writes", False)
        self._synced_to = 0
        self._dropped_to = 0
        self._io_lock = threading.Lock()

    DROP_BEHIND_BYTES = 8 * 1024 * 1024

    def write_packet(self, data: bytes, sums: bytes) -> None:
        with self._io_lock:
            if self.stolen:
                raise IOError(f"writer of blk_{self.block_id} stopped by "
                              f"block recovery")
            self._data_f.write(data)
            if self._drop_behind and \
                    self.num_bytes - self._synced_to >= \
                    self.DROP_BEHIND_BYTES:
                from hadoop_tpu_torch.util import nativeio as native
                upto = self.num_bytes - (self.num_bytes %
                                         self.DROP_BEHIND_BYTES)
                self._data_f.flush()
                fd = self._data_f.fileno()
                native.sync_file_range(fd, self._synced_to,
                                       upto - self._synced_to)
                # The range synced LAST window has completed writeback
                # by now — those pages evict; the fresh window waits.
                if self._synced_to > self._dropped_to:
                    native.fadvise(fd, self._dropped_to,
                                   self._synced_to - self._dropped_to,
                                   native.FADV_DONTNEED)
                    self._dropped_to = self._synced_to
                self._synced_to = upto
            bpc = self.checksum.bytes_per_chunk
            if self._partial:
                # Rewind the partial chunk's provisional CRC and re-cover
                # it together with the new bytes, chunk-aligned.
                self._meta_f.seek(-4, os.SEEK_END)
                self._meta_f.truncate()
                combined = self._partial + data
                self._meta_f.write(self.checksum.checksums_for(combined))
            else:
                combined = data
                self._meta_f.write(sums)
            self._partial = combined[len(combined) // bpc * bpc:]
            self.num_bytes += len(data)

    def fsync(self) -> None:
        with self._io_lock:
            if self.stolen:
                return
            self._fsync_locked()

    def _fsync_locked(self) -> None:
        self._data_f.flush()
        os.fsync(self._data_f.fileno())
        self._meta_f.flush()
        os.fsync(self._meta_f.fileno())

    def close(self) -> None:
        with self._io_lock:
            if self.stolen:
                return
            self._close_locked()
        self.store._writer_closed(self)

    def _close_locked(self) -> None:
        self._data_f.close()
        self._meta_f.close()

    def steal(self) -> None:
        """Flush + close + fence the writer (recovery path)."""
        with self._io_lock:
            if self.stolen:
                return
            try:
                self._fsync_locked()
            finally:
                self._close_locked()
                self.stolen = True
        self.store._writer_closed(self)

    def abort(self) -> None:
        with self._io_lock:
            if self.stolen:
                return  # recovery owns the files now
            self._close_locked()
            self.stolen = True
        self.store._writer_closed(self)
        for p in (self.data_path, self.meta_path):
            if os.path.exists(p):
                os.remove(p)


class BlockStore:
    def __init__(self, directory: str, chunk_size: int = 512,
                 capacity_override: int = 0, sync_on_close: bool = False,
                 drop_behind_writes: bool = False):
        self.dir = directory
        self.chunk_size = chunk_size
        # ref: dfs.datanode.drop.cache.behind.writes (NativeIO page-cache
        # discipline; off by default like the reference)
        self.drop_behind_writes = drop_behind_writes
        # fsync on finalize — ref: dfs.datanode.synconclose, FALSE in the
        # reference too (DataNode.java / BlockReceiver close path): block
        # durability comes from 3-way replication, not per-block fsync;
        # fsync per finalize costs ~3x write throughput on ext4.
        self.sync_on_close = sync_on_close
        # Centralized-cache pinning (ref: fsdataset/impl/FsDatasetCache
        # .java — mmap+mlock there; resident bytes here): block id →
        # in-memory copy served by read_chunks without touching disk.
        self._cached: Dict[int, bytes] = {}
        self.max_cache_bytes = 64 * 1024 * 1024
        # Advertised capacity for shared volumes / simulated heterogeneity
        # (ref: dfs.datanode.du.reserved + SimulatedFSDataset's capacity).
        self.capacity_override = capacity_override
        for sub in (Replica.RBW, Replica.FINALIZED):
            os.makedirs(os.path.join(directory, sub), exist_ok=True)
        self._replicas: Dict[int, Replica] = {}
        self._open_writers: Dict[int, _OpenReplica] = {}
        self._lock = threading.Lock()
        self._scan()

    def _path(self, state: str, block_id: int) -> str:
        return os.path.join(self.dir, state, f"blk_{block_id}")

    def _scan(self) -> None:
        """Startup inventory (ref: DataNode's DirectoryScanner.java:64 initial
        pass). rbw replicas left by a crash are kept — the NN decides their
        fate via block recovery or invalidation."""
        for state in (Replica.FINALIZED, Replica.RBW):
            d = os.path.join(self.dir, state)
            for name in os.listdir(d):
                if not name.startswith("blk_") or name.endswith(".meta"):
                    continue
                bid = int(name[4:])
                data_path = os.path.join(d, name)
                gs = self._read_meta_genstamp(data_path + ".meta")
                if gs is None:
                    continue
                self._replicas[bid] = Replica(
                    bid, gs, os.path.getsize(data_path), state)

    @staticmethod
    def _read_meta_genstamp(meta_path: str) -> Optional[int]:
        try:
            with open(meta_path, "rb") as f:
                magic = f.read(4)
                if magic != _META_MAGIC:
                    return None
                return struct.unpack(">q", f.read(8))[0]
        except OSError:
            return None

    # --------------------------------------------------------------- writes

    def create_rbw(self, block: Block, checksum: DataChecksum) -> _OpenReplica:
        # Claim loop: the replace decision and the claim must be ONE
        # atomic step, or two concurrent setups for the same block both
        # pass the stale-check and the loser deletes the winner's open
        # files unfenced (the winner's later finalize would then publish
        # the loser's partial data). steal() must run OUTSIDE the lock —
        # it re-enters via _writer_closed.
        while True:
            with self._lock:
                stale_writer = self._open_writers.get(block.block_id)
                if stale_writer is None:
                    existing = self._replicas.get(block.block_id)
                    if existing is not None:
                        if existing.state == Replica.FINALIZED:
                            raise IOError(
                                f"block {block.block_id} already finalized")
                        # Pipeline recovery overwrites a stale rbw replica.
                        self._remove_files(existing)
                        del self._replicas[block.block_id]
                    rep = Replica(block.block_id, block.gen_stamp, 0,
                                  Replica.RBW)
                    self._replicas[block.block_id] = rep
                    writer = _OpenReplica(self, block, checksum)
                    self._open_writers[block.block_id] = writer
                    return writer
            stale_writer.steal()  # fence, then retry the claim

    def _writer_closed(self, writer: "_OpenReplica") -> None:
        with self._lock:
            if self._open_writers.get(writer.block_id) is writer:
                del self._open_writers[writer.block_id]

    def finalize(self, open_rep: _OpenReplica) -> Replica:
        """flush (+ optional fsync) + atomic move rbw → finalized.
        Ref: FsDatasetImpl.finalizeBlock."""
        if self.sync_on_close:
            open_rep.fsync()
        open_rep.close()
        dst = self._path(Replica.FINALIZED, open_rep.block_id)
        os.replace(open_rep.data_path, dst)
        os.replace(open_rep.meta_path, dst + ".meta")
        with self._lock:
            rep = Replica(open_rep.block_id, open_rep.gen_stamp,
                          open_rep.num_bytes, Replica.FINALIZED)
            self._replicas[open_rep.block_id] = rep
            return rep

    def invalidate(self, block: Block) -> bool:
        """Delete a replica. Ref: FsDatasetImpl.invalidate."""
        with self._lock:
            rep = self._replicas.pop(block.block_id, None)
            if rep is None:
                return False
            self._remove_files(rep)
            return True

    def _remove_files(self, rep: Replica) -> None:
        p = self._path(rep.state, rep.block_id)
        for path in (p, p + ".meta"):
            if os.path.exists(path):
                os.remove(path)

    def _reconcile_rbw_files(self, data_path: str, meta_path: str) -> int:
        """Crash alignment before promoting an rbw: the data and meta
        files flush independently, so after a DN crash one can be ahead
        of the other. Truncate both to the longest prefix whose stored
        checksums actually verify — finalizing at the raw data size
        would mint a replica whose tail fails every future read and
        gets invalidated, destroying the recoverable prefix (ref:
        FsDatasetImpl.recoverRbw's checksum/length alignment +
        truncateBlock)."""
        hdr = 12 + DataChecksum.HEADER_LEN
        try:
            with open(meta_path, "rb") as f:
                f.seek(12)
                checksum = DataChecksum.from_header(
                    f.read(DataChecksum.HEADER_LEN))
        except (OSError, ValueError, struct.error):
            return 0  # torn meta header: nothing is verifiable
        bpc = checksum.bytes_per_chunk
        dsize = os.path.getsize(data_path)
        n_sums = max(0, os.path.getsize(meta_path) - hdr) // 4
        length = min(dsize, n_sums * bpc)
        with open(data_path, "rb") as df, open(meta_path, "rb") as mf:
            while length > 0:
                last = (length - 1) // bpc
                start = last * bpc
                df.seek(start)
                chunk = df.read(length - start)
                mf.seek(hdr + last * 4)
                stored = mf.read(4)
                if len(stored) == 4 and \
                        checksum.checksums_for(chunk) == stored:
                    break
                length = start  # drop the unverifiable tail chunk
        n_keep = (length + bpc - 1) // bpc
        if length < dsize:
            with open(data_path, "r+b") as f:
                f.truncate(length)
        if hdr + n_keep * 4 < hdr + n_sums * 4:
            with open(meta_path, "r+b") as f:
                f.truncate(hdr + n_keep * 4)
        return length

    def finalize_existing(self, block_id: int) -> Optional[Replica]:
        """Block recovery: promote an rbw replica to finalized at its current
        length. Stops a still-open writer first so buffered bytes reach disk
        and the handles can't race the rename.
        Ref: FsDatasetImpl.recoverRbw (stopWriter) + finalizeBlock."""
        with self._lock:
            writer = self._open_writers.get(block_id)
        if writer is not None:
            writer.steal()
        with self._lock:
            rep = self._replicas.get(block_id)
            if rep is None:
                raise ReplicaNotFoundError(str(block_id))
            if rep.state == Replica.FINALIZED:
                return rep
            src = self._path(Replica.RBW, block_id)
            dst = self._path(Replica.FINALIZED, block_id)
            # The verified on-disk prefix is the truth: an interrupted
            # pipeline leaves the in-memory record at 0 while the rbw
            # file holds the data (and a crash can tear the tail).
            rep.num_bytes = self._reconcile_rbw_files(src, src + ".meta")
            os.replace(src, dst)
            os.replace(src + ".meta", dst + ".meta")
            rep.state = Replica.FINALIZED
            return rep

    def update_gen_stamp(self, block_id: int, new_gs: int) -> None:
        """Block recovery: bump the stamp in place (metadata rewrite)."""
        with self._lock:
            rep = self._replicas.get(block_id)
            if rep is None:
                raise ReplicaNotFoundError(str(block_id))
            meta = self._path(rep.state, block_id) + ".meta"
            with open(meta, "r+b") as f:
                f.seek(4)
                f.write(struct.pack(">q", new_gs))
            rep.gen_stamp = new_gs

    # ---------------------------------------------------------------- reads

    def get_replica(self, block_id: int) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(block_id)

    def open_for_read(self, block: Block) -> Tuple[str, str, DataChecksum, int]:
        """Returns (data_path, meta_path, checksum, visible_length)."""
        with self._lock:
            rep = self._replicas.get(block.block_id)
        if rep is None:
            raise ReplicaNotFoundError(f"blk_{block.block_id} not on this node")
        if rep.gen_stamp < block.gen_stamp:
            raise ReplicaNotFoundError(
                f"blk_{block.block_id} replica genstamp {rep.gen_stamp} < "
                f"requested {block.gen_stamp}")
        data_path = self._path(rep.state, block.block_id)
        meta_path = data_path + ".meta"
        with open(meta_path, "rb") as f:
            f.seek(4 + 8)
            checksum = DataChecksum.from_header(
                f.read(DataChecksum.HEADER_LEN))
        return data_path, meta_path, checksum, rep.num_bytes

    def cache_block(self, block: Block) -> bool:
        """Pin a finalized replica's bytes in memory (ref: FsDatasetCache
        .cacheBlock). False when over the cache budget or not present."""
        with self._lock:
            if block.block_id in self._cached:
                return True
            used = sum(len(v) for v in self._cached.values())
        try:
            data_path, _, _, visible = self.open_for_read(block)
        except IOError:
            return False
        if used + visible > self.max_cache_bytes:
            return False
        with open(data_path, "rb") as f:
            data = f.read(visible)
        with self._lock:
            self._cached[block.block_id] = data
        return True

    def uncache_block(self, block_id: int) -> bool:
        with self._lock:
            return self._cached.pop(block_id, None) is not None

    def cached_ids(self) -> List[int]:
        with self._lock:
            return list(self._cached)

    def read_chunks(self, block: Block, offset: int, length: int,
                    opened=None):
        """Yield (chunk_aligned_offset, data, sums) runs for a byte range,
        chunk-aligned so the reader can CRC-verify; cached (memory-pinned)
        replicas serve data without touching the data file.
        Ref: BlockSender.java."""
        with self._lock:
            pinned = self._cached.get(block.block_id)
        if pinned is not None:
            yield from self._read_chunks_cached(block, offset, length,
                                                pinned)
            return
        data_path, meta_path, checksum, visible = \
            opened if opened is not None else self.open_for_read(block)
        bpc = checksum.bytes_per_chunk
        start = (offset // bpc) * bpc
        end = min(visible, offset + length)
        with open(data_path, "rb") as df, open(meta_path, "rb") as mf:
            # Sequential-read hint (ref: BlockSender's
            # manageOsCache POSIX_FADV_SEQUENTIAL): doubled readahead
            # for the scan, without polluting cache for other replicas.
            from hadoop_tpu_torch.util import nativeio as native
            native.fadvise(df.fileno(), start, max(0, end - start),
                           native.FADV_SEQUENTIAL)
            meta_header = 4 + 8 + DataChecksum.HEADER_LEN
            pos = start
            while pos < end:
                n = min(1024 * 1024, end - pos)
                # Round n up to chunk boundary (or EOF).
                n = min(((n + bpc - 1) // bpc) * bpc, visible - pos)
                df.seek(pos)
                data = df.read(n)
                first_chunk = pos // bpc
                n_chunks = (len(data) + bpc - 1) // bpc
                mf.seek(meta_header + 4 * first_chunk)
                sums = mf.read(4 * n_chunks)
                yield pos, data, sums
                pos += len(data)
                if len(data) < n:
                    break

    def _read_chunks_cached(self, block: Block, offset: int, length: int,
                            pinned: bytes):
        _, meta_path, checksum, visible = self.open_for_read(block)
        bpc = checksum.bytes_per_chunk
        start = (offset // bpc) * bpc
        end = min(visible, len(pinned), offset + length)
        meta_header = 4 + 8 + DataChecksum.HEADER_LEN
        with open(meta_path, "rb") as mf:
            pos = start
            while pos < end:
                n = min(1024 * 1024, end - pos)
                n = min(((n + bpc - 1) // bpc) * bpc, len(pinned) - pos)
                data = pinned[pos:pos + n]
                first_chunk = pos // bpc
                n_chunks = (len(data) + bpc - 1) // bpc
                mf.seek(meta_header + 4 * first_chunk)
                sums = mf.read(4 * n_chunks)
                yield pos, data, sums
                pos += len(data)
                if not data:
                    break

    # ------------------------------------------------------------ inventory

    def reconcile(self) -> Tuple[List[Block], List[Block]]:
        """DirectoryScanner diff of memory vs disk (ref: server/datanode/
        DirectoryScanner.java:64 reconcile): replicas whose data file
        vanished are dropped from memory (returned first — caller tells
        the NN so re-replication starts); orphaned finalized files with a
        valid meta are adopted (returned second — caller reports them
        received)."""
        with self._lock:
            snapshot = {bid: rep for bid, rep in self._replicas.items()
                        if bid not in self._open_writers}
        vanished: List[Block] = []
        for bid, rep in snapshot.items():
            if not os.path.exists(self._path(rep.state, bid)):
                vanished.append(rep.to_block())
                with self._lock:
                    if self._replicas.get(bid) is rep:
                        del self._replicas[bid]
        adopted: List[Block] = []
        fin_dir = os.path.join(self.dir, Replica.FINALIZED)
        for name in os.listdir(fin_dir):
            if not name.startswith("blk_") or name.endswith(".meta"):
                continue
            bid = int(name[4:])
            with self._lock:
                known = bid in self._replicas
            if known:
                continue
            data_path = os.path.join(fin_dir, name)
            gs = self._read_meta_genstamp(data_path + ".meta")
            if gs is None:
                continue  # torn orphan: no valid meta — leave for operator
            rep = Replica(bid, gs, os.path.getsize(data_path),
                          Replica.FINALIZED)
            with self._lock:
                self._replicas.setdefault(bid, rep)
            adopted.append(rep.to_block())
        return vanished, adopted

    def verify_replica(self, block: Block) -> None:
        """Full CRC sweep of one replica (VolumeScanner's unit of work).
        Raises ChecksumError on rot. Ref: VolumeScanner.java:55."""
        from hadoop_tpu_torch.util.crc import DataChecksum
        _, _, checksum, visible = self.open_for_read(block)
        for pos, data, sums in self.read_chunks(block, 0, visible):
            checksum.verify(data, sums, base_pos=pos)

    def all_finalized(self) -> List[Block]:
        with self._lock:
            return [r.to_block() for r in self._replicas.values()
                    if r.state == Replica.FINALIZED]

    def stats(self) -> Dict[str, int]:
        used = 0
        with self._lock:
            n = len(self._replicas)
            for rep in self._replicas.values():
                used += rep.num_bytes
        if self.capacity_override:
            return {
                "capacity": self.capacity_override,
                "dfs_used": used,
                "remaining": max(0, self.capacity_override - used),
                "num_replicas": n,
            }
        st = os.statvfs(self.dir)
        return {
            "capacity": st.f_blocks * st.f_frsize,
            "dfs_used": used,
            "remaining": st.f_bavail * st.f_frsize,
            "num_replicas": n,
        }
