"""Client streams: pipelined block writes, checksum-verified failover
reads.

The port's copy of ``hadoop_tpu/dfs/client/streams.py``, speaking the
reference's data-transfer frames to the reference's DataNodes.

Write path: the caller's bytes are cut into packets (1 MiB by default,
``dfs.client-write-packet-size``) with one CRC32C per
``dfs.bytes-per-checksum`` chunk; the first packet of a block allocates
the block (``add_block``, with an exclude list) and opens its pipeline
to the first DataNode, which forwards down the chain; an ack thread per
pipeline consumes the acks, and the writer runs at most
``dfs.client.write.max-packets-in-flight`` packets ahead of the last
one. A failed setup excludes the reported bad node and allocates again.
A failure mid-block re-sends the whole block through a fresh pipeline:
the packets of the open block are kept until it completes, so the
recovery window is one block (the reference's own design).

Read path: the NameNode's located blocks (its replica order), CRC
verification of every packet (or of the stored sums, on a short-circuit
read), dead-node marking and failover to the next replica, a corrupt
replica reported to the NameNode, and after every replica failed,
rounds of location refresh with jittered backoff. With
``dfs.client.hedged.read.threadpool.size`` > 0 a read that has not
answered within ``dfs.client.hedged.read.threshold`` races a second
replica (``DFSClient.hedged_reads`` / ``hedged_wins`` count them).
Block tokens ride every op frame; the trace context of the caller's
span rides the op header, so the DataNodes' spans join the read's
trace.

:class:`DFSClientFaultInjector` has the reference's hooks (before a
packet is sent, on an ack, before a pipeline is set up) for tests to
fail a stream at an exact point.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Set

from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
from hadoop_tpu_torch.dfs.protocol.records import (Block, DatanodeInfo,
                                                   LocatedBlock)
from hadoop_tpu_torch.io import erasurecode as ec
from hadoop_tpu_torch.ipc.errors import RpcError
from hadoop_tpu_torch.ipc.rpc import backoff_delay
from hadoop_tpu_torch.tracing import current_context, global_tracer
from hadoop_tpu_torch.util.crc import ChecksumError, DataChecksum

log = logging.getLogger(__name__)

HEDGED_READ_POOL_SIZE_KEY = "dfs.client.hedged.read.threadpool.size"


class _Packet:
    __slots__ = ("seq", "offset", "data", "sums", "last")

    def __init__(self, seq: int, offset: int, data: bytes, sums: bytes,
                 last: bool):
        self.seq = seq
        self.offset = offset
        self.data = data
        self.sums = sums
        self.last = last

    def to_frame(self) -> Dict:
        return {"seq": self.seq, "off": self.offset, "data": self.data,
                "sums": self.sums, "last": self.last}


class PipelineError(IOError):
    def __init__(self, msg: str, bad_node: Optional[str] = None):
        super().__init__(msg)
        self.bad_node = bad_node


class DFSClientFaultInjector:
    """Overridable fault points on the client write path (ref:
    hadoop-hdfs-client DFSClientFaultInjector.java — tests subclass the
    singleton to fail the stream at exact packets/acks)."""

    _instance: "DFSClientFaultInjector" = None  # type: ignore[assignment]

    @classmethod
    def get(cls) -> "DFSClientFaultInjector":
        if cls._instance is None:
            cls._instance = DFSClientFaultInjector()
        return cls._instance

    @classmethod
    def set(cls, inst) -> None:
        cls._instance = inst

    # ---- hooks (no-ops by default) ----
    def before_send_packet(self, block: Block, seq: int) -> None: ...
    def on_ack(self, block: Block, seq: int) -> None: ...
    def before_pipeline_setup(self, locations) -> None: ...


class DFSOutputStream:
    def __init__(self, client, path: str, packet_size: int = dt.PACKET_SIZE,
                 chunk_size: int = dt.CHUNK_SIZE,
                 max_packets_in_flight: int = 0,
                 socket_buffer: int = 0):
        self.client = client
        self.path = path
        self.packet_size = packet_size
        # Outstanding-ack window (ref: dfs.client-write-max-packets-in-
        # flight / the reference's dataQueue+ackQueue bound of 80
        # packets): how far the writer may run ahead of the LAST acked
        # packet before blocking. 0 = unbounded (the block-recovery
        # buffer already retains every packet of the open block, so the
        # window bounds DN-side backlog and stall detection, not client
        # memory). ``socket_buffer`` (dfs.client.write.socket.buffer)
        # sizes the per-hop kernel pipe — the depth the wire itself
        # holds; 0 keeps the transport default.
        self.max_packets_in_flight = max_packets_in_flight
        self.socket_buffer = socket_buffer
        self.checksum = DataChecksum(chunk_size)
        self._buf = bytearray()
        self._pos = 0          # bytes written overall
        self._block_pos = 0    # bytes in current block
        self._seq = 0
        self._closed = False
        self._block_size = None  # filled on first allocation
        # Packets of the in-flight block, retained for whole-block recovery.
        self._block_packets: List[_Packet] = []
        self._exclude: Set[str] = set()
        self._current: Optional[Block] = None   # last allocated block
        self._pipeline: Optional[_Pipeline] = None  # open write pipeline

    # --------------------------------------------------------------- writes

    def write(self, data: bytes) -> int:
        if self._closed:
            raise ValueError("stream closed")
        # Zero-copy fast path: packet-sized slices of the caller's buffer
        # go straight out (bulk writers hand ≥1 MB buffers; routing them
        # through the staging bytearray would copy every byte twice).
        if not self._buf and len(data) >= self.packet_size:
            mv = memoryview(data)
            off = 0
            while len(data) - off >= self.packet_size:
                if self._pipeline is None:
                    self._start_block()
                room = self._block_size - self._block_pos
                if room <= 0:
                    self._finish_block()
                    self._start_block()
                    room = self._block_size
                take = min(self.packet_size, len(data) - off, room)
                self._send_packet(bytes(mv[off:off + take]))
                off += take
            if off < len(data):
                self._buf += mv[off:]
            return len(data)
        self._buf += data
        self._drain_full_packets()
        return len(data)

    def _drain_full_packets(self, flush_all: bool = False) -> None:
        while len(self._buf) >= self.packet_size or (flush_all and self._buf):
            if self._pipeline is None:
                self._start_block()  # sets _block_size
            room = self._block_size - self._block_pos
            if room <= 0:
                self._finish_block()
                self._start_block()
                room = self._block_size
            take = min(self.packet_size, len(self._buf), room)
            chunk = bytes(self._buf[:take])
            del self._buf[:take]
            self._send_packet(chunk)

    def _send_packet(self, data: bytes) -> None:
        sums = self.checksum.checksums_for(data)
        pkt = _Packet(self._seq, self._block_pos, data, sums, last=False)
        self._seq += 1
        self._block_packets.append(pkt)
        # account BEFORE streaming: recovery resets _block_pos and replays
        # every retained packet (including this one), so a post-stream
        # increment would double-count the packet that triggered recovery
        self._block_pos += len(data)
        self._pos += len(data)
        self._stream_packet(pkt)

    # ----------------------------------------------------- block lifecycle

    def _start_block(self) -> None:
        """Allocate a block + build its pipeline, excluding known-bad nodes.
        Ref: DataStreamer.nextBlockOutputStream:1656."""
        last_exc: Optional[Exception] = None
        for _ in range(5):
            prev = self._current.to_wire() if self._current else None
            lb = self.client.allocate_block(self.path, prev,
                                            list(self._exclude))
            block, locs = lb.block, lb.locations
            if self._block_size is None:
                self._block_size = self.client.block_size_for(self.path)
            try:
                self._pipeline = _Pipeline(
                    block, locs, self.checksum, token=lb.token,
                    window=self.max_packets_in_flight,
                    socket_buffer=self.socket_buffer)
                self._current = block
                self._block_pos = 0
                self._block_packets = []
                return
            except PipelineError as e:
                last_exc = e
                if e.bad_node:
                    self._exclude.add(e.bad_node)
                self.client.abandon_block(self.path, block)
                log.warning("Pipeline setup for %s failed (%s); retrying",
                            block, e)
        raise IOError(f"could not build pipeline for {self.path}: {last_exc}")

    def _stream_packet(self, pkt: _Packet) -> None:
        try:
            self._pipeline.send(pkt)
        except (OSError, PipelineError) as e:
            self._recover_block(e)

    def _recover_block(self, cause: Exception) -> None:
        """Whole-block recovery: abandon, re-allocate excluding suspects,
        replay retained packets. Recovery is itself recoverable — a DN
        dying mid-replay starts another round with the grown exclude set
        (ref: DataStreamer loops until the cluster is exhausted);
        _start_block raises once no pipeline can be built, which bounds
        the loop."""
        old_packets = list(self._block_packets)
        while True:
            log.warning("Pipeline for %s failed (%s); recovering block",
                        self._current, cause)
            bad = getattr(cause, "bad_node", None)
            if bad:
                self._exclude.add(bad)
            elif self._pipeline is not None:
                self._exclude.update(self._pipeline.suspect_nodes())
            try:
                self._pipeline.close(abort=True)
            except (OSError, RpcError) as e:
                log.debug("pipeline abort-close failed: %s", e)
            self.client.abandon_block(self.path, self._current)
            # The block before the abandoned one was already committed by
            # the add_block(previous=...) that allocated it, so the fresh
            # allocation passes previous=None.
            self._current = None
            self._start_block()
            try:
                for pkt in old_packets:
                    self._block_packets.append(pkt)
                    self._pipeline.send(pkt)
                    self._block_pos += len(pkt.data)
                return
            except (OSError, PipelineError) as e:
                cause = e  # next round excludes the fresh suspects

    def _finish_block(self) -> None:
        """Send the trailing empty packet, await all acks, commit length."""
        if self._pipeline is None:
            return
        last = _Packet(self._seq, self._block_pos, b"", b"", last=True)
        self._seq += 1
        while True:
            try:
                self._pipeline.send(last)
                self._pipeline.wait_all_acked()
                break
            except (OSError, PipelineError) as e:
                self._recover_block(e)
        self._current.num_bytes = self._block_pos
        self._pipeline.close()
        self._pipeline = None
        self._block_packets = []

    # ---------------------------------------------------------------- close

    def flush(self) -> None:
        self._drain_full_packets(flush_all=True)

    def close(self) -> None:
        if self._closed:
            return
        self._drain_full_packets(flush_all=True)
        self._finish_block()  # no-op for an empty file (no pipeline)
        self.client.complete_file(
            self.path, self._current.to_wire() if self._current else None)
        self._closed = True

    def tell(self) -> int:
        return self._pos

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            self.close()
        return False


class _Pipeline:
    """One block's write pipeline: socket to the first DN, ack reader thread.
    Ref: DataStreamer's blockStream + ResponseProcessor."""

    ACK_TIMEOUT_S = 30.0

    def __init__(self, block: Block, locations: List[DatanodeInfo],
                 checksum: DataChecksum, token=None, window: int = 0,
                 socket_buffer: int = 0):
        if not locations:
            raise PipelineError("no locations for block")
        DFSClientFaultInjector.get().before_pipeline_setup(locations)
        self.block = block
        self.locations = locations
        self.window = window            # max unacked packets (0 = no cap)
        self._unacked: "queue.Queue[int]" = queue.Queue()
        self._acked_through = -1
        self._first_seq: Optional[int] = None
        self._ack_cond = threading.Condition()
        self._error: Optional[Exception] = None
        try:
            self.sock = dt.connect(locations[0].xfer_addr(), timeout=10.0,
                                   buffer_bytes=socket_buffer)
            setup_req = {
                "op": dt.OP_WRITE_BLOCK, "b": block.to_wire(),
                "targets": [t.to_wire() for t in locations[1:]],
                "stage": dt.STAGE_PIPELINE_SETUP_CREATE,
                "bpc": checksum.bytes_per_chunk,
                "tok": token,
            }
            # trace context rides the op header: every DN in the
            # pipeline resumes the CLIENT's span (the forward loop
            # relays the header verbatim), so one trace covers all hops
            ctx = current_context()
            if ctx is not None:
                setup_req["t"] = ctx.to_wire()
            dt.send_frame(self.sock, setup_req)
            setup = dt.recv_frame(self.sock)
            if not setup.get("ok"):
                raise PipelineError(setup.get("em", "pipeline setup failed"),
                                    bad_node=setup.get("bad_node"))
        except PipelineError:
            # the first DataNode named the bad one (a mirror): a
            # PipelineError is an OSError, and the clause below would
            # blame the first DataNode instead (ROADMAP C 16)
            self.sock.close()
            raise
        except (OSError, EOFError) as e:
            raise PipelineError(
                f"connect to {locations[0]} failed: {e}",
                bad_node=locations[0].uuid) from e
        self._ack_thread = threading.Thread(
            target=self._ack_loop, daemon=True,
            name=f"resp-proc-{block.block_id}")
        self._ack_thread.start()

    def _ack_loop(self) -> None:
        try:
            while True:
                ack = dt.recv_frame(self.sock)
                statuses = ack.get("statuses", [])
                if any(s != dt.STATUS_SUCCESS for s in statuses):
                    bad_idx = next(i for i, s in enumerate(statuses)
                                   if s != dt.STATUS_SUCCESS)
                    bad = self.locations[bad_idx].uuid \
                        if bad_idx < len(self.locations) else None
                    raise PipelineError(f"ack failure {statuses}",
                                        bad_node=bad)
                DFSClientFaultInjector.get().on_ack(self.block, ack["seq"])
                with self._ack_cond:
                    self._acked_through = ack["seq"]
                    self._ack_cond.notify_all()
                if ack.get("last"):
                    return
        except (OSError, EOFError, PipelineError, Exception) as e:  # noqa: BLE001
            with self._ack_cond:
                self._error = e if isinstance(e, (OSError, PipelineError)) \
                    else PipelineError(str(e))
                self._ack_cond.notify_all()

    def send(self, pkt: _Packet) -> None:
        DFSClientFaultInjector.get().before_send_packet(self.block, pkt.seq)
        deadline = time.monotonic() + self.ACK_TIMEOUT_S
        with self._ack_cond:
            if self._error is not None:
                raise self._error
            if self._first_seq is None:
                # the window counts from this pipeline's first packet:
                # the stream's sequence runs on across blocks, and a
                # later block counted from -1 waits for acks of packets
                # it never sent (ROADMAP C 22)
                self._first_seq = pkt.seq
                self._acked_through = pkt.seq - 1
            # outstanding-ack window: run at most ``window`` packets
            # ahead of the last ack — deep enough to keep every hop's
            # pipe full, bounded so a wedged DN surfaces as a pipeline
            # error here instead of an unbounded DN-side backlog
            while self.window and pkt.seq - self._acked_through > \
                    self.window:
                if self._error is not None:
                    raise self._error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PipelineError(
                        f"ack window ({self.window} packets) stalled "
                        f"for {self.ACK_TIMEOUT_S}s")
                self._ack_cond.wait(remaining)
        self._last_seq = pkt.seq
        dt.send_frame(self.sock, pkt.to_frame())

    def wait_all_acked(self) -> None:
        """Ref: DataStreamer.waitForAckedSeqno:872."""
        deadline = time.monotonic() + self.ACK_TIMEOUT_S
        with self._ack_cond:
            while self._acked_through < getattr(self, "_last_seq", -1):
                if self._error is not None:
                    raise self._error
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise PipelineError("timed out waiting for pipeline acks")
                self._ack_cond.wait(remaining)

    def suspect_nodes(self) -> List[str]:
        return [d.uuid for d in self.locations]

    def close(self, abort: bool = False) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class DFSInputStream:
    def __init__(self, client, path: str, info: Optional[Dict] = None):
        self.client = client
        self.path = path
        if info is None:
            self._refresh_locations()
        else:
            self._set_locations(info)
        self._pos = 0
        self._closed = False
        self._dead: Set[str] = set()
        # ref: dfs.client.read.shortcircuit (the reference defaults it off
        # because domain-socket setup needs operator config; the path-based
        # transport here has no setup, so default on)
        conf = getattr(client, "conf", None)
        self._short_circuit_ok = conf is None or conf.get_bool(
            "dfs.client.read.shortcircuit", True)
        # Hedged reads (ref: DFSInputStream's hedged-read path +
        # dfs.client.hedged.read.threadpool.size/threshold.millis):
        # enabled by a nonzero pool size; after the threshold with no
        # answer from the first replica, a second read races it.
        self._hedged_threshold_s = 0.5
        self._hedged_enabled = False
        if conf is not None and conf.get_int(
                HEDGED_READ_POOL_SIZE_KEY, 0) > 0:
            self._hedged_enabled = True
            self._hedged_threshold_s = conf.get_time_seconds(
                "dfs.client.hedged.read.threshold", 0.5)

    def _refresh_locations(self) -> None:
        self._set_locations(self.client.get_block_locations(self.path))

    def _set_locations(self, info: Dict) -> None:
        self.length = info["length"]
        self.blocks = [LocatedBlock.from_wire(b) for b in info["blocks"]]

    # ---------------------------------------------------------------- reads

    def read(self, n: int = -1) -> bytes:
        if self._closed:
            raise ValueError("stream closed")
        if n < 0:
            n = self.length - self._pos
        out = bytearray()
        while n > 0 and self._pos < self.length:
            chunk = self._read_some(self._pos, n)
            if not chunk:
                break
            out += chunk
            self._pos += len(chunk)
            n -= len(chunk)
        return bytes(out)

    def pread(self, position: int, length: int) -> bytes:
        """Positioned read, does not move the cursor.
        Ref: DFSInputStream.read(long,...) / PositionedReadable."""
        out = bytearray()
        pos = position
        remaining = min(length, self.length - position)
        while remaining > 0:
            chunk = self._fetch_range(pos, remaining)
            if not chunk:
                break
            out += chunk
            pos += len(chunk)
            remaining -= len(chunk)
        return bytes(out)

    def seek(self, pos: int) -> None:
        self._pos = pos

    def tell(self) -> int:
        return self._pos

    def _block_for(self, pos: int) -> LocatedBlock:
        for lb in self.blocks:
            if lb.offset <= pos < lb.offset + lb.block.num_bytes:
                return lb
        raise EOFError(f"offset {pos} beyond file length {self.length}")

    def _read_some(self, pos: int, want: int) -> bytes:
        return self._fetch_range(pos, want)

    # Refresh/backoff rounds when every replica fails or the NN reports
    # no locations (nodes transiently dead under load, re-replication in
    # flight, a fresh post-failover active still collecting block
    # reports — report interval is seconds). Ref: DFSInputStream
    # chooseDataNode's retry window (dfs.client.retries.window.base —
    # sleeps then refetches locations). The window must outlast one
    # block-report interval: 0.5+1+1.5+2+2.5 = 7.5s of backoff.
    LOCATION_RETRIES = 6
    RETRY_BACKOFF_S = 0.5

    def _fetch_range(self, pos: int, want: int) -> bytes:
        """Read up to ``want`` bytes at pos from one replica, with failover.
        Ref: DFSInputStream.blockSeekTo:639 + read retry loop.

        Wrapped in a ``dfs.client.read`` span — the ROOT of a read
        trace when no span is active (the htrace model: the client
        decides sampling; NN handler + DN xceiver spans join it over
        the wire)."""
        with global_tracer().span("dfs.client.read") as rsp:
            rsp.add_kv("path", self.path)
            rsp.add_kv("pos", str(pos))
            return self._fetch_range_traced(pos, want)

    def _fetch_range_traced(self, pos: int, want: int) -> bytes:
        lb = self._block_for(pos)
        in_block_off = pos - lb.offset
        want = min(want, lb.block.num_bytes - in_block_off)
        errors: List[str] = []
        candidates = [d for d in lb.locations if d.uuid not in self._dead] \
            or lb.locations  # all dead? retry everyone once
        if self._hedged_enabled and len(candidates) > 1:
            try:
                return self._hedged_fetch(candidates, lb.block,
                                          in_block_off, want)
            except (OSError, EOFError, IOError) as e:
                errors.append(f"hedged: {e}")
                # Every candidate was already tried (and failed) inside
                # the hedge — go straight to the refresh/backoff rounds
                # instead of paying each connect timeout a second time.
                candidates = []
        for dn in candidates:
            try:
                return self._read_from_datanode(dn, lb.block, in_block_off,
                                                want)
            except ChecksumError:
                log.warning("Checksum error reading %s from %s; reporting",
                            lb.block, dn)
                self.client.report_bad_block(lb.block, dn.uuid)
                self._dead.add(dn.uuid)
                errors.append(f"{dn}: checksum")
            except (OSError, EOFError, IOError) as e:
                self._dead.add(dn.uuid)
                errors.append(f"{dn}: {e}")
        # Refresh + backoff rounds: replicas may have moved
        # (re-replication) or their nodes may be only transiently dead.
        for attempt in range(self.LOCATION_RETRIES):
            self._refresh_locations()
            self._dead.clear()
            lb = self._block_for(pos)
            for dn in lb.locations:
                try:
                    return self._read_from_datanode(dn, lb.block,
                                                    in_block_off, want)
                except ChecksumError:
                    # report in the retry rounds too — swallowing it in
                    # the generic handler meant the NN never learned of
                    # the corruption (no re-replication) and, with
                    # _dead cleared each round, the client re-downloaded
                    # the same corrupt replica every round
                    log.warning("Checksum error reading %s from %s; "
                                "reporting", lb.block, dn)
                    self.client.report_bad_block(lb.block, dn.uuid)
                    self._dead.add(dn.uuid)
                    errors.append(f"{dn}: checksum")
                except (OSError, EOFError, IOError) as e:
                    errors.append(f"{dn}: {e}")
            if attempt < self.LOCATION_RETRIES - 1:
                # exponential + jittered: a fleet of readers chasing the
                # same re-replicating block must not stampede the NN in
                # lockstep rounds (ref: RetryPolicies.exponentialBackoff)
                time.sleep(backoff_delay(self.RETRY_BACKOFF_S, attempt,
                                         max_s=8.0))
        raise IOError(f"could not read {self.path} at {pos} from any "
                      f"replica: {errors}")

    def _hedged_fetch(self, candidates: List[DatanodeInfo], block: Block,
                      offset: int, want: int) -> bytes:
        """Race replicas: the first read gets ``threshold`` alone; then a
        hedge starts on the next replica and the first success wins. A
        replica that errors triggers the next hedge immediately. Losers
        run to completion in the pool (ref: DFSInputStream
        .hedgedFetchBlockByteRange — it too lets stragglers finish)."""
        import concurrent.futures as cf
        pending = list(candidates)
        by_future = {}
        first = pending.pop(0)
        fut = self.client.hedged_submit(self._read_from_datanode, first,
                                        block, offset, want)
        if fut is None:
            # Pool saturated by straggling losers: read sequentially
            # rather than queueing behind them.
            return self._read_from_datanode(first, block, offset, want)
        by_future[fut] = first
        errors: List[str] = []
        while True:
            timeout = self._hedged_threshold_s if pending else None
            done, _ = cf.wait(list(by_future), timeout=timeout,
                              return_when=cf.FIRST_COMPLETED)
            for f in done:
                dn = by_future.pop(f)
                exc = f.exception()
                if exc is None:
                    self.client.hedged_wins += 1
                    return f.result()
                # Same failure bookkeeping as the sequential path: a
                # corrupt replica is reported and a failed one goes on
                # the dead list so later reads skip it.
                if isinstance(exc, ChecksumError):
                    log.warning("Checksum error (hedged) reading %s from"
                                " %s; reporting", block, dn)
                    self.client.report_bad_block(block, dn.uuid)
                self._dead.add(dn.uuid)
                errors.append(f"{dn}: {exc}")
            if pending:
                nxt = pending.pop(0)
                fut = self.client.hedged_submit(self._read_from_datanode,
                                                nxt, block, offset, want)
                if fut is None:
                    if by_future:
                        pending.insert(0, nxt)  # retry hedging next wake
                        continue
                    return self._read_from_datanode(nxt, block, offset,
                                                    want)
                self.client.hedged_reads += 1
                by_future[fut] = nxt
            elif not by_future:
                raise IOError(f"all hedged reads failed: {errors}")

    def _token_for(self, block: Block):
        bid = block.block_id
        gid = ec.group_id_of(bid) if ec.is_striped_id(bid) else bid
        for lb in self.blocks:
            if lb.block.block_id in (bid, gid):
                return lb.token
        return None

    def _read_from_datanode(self, dn: DatanodeInfo, block: Block,
                            offset: int, want: int) -> bytes:
        """BlockReaderFactory seam (ref: BlockReaderFactory.java:354-381):
        local replica → short-circuit direct file read; else TCP."""
        if self._short_circuit_ok:
            from hadoop_tpu_torch.dfs.client.shortcircuit import (
                ShortCircuitCache, ShortCircuitUnavailable)
            cache = ShortCircuitCache.get()
            if cache.is_local(dn):
                try:
                    return cache.read(
                        dn, block, offset, want,
                        token=self._token_for(block),
                        socket_template=self.client.conf.get(
                            "dfs.domain.socket.path", ""))
                except ShortCircuitUnavailable as e:
                    log.debug("short-circuit read of %s fell back: %s",
                              block, e)
        return self._read_remote(dn, block, offset, want)

    def _read_remote(self, dn: DatanodeInfo, block: Block,
                     offset: int, want: int) -> bytes:
        sock = dt.connect(dn.xfer_addr(), timeout=10.0)
        try:
            req = {"op": dt.OP_READ_BLOCK, "b": block.to_wire(),
                   "tok": self._token_for(block),
                   "offset": offset, "length": want}
            ctx = current_context()
            if ctx is not None:
                req["t"] = ctx.to_wire()
            dt.send_frame(sock, req)
            setup = dt.recv_frame(sock)
            if not setup.get("ok"):
                raise IOError(setup.get("em", "read setup failed"))
            # verify with the replica's stored chunking, not our default
            checksum = DataChecksum(dt.checked_bpc(setup))
            out = bytearray()
            skip = None
            while True:
                pkt = dt.recv_frame(sock)
                if pkt.get("last"):
                    break
                data, sums = pkt["data"], pkt["sums"]
                checksum.verify(data, sums, base_pos=pkt["off"])
                if skip is None:
                    skip = offset - pkt["off"]  # chunk alignment slack
                take = data[skip:skip + (want - len(out))] if skip else \
                    data[:want - len(out)]
                out += take
                skip = 0
            return bytes(out)
        finally:
            sock.close()

    def close(self) -> None:
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
