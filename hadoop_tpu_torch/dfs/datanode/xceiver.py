"""Streaming data server: thread-per-transfer, pipelined writes, chunked reads.

The port's copy of ``hadoop_tpu/dfs/datanode/xceiver.py``, on the same
wire and disk formats.

Parity with the reference's xceiver layer (ref:
server/datanode/DataXceiverServer.java:48/:222 run, DataXceiver.java:667
writeBlock (mirror connect at :831), BlockReceiver.java:953 receiveBlock +
PacketResponder (:975), BlockSender.java):

WRITE_BLOCK: accept op → connect downstream mirror (remaining targets) →
ack the setup upstream → receive packets: CRC-verify, write, forward; a
responder thread relays downstream acks upstream with this node's status
prepended. The terminal node acks directly. Last packet (empty, last=True)
finalizes the replica and queues an incremental block report.

READ_BLOCK: stream chunk-aligned packets with their stored checksums (client
verifies; a checksum error at the client marks the replica corrupt at the NN).
"""

from __future__ import annotations

import contextlib
import logging
import socket
import threading
import time
from typing import Callable, List, Optional

from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
from hadoop_tpu_torch.dfs.protocol.records import Block, DatanodeInfo
from hadoop_tpu_torch.dfs.datanode.blockstore import BlockStore
from hadoop_tpu_torch.metrics import metrics_system
from hadoop_tpu_torch.tracing import (SpanContext, current_span,
                                       global_tracer)
from hadoop_tpu_torch.util.crc import ChecksumError, DataChecksum
from hadoop_tpu_torch.util.misc import Daemon

log = logging.getLogger(__name__)


class DataXceiverServer:
    def __init__(self, store: BlockStore,
                 on_block_received: Callable[[Block], None],
                 bind_host: str = "127.0.0.1", port: int = 0,
                 fault_injector=None, security_keys=None,
                 required_qop: str = "privacy"):
        self.store = store
        self.on_block_received = on_block_received
        # DataEncryptionKeys when dfs.encrypt.data.transfer is on: every
        # accepted socket must SASL-handshake (ref:
        # SaslDataTransferServer.java), and mirror/push dials handshake
        # with the newest key.
        self.security_keys = security_keys
        self.required_qop = required_qop
        # PROVIDED storage: block id → external alias resolver (wired by
        # the DataNode once it has an NN proxy; ref: ProvidedVolumeImpl
        # reading through the alias map). Cache hits avoid per-read RPCs.
        self.alias_resolver = None
        self.domain_socket_path = None     # set by the owning DataNode
        self.block_tokens = None           # set by the owning DataNode
        self._alias_cache: dict = {}       # block id → (alias, expiry)
        self.ALIAS_CACHE_TTL = 60.0
        self.ALIAS_CACHE_MAX = 4096
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((bind_host, port))
        self._lsock.listen(128)
        # Closing a listening socket does NOT wake a thread blocked in
        # accept(2) on Linux; a periodic timeout lets the accept loop see
        # _running flip and exit instead of leaking (accepted sockets are
        # unaffected — they come back in blocking mode).
        self._lsock.settimeout(0.5)
        self.port = self._lsock.getsockname()[1]
        self._running = False
        self.active_xceivers = 0
        # Explicit injector wins; otherwise resolve the SINGLETON at each
        # use so tests can install one after the daemon started (the
        # reference's injectors are resolved per-call the same way).
        self._fixed_injector = fault_injector
        reg = metrics_system().source(f"datanode.xceiver.{self.port}")
        self._m_writes = reg.counter("blocks_written")
        self._m_reads = reg.counter("blocks_read")
        self._m_bytes_in = reg.counter("bytes_written")
        self._m_bytes_out = reg.counter("bytes_read")
        self._m_short_circuit = reg.counter("short_circuit_grants")
        # log-bucketed op-latency histograms (the /prom exposition's
        # native shape; /jmx sees count/sum/mean of the same series)
        self._m_read_hist = reg.histogram(
            "read_block_seconds", "whole READ_BLOCK op wall time")
        self._m_write_hist = reg.histogram(
            "write_block_seconds", "whole WRITE_BLOCK op wall time")
        # slow-node evidence (ref: DataNodePeerMetrics): rolling
        # per-downstream-peer pipeline ack latency + windowed own
        # service times, published at /ws/v1/peers for the fleet doctor
        from hadoop_tpu_torch.obs.peers import PeerLatencyTracker
        self.peer_tracker = PeerLatencyTracker()
        self._tracer = global_tracer()

    def _fi(self):
        if self._fixed_injector is not None:
            return self._fixed_injector
        from hadoop_tpu_torch.dfs.datanode.datanode import DataNodeFaultInjector
        return DataNodeFaultInjector.get()

    def start(self) -> None:
        self._running = True
        Daemon(self._accept_loop, f"xceiver-server-{self.port}").start()

    def stop(self) -> None:
        self._running = False
        try:
            self._lsock.close()
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, addr = self._lsock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            Daemon(self._serve, f"xceiver-{addr[1]}", args=(sock,)).start()

    def _dial_security(self):
        """Explicit security for DN→DN dials: this DN's own keys when
        secured, else the process default (covers an in-process
        minicluster where the client installed it)."""
        if self.security_keys is None:
            return dt.default_security()
        return dt.TransferSecurity(self.security_keys.newest,
                                   qop=self.required_qop)

    def _serve(self, sock: socket.socket) -> None:
        self.active_xceivers += 1
        try:
            if self.security_keys is not None:
                from hadoop_tpu_torch.security.ugi import AccessControlError
                try:
                    sock = dt.secure_accept(sock, self.security_keys,
                                            self.required_qop)
                except AccessControlError as e:
                    log.warning("xceiver rejected peer: %s", e)
                    return
            req = dt.recv_frame(sock)
            op = req.get("op")
            # Block access tokens gate EVERY op that names a block (ref:
            # DataXceiver.checkAccess before readBlock/writeBlock/
            # copyBlock) — not just the short-circuit grant, or the TCP
            # fallback would bypass the whole scheme.
            if self.block_tokens is not None and op in (
                    dt.OP_WRITE_BLOCK, dt.OP_READ_BLOCK,
                    dt.OP_TRANSFER_BLOCK):
                from hadoop_tpu_torch.dfs.protocol import blocktoken as bt
                from hadoop_tpu_torch.security.ugi import AccessControlError
                mode = {dt.OP_READ_BLOCK: bt.MODE_READ,
                        dt.OP_WRITE_BLOCK: bt.MODE_WRITE,
                        dt.OP_TRANSFER_BLOCK: bt.MODE_COPY}[op]
                bid = Block.from_wire(req["b"]).block_id
                try:
                    try:
                        self.block_tokens.check_access(req.get("tok"),
                                                       bid, mode)
                    except AccessControlError:
                        # striped units carry unit ids; the NN mints one
                        # token per GROUP (ref: LocatedStripedBlock's
                        # per-group token semantics here)
                        from hadoop_tpu_torch.io import erasurecode as ecmod
                        if not ecmod.is_striped_id(bid):
                            raise
                        self.block_tokens.check_access(
                            req.get("tok"), ecmod.group_id_of(bid), mode)
                except AccessControlError as e:
                    dt.send_frame(sock, {"ok": False, "em": str(e),
                                         "denied": True})
                    return
            # Resume the CLIENT's span around the whole op (ref: the
            # HTrace spans DataXceiver opened from the op header). Like
            # the RPC server, no context → no span: sampling is decided
            # at the client root and untraced bulk transfers stay free.
            span_ctx = SpanContext.from_wire(req.get("t"))
            cm = (self._tracer.span(f"dfs.xceiver.{op}", parent=span_ctx)
                  if span_ctx is not None else contextlib.nullcontext())
            t0 = time.monotonic()
            with cm as sp:
                if sp is not None and "b" in req:
                    sp.add_kv("block", str(req["b"].get("id")))
                    sp.add_kv("port", str(self.port))
                # record latency on EVERY edge, not just success — the
                # failed/aborted ops (client died, checksum, mirror
                # failure) are exactly the slow tail the histograms
                # exist to expose
                try:
                    if op == dt.OP_WRITE_BLOCK:
                        self._write_block(sock, req)
                    elif op == dt.OP_READ_BLOCK:
                        self._read_block(sock, req)
                    elif op == dt.OP_TRANSFER_BLOCK:
                        self._transfer_block(sock, req)
                    elif op == dt.OP_SHORT_CIRCUIT:
                        self._short_circuit(sock, req)
                    else:
                        dt.send_frame(sock, {"ok": False,
                                             "em": f"bad op {op!r}"})
                finally:
                    elapsed = time.monotonic() - t0
                    if op == dt.OP_WRITE_BLOCK:
                        self._m_write_hist.add(elapsed)
                        self.peer_tracker.record_self_write(elapsed)
                    elif op == dt.OP_READ_BLOCK:
                        self._m_read_hist.add(elapsed)
                        self.peer_tracker.record_self_read(elapsed)
        except (OSError, EOFError) as e:
            log.debug("xceiver connection error: %s", e)
        except Exception:
            log.exception("xceiver failure")
        finally:
            self.active_xceivers -= 1
            try:
                sock.close()
            except OSError:
                pass

    # -------------------------------------------------------------- writing

    def _write_block(self, up: socket.socket, req: dict) -> None:
        """Ref: DataXceiver.writeBlock:667 + BlockReceiver.receiveBlock:953."""
        block = Block.from_wire(req["b"])
        targets = [DatanodeInfo.from_wire(t) for t in req.get("targets", [])]
        checksum = DataChecksum(req.get("bpc", dt.CHUNK_SIZE))
        self._fi().before_write_block(block)
        xsp = current_span()   # resumed client span (see _serve)
        if xsp is not None:
            # pipeline hop: how many DNs remain DOWNSTREAM of this one
            xsp.add_kv("pipeline_remaining", str(len(targets)))

        down: Optional[socket.socket] = None
        down_name = ""
        if targets:
            nxt, rest = targets[0], targets[1:]
            try:
                down = dt.connect(nxt.xfer_addr(),
                                  security=self._dial_security())
                fwd = dict(req)
                fwd["targets"] = [t.to_wire() for t in rest]
                dt.send_frame(down, fwd)
                setup = dt.recv_frame(down)
                if not setup.get("ok"):
                    raise IOError(
                        f"downstream {nxt} setup failed: {setup.get('em')}")
                down_name = f"{nxt.host}:{nxt.xfer_port}"
            except (OSError, EOFError, IOError) as e:
                # Setup failure: tell upstream which node failed so the client
                # can exclude it (ref: writeBlock's firstBadLink reply).
                dt.send_frame(up, {"ok": False,
                                   "em": f"mirror {nxt} failed: {e}",
                                   "bad_node": nxt.uuid})
                if down is not None:
                    down.close()
                return

        try:
            open_rep = self.store.create_rbw(block, checksum)
        except IOError as e:
            # A re-replication push can race an unreported local replica
            # (IBR lag): tell the sender EXPLICITLY instead of dying with
            # a bare close it retries against forever, and re-announce
            # the replica so the NN stops scheduling the transfer (ref:
            # ReplicaAlreadyExistsException + the IBR that follows).
            already = "already finalized" in str(e)
            if already and req.get("stage") == dt.STAGE_TRANSFER:
                self.on_block_received(block)
            dt.send_frame(up, {"ok": False, "em": str(e),
                               "already": already})
            if down is not None:
                down.close()
            return
        dt.send_frame(up, {"ok": True})

        # Responder: relays downstream acks upstream with our status first.
        # Terminal node acks directly. Ref: BlockReceiver.PacketResponder.
        ack_lock = threading.Lock()
        my_status: dict = {}
        sent_at: dict = {}       # seq -> forward time; guarded-by: ack_lock
        down_uuid = targets[0].uuid if targets else ""
        responder_done = threading.Event()

        def responder():
            try:
                while True:
                    ack = dt.recv_frame(down)
                    now = time.monotonic()
                    with ack_lock:
                        st = my_status.pop(ack["seq"], dt.STATUS_SUCCESS)
                        fwd_t = sent_at.pop(ack["seq"], None)
                    if fwd_t is not None:
                        # forward + downstream ack round trip for THIS
                        # peer: the per-peer signal the doctor's
                        # median/MAD pass runs across (ref: the
                        # SendPacketDownstream timing SlowPeerTracker
                        # aggregates)
                        self.peer_tracker.record(down_uuid, now - fwd_t)
                    dt.send_frame(up, {"seq": ack["seq"],
                                       "statuses": [st] + ack["statuses"],
                                       "last": ack.get("last", False)})
                    if ack.get("last"):
                        return
            except (OSError, EOFError):
                pass
            finally:
                responder_done.set()

        if down is not None:
            Daemon(responder, "packet-responder").start()

        import struct as _struct

        from hadoop_tpu_torch.io.wire import read_frame_buffer, unpack

        ok = True
        try:
            while True:
                # keep the raw frame BUFFER: a mirror forwards it
                # verbatim (no re-encode of the megabyte payload per
                # hop), and receiving into a reusable buffer skips the
                # immutable-bytes copy each hop used to pay
                raw = read_frame_buffer(up)
                pkt = unpack(raw)
                if not isinstance(pkt, dict):
                    raise IOError("malformed packet frame")
                data, sums = pkt.get("data", b""), pkt.get("sums", b"")
                status = dt.STATUS_SUCCESS
                if data:
                    # Verify at the TERMINAL node only — exactly the
                    # reference's rule (BlockReceiver.shouldVerifyChecksum:
                    # mirror nodes forward unverified; the last node's
                    # verdict covers the wire for the whole chain and the
                    # ack path reports which hop corrupted).
                    if down is None:
                        try:
                            checksum.verify(data, sums,
                                            base_pos=pkt.get("off", 0))
                        except ChecksumError as e:
                            log.warning(
                                "Checksum error on %s from upstream: %s",
                                block, e)
                            status = dt.STATUS_ERROR_CHECKSUM
                            ok = False
                    self._fi().before_packet_write(block, pkt)
                    if status == dt.STATUS_SUCCESS:
                        open_rep.write_packet(data, sums)
                        self._m_bytes_in.incr(len(data))
                if down is not None:
                    with ack_lock:
                        my_status[pkt["seq"]] = status
                        sent_at[pkt["seq"]] = time.monotonic()
                    # two sends, zero copies: the old prefix+payload
                    # concatenation copied the whole packet per hop
                    down.sendall(_struct.pack(">I", len(raw)))
                    down.sendall(raw)
                else:
                    dt.send_frame(up, {"seq": pkt["seq"], "statuses": [status],
                                       "last": pkt.get("last", False)})
                if status == dt.STATUS_ERROR_CHECKSUM:
                    # The ack above carries the verdict; tear down NOW.
                    # Accepting later packets would append them after the
                    # missing one — a silent mid-replica hole whose
                    # recomputed CRCs verify — and a client crash would
                    # leave that holed rbw for recovery to finalize. The
                    # client rebuilds the pipeline from the acked prefix.
                    break
                if pkt.get("last"):
                    break
            if xsp is not None:
                xsp.add_kv("bytes", str(open_rep.num_bytes))
                xsp.add_kv("crc_ok", str(ok).lower())
            if ok:
                block.num_bytes = open_rep.num_bytes
                rep = self.store.finalize(open_rep)
                self._m_writes.incr()
                self.on_block_received(rep.to_block())
            else:
                open_rep.abort()
        except (OSError, EOFError) as e:
            # Writer vanished mid-block. KEEP the partial rbw replica on
            # disk — block recovery may finalize it at this length (the rbw
            # directory exists exactly for this; ref: ReplicaBeingWritten
            # surviving pipeline failure, BlockRecoveryWorker).
            log.debug("write of %s interrupted: %s (rbw retained, %d bytes)",
                      block, e, open_rep.num_bytes)
            try:
                open_rep.fsync()
            except OSError:
                pass
            open_rep.close()
        finally:
            if down is not None:
                responder_done.wait(timeout=5.0)
                down.close()

    def _transfer_block(self, sock: socket.socket, req: dict) -> None:
        """Balancer/mover-commanded copy: push a local finalized replica
        to the given targets (ref: DataXceiver.replaceBlock's role — the
        receiving side of Dispatcher.PendingMove, driven here from the
        source)."""
        block = Block.from_wire(req["b"])
        targets = [DatanodeInfo.from_wire(t) for t in req.get("targets", [])]
        try:
            push_block(self.store, block, targets,
                       security=self._dial_security(),
                       block_tokens=self.block_tokens)
        except (OSError, IOError) as e:
            dt.send_frame(sock, {"ok": False, "em": str(e)})
            return
        dt.send_frame(sock, {"ok": True})

    # -------------------------------------------------------------- reading

    def _short_circuit(self, sock: socket.socket, req: dict) -> None:
        """Short-circuit DISCOVERY only: point the client at the DN's
        AF_UNIX fd-passing socket (ref: DataXceiver.requestShortCircuitFds
        + dfs.domain.socket.path). The old path handoff is gone — a
        client that must authenticate to read over TCP could previously
        open any local replica by path; now possession of the replica
        requires the SCM_RIGHTS grant, which checks the block token
        (see datanode/domainsocket.py)."""
        path = self.domain_socket_path
        if path:
            self._m_short_circuit.incr()
            dt.send_frame(sock, {"ok": False, "domain_socket": path,
                                 "em": "use the domain socket for fds"})
        else:
            dt.send_frame(sock, {
                "ok": False,
                "em": "short-circuit path handoff removed; enable "
                      "dfs.domain.socket.path for fd-passing grants"})

    def _read_block(self, sock: socket.socket, req: dict) -> None:
        """Ref: BlockSender.java — chunk-aligned stream with stored sums."""
        block = Block.from_wire(req["b"])
        offset = req.get("offset", 0)
        length = req.get("length", 1 << 62)
        self._fi().before_read_block(block, self.port)
        bpc = dt.CHUNK_SIZE
        try:
            # Probe EAGERLY — read_chunks is a lazy generator, and a
            # replica-not-found must choose the PROVIDED fallback before
            # the setup reply, not explode mid-stream. The probe result
            # feeds read_chunks so the meta header parses once.
            opened = self.store.open_for_read(block)
            bpc = opened[2].bytes_per_chunk
            chunks = self.store.read_chunks(block, offset, length,
                                            opened=opened)
        except IOError as e:
            chunks = self._provided_chunks(block, offset, length)
            if chunks is None:
                dt.send_frame(sock, {"ok": False, "em": str(e)})
                return
        # The reply carries the replica's stored bytes-per-checksum so
        # readers verify with the WRITER's chunking, not their default
        # (ref: OpReadBlock's ReadOpChecksumInfoProto).
        dt.send_frame(sock, {"ok": True, "bpc": bpc})
        seq = 0
        sent = 0
        for pos, data, sums in chunks:
            data, sums = self._fi().corrupt_read_packet(block, data, sums)
            dt.send_frame(sock, {"seq": seq, "off": pos, "data": data,
                                 "sums": sums, "last": False})
            self._m_bytes_out.incr(len(data))
            sent += len(data)
            seq += 1
        dt.send_frame(sock, {"seq": seq, "off": 0, "data": b"", "sums": b"",
                             "last": True})
        self._m_reads.incr()
        xsp = current_span()   # resumed client span (see _serve)
        if xsp is not None:
            xsp.add_kv("bytes", str(sent))
            xsp.add_kv("offset", str(offset))


    def _provided_chunks(self, block: Block, offset: int, length: int):
        """Serve a PROVIDED block by range-reading the external store
        and computing chunk CRCs on the fly (ref: ProvidedVolumeImpl's
        FileRegion reads — the DN is a caching/streaming proxy for data
        that lives outside the cluster)."""
        now = time.monotonic()
        hit = self._alias_cache.get(block.block_id)
        alias = hit[0] if hit and hit[1] > now else None
        if alias is None and self.alias_resolver is not None:
            try:
                alias = self.alias_resolver(block.block_id)
            except Exception as e:  # noqa: BLE001 — NN transient
                log.debug("alias lookup for blk_%d failed: %s",
                          block.block_id, e)
                alias = None
            if alias:
                # TTL bounds the serve-after-delete window; size cap
                # bounds memory (coarse clear — aliases re-resolve).
                if len(self._alias_cache) >= self.ALIAS_CACHE_MAX:
                    self._alias_cache.clear()
                self._alias_cache[block.block_id] = (
                    alias, now + self.ALIAS_CACHE_TTL)
        if not alias:
            return None
        from hadoop_tpu_torch.fs import get_filesystem
        from hadoop_tpu_torch.util.crc import DataChecksum

        def gen():
            checksum = DataChecksum(dt.CHUNK_SIZE)
            bpc = checksum.bytes_per_chunk
            visible = min(block.num_bytes, alias["length"])
            start = (offset // bpc) * bpc
            end = min(visible, offset + length)
            fs = get_filesystem(alias["uri"])
            try:
                with fs.open(_alias_path(alias["uri"])) as f:
                    pos = start
                    while pos < end:
                        n = min(1024 * 1024, end - pos)
                        n = min(((n + bpc - 1) // bpc) * bpc,
                                visible - pos)
                        if hasattr(f, "pread"):
                            data = f.pread(alias["offset"] + pos, n)
                        else:
                            f.seek(alias["offset"] + pos)
                            data = f.read(n)
                        if not data:
                            break
                        sums = checksum.checksums_for(data)
                        yield pos, data, sums
                        pos += len(data)
            finally:
                close = getattr(fs, "close", None)
                if close is not None:
                    close()
        return gen()


def _alias_path(uri: str) -> str:
    from urllib.parse import urlparse
    return urlparse(uri).path or "/"


def push_block(store: BlockStore, block: Block,
               targets: List[DatanodeInfo],
               security=None, block_tokens=None) -> None:
    """Re-replication push: stream a local finalized replica into a pipeline
    of targets. Ref: DataNode.DataTransfer (new Sender().writeBlock for
    TRANSFER stage; it mints its own token via the DN's shared keys —
    blockTokenSecretManager.generateToken in DataNode.transferBlock)."""
    if not targets:
        return
    req = {
        "op": dt.OP_WRITE_BLOCK, "b": block.to_wire(),
        "targets": [t.to_wire() for t in targets[1:]],
        "stage": dt.STAGE_TRANSFER, "bpc": dt.CHUNK_SIZE,
    }
    from hadoop_tpu_torch.tracing import current_context
    ctx = current_context()
    if ctx is not None:
        req["t"] = ctx.to_wire()
    if block_tokens is not None:
        from hadoop_tpu_torch.dfs.protocol import blocktoken as bt
        req["tok"] = block_tokens.generate_token(
            "datanode", block.block_id, (bt.MODE_WRITE,))
    sock = dt.connect(targets[0].xfer_addr(), security=security)
    try:
        dt.send_frame(sock, req)
        setup = dt.recv_frame(sock)
        if not setup.get("ok"):
            if setup.get("already"):
                return  # target already holds the replica — push done
            raise IOError(f"transfer setup failed: {setup.get('em')}")
        seq = 0
        for pos, data, sums in store.read_chunks(block, 0, block.num_bytes):
            dt.send_frame(sock, {"seq": seq, "off": pos, "data": data,
                                 "sums": sums, "last": False})
            seq += 1
        dt.send_frame(sock, {"seq": seq, "off": 0, "data": b"", "sums": b"",
                             "last": True})
        # Drain acks until last.
        while True:
            ack = dt.recv_frame(sock)
            if any(s != dt.STATUS_SUCCESS for s in ack["statuses"]):
                raise IOError(f"transfer ack failure: {ack}")
            if ack.get("last"):
                break
    finally:
        sock.close()
