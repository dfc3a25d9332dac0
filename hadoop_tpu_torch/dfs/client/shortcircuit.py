"""Short-circuit local reads: fd-passing grants, no DataNode data path.

The port's copy of ``hadoop_tpu/dfs/client/shortcircuit.py``. When a
replica lives on the reader's own host, the client asks the DataNode's
AF_UNIX socket for the replica's open file descriptors (SCM_RIGHTS,
``socket.recv_fds``) and from then on reads the block file directly,
still verifying the stored CRCs against the meta file (its header is
``4 + 8 + DataChecksum.HEADER_LEN`` bytes).

The grant is gated on the block access token when the cluster has
``dfs.block.access.token.enable`` on: a client that could not read the
block over TCP cannot open it locally either. The socket's path is the
``dfs.domain.socket.path`` template with ``_PORT`` replaced by the
DataNode's transfer port, or, without the key, what one TCP
``short_circuit`` op to the DataNode returns. Slots are cached per
(DataNode, block, generation stamp), LRU-bounded, refcounted so an
eviction never closes descriptors a read still holds; any IO or
checksum error drops the slot and the TCP path takes over.
"""

from __future__ import annotations

import collections
import logging
import os
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
from hadoop_tpu_torch.dfs.protocol.records import Block, DatanodeInfo
from hadoop_tpu_torch.io.wire import pack, unpack
from hadoop_tpu_torch.util.crc import DataChecksum

log = logging.getLogger(__name__)


def local_host_names() -> set:
    """Names and addresses that mean this host."""
    names = {"127.0.0.1", "localhost", "::1"}
    try:
        hn = socket.gethostname()
        names.add(hn)
        names.add(socket.gethostbyname(hn))
    except OSError:
        pass
    return names


class ShortCircuitUnavailable(Exception):
    """Fall back to the TCP reader (no domain socket, token refused at
    discovery time, replica moved, ...)."""


class _Slot:
    """Refcounted fd pair (ref: ShortCircuitCache's slot refcounting):
    eviction/invalidation must never close descriptors a concurrent
    read() still holds — a reused fd number would make that reader
    pread ANOTHER block's bytes and report a healthy replica corrupt.
    ``refs``/``dead`` transitions happen under the cache lock; the last
    releaser closes."""

    __slots__ = ("data_fd", "meta_fd", "bpc", "visible", "refs", "dead")

    def __init__(self, data_fd: int, meta_fd: int, bpc: int, visible: int):
        self.data_fd = data_fd
        self.meta_fd = meta_fd
        self.bpc = bpc
        self.visible = visible
        self.refs = 0
        self.dead = False

    def _close_now(self) -> None:
        for fd in (self.data_fd, self.meta_fd):
            try:
                os.close(fd)
            except OSError:
                pass
        self.data_fd = self.meta_fd = -1


class ShortCircuitCache:
    """Per-process replica-fd cache, LRU-bounded (ref:
    ShortCircuitCache.java:72 — it caches replica slots the same way;
    the size cap bounds open-fd usage at 2×MAX_SLOTS descriptors)."""

    MAX_SLOTS = 256

    _instance: Optional["ShortCircuitCache"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._slots: "collections.OrderedDict[Tuple, _Slot]" = \
            collections.OrderedDict()
        self._lock = threading.Lock()
        self._local = local_host_names()
        self._socket_paths: Dict[str, str] = {}   # dn uuid → AF_UNIX path
        self.hits = 0
        self.requests = 0

    @classmethod
    def get(cls) -> "ShortCircuitCache":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def is_local(self, dn: DatanodeInfo) -> bool:
        return dn.host in self._local

    # ------------------------------------------------------------ plumbing

    def _socket_path(self, dn: DatanodeInfo, template: str) -> str:
        if template:
            return template.replace("_PORT", str(dn.xfer_port))
        path = self._socket_paths.get(dn.uuid)
        if path:
            return path
        # one-time TCP discovery: the DN advertises its domain socket
        sock = dt.connect(dn.xfer_addr(), timeout=10.0)
        try:
            dt.send_frame(sock, {"op": dt.OP_SHORT_CIRCUIT})
            resp = dt.recv_frame(sock)
        finally:
            sock.close()
        path = resp.get("domain_socket") or ""
        if not path:
            raise ShortCircuitUnavailable(
                resp.get("em", "DN offers no domain socket"))
        self._socket_paths[dn.uuid] = path
        return path

    def _request_fds(self, path: str, block: Block,
                     token: Optional[Dict]) -> _Slot:
        """REQUEST_FDS over AF_UNIX; fds arrive via SCM_RIGHTS."""
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        fds: list = []
        try:
            sock.settimeout(10.0)
            try:
                sock.connect(path)
            except OSError as e:
                raise ShortCircuitUnavailable(
                    f"domain socket {path}: {e}") from e
            req = {"b": block.to_wire()}
            if token is not None:
                req["tok"] = token
            frame = pack(req)
            sock.sendall(struct.pack(">I", len(frame)) + frame)
            # the reply frame and the fds ride one sendmsg; drain until
            # the full length-prefixed frame is in hand
            buf = bytearray()
            while len(buf) < 4:
                chunk, newfds, _, _ = socket.recv_fds(sock, 1 << 16, 2)
                if not chunk and not newfds:
                    raise ShortCircuitUnavailable("DN closed fd channel")
                fds.extend(newfds)
                buf += chunk
            (flen,) = struct.unpack_from(">I", buf)
            while len(buf) < 4 + flen:
                chunk, newfds, _, _ = socket.recv_fds(sock, 1 << 16, 2)
                if not chunk and not newfds:
                    break
                fds.extend(newfds)
                buf += chunk
            if len(buf) < 4 + flen:
                # DN died mid-reply; a truncated frame must degrade to
                # the TCP path, not surface a decode error to read()
                raise ShortCircuitUnavailable(
                    f"truncated fd-grant reply ({len(buf)}/{4 + flen}B)")
            try:
                resp = unpack(bytes(buf[4:4 + flen]))
            except Exception as e:  # WireError/garbage: same degrade
                raise ShortCircuitUnavailable(
                    f"undecodable fd-grant reply: {e}") from e
            if not resp.get("ok"):
                raise ShortCircuitUnavailable(resp.get("em", "refused"))
            if len(fds) != 2 or "bpc" not in resp or "visible" not in resp:
                raise ShortCircuitUnavailable(
                    f"malformed fd grant (fds={len(fds)})")
            bpc = resp["bpc"]
            if not isinstance(bpc, int) or not 0 < bpc <= (1 << 20):
                raise ShortCircuitUnavailable(
                    f"fd grant carries invalid bytes-per-checksum {bpc!r}")
            slot = _Slot(fds[0], fds[1], bpc, resp["visible"])
            fds = []  # ownership moved into the slot
            return slot
        finally:
            for fd in fds:
                try:
                    os.close(fd)
                except OSError:
                    pass
            sock.close()

    def _slot_for(self, dn: DatanodeInfo, block: Block,
                  token: Optional[Dict], template: str) -> _Slot:
        # keyed per REPLICA (dn included): every same-host DN holds its own
        # copy, and a corrupt copy must not shadow the healthy ones
        key = (dn.uuid, block.block_id, block.gen_stamp)
        with self._lock:
            slot = self._slots.get(key)
            if slot is not None:
                self._slots.move_to_end(key)
                self._acquire_locked(slot)
        if slot is not None:
            return slot
        self.requests += 1
        try:
            path = self._socket_path(dn, template)
            slot = self._request_fds(path, block, token)
        except ShortCircuitUnavailable:
            # a discovered socket path may be stale (DN restarted onto a
            # new path) — drop it so the next attempt rediscovers
            # instead of paying a failing connect forever
            self._socket_paths.pop(dn.uuid, None)
            raise
        with self._lock:
            have = self._slots.get(key)
            if have is not None:
                # lost a race: keep the existing slot, drop ours
                self._retire_locked(slot)
                slot = have
            else:
                self._slots[key] = slot
            self._slots.move_to_end(key)
            self._acquire_locked(slot)
            while len(self._slots) > self.MAX_SLOTS:
                self._retire_locked(self._slots.popitem(last=False)[1])
        return slot

    def _acquire_locked(self, slot: _Slot) -> None:
        slot.refs += 1

    def _release(self, slot: _Slot) -> None:
        with self._lock:
            slot.refs -= 1
            if slot.dead and slot.refs == 0:
                slot._close_now()

    def _retire_locked(self, slot: _Slot) -> None:
        slot.dead = True
        if slot.refs == 0:
            slot._close_now()

    def invalidate(self, block: Block, dn: Optional[DatanodeInfo] = None
                   ) -> None:
        with self._lock:
            for key in [k for k in self._slots
                        if k[1] == block.block_id
                        and k[2] == block.gen_stamp
                        and (dn is None or k[0] == dn.uuid)]:
                self._retire_locked(self._slots.pop(key))

    # ---------------------------------------------------------------- read

    META_HEADER = 4 + 8 + DataChecksum.HEADER_LEN

    def read(self, dn: DatanodeInfo, block: Block, offset: int,
             want: int, token: Optional[Dict] = None,
             socket_template: str = "") -> bytes:
        """Read [offset, offset+want) of a local replica, CRC-verified.
        Raises ShortCircuitUnavailable to punt to the TCP reader; raises
        ChecksumError (like the remote path) on real corruption."""
        slot = self._slot_for(dn, block, token, socket_template)
        try:
            try:
                bpc = slot.bpc
                avail = min(want, slot.visible - offset)
                if avail <= 0:
                    return b""
                # chunk-align both edges: stored CRCs cover whole chunks
                start = (offset // bpc) * bpc
                end = min(slot.visible,
                          (offset + avail + bpc - 1) // bpc * bpc)
                data = os.pread(slot.data_fd, end - start, start)
                first_chunk = start // bpc
                n_chunks = (len(data) + bpc - 1) // bpc
                sums = os.pread(slot.meta_fd, 4 * n_chunks,
                                self.META_HEADER + 4 * first_chunk)
            except OSError as e:
                # fd went bad under us — forget it, use TCP
                self.invalidate(block, dn)
                raise ShortCircuitUnavailable(str(e)) from e
            try:
                DataChecksum(bpc).verify(data, sums, base_pos=start)
            except Exception:
                self.invalidate(block, dn)  # corrupt copy: never re-serve
                raise
            self.hits += 1
            return data[offset - start:offset - start + avail]
        finally:
            self._release(slot)
