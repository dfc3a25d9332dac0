"""AF_UNIX fd-passing server: short-circuit grants without path handoff.

The port's copy of ``hadoop_tpu/dfs/datanode/domainsocket.py``, on the
same wire and disk formats.

Parity with the reference's domain-socket transport (ref:
hadoop-common/src/main/native/src/org/apache/hadoop/net/unix/
DomainSocket.c; server side DataXceiver.requestShortCircuitFds;
configured by ``dfs.domain.socket.path`` with a ``_PORT`` placeholder):
a same-host client connects to the DN's Unix socket, presents the
block (+ its access token when ``dfs.block.access.token.enable`` is
on), and receives the replica's OPEN file descriptors via
``SCM_RIGHTS`` — the DN never reveals filesystem paths, so possession
of a grant is bounded by the token check, not by directory
permissions. Python's ``socket.send_fds``/``recv_fds`` replace the
reference's JNI layer.

Revocation model: an fd snapshot of a FINALIZED replica stays
byte-correct even if the balancer later moves or deletes the file
(POSIX keeps unlinked data readable through open fds), and append/
recovery bumps the genstamp, which changes the client's cache key —
so no shared-memory slot-revocation plane (ShortCircuitShm.java) is
needed for correctness; the reference adds it to reclaim space
eagerly, which this design trades for simplicity.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
from typing import Callable, Optional

from hadoop_tpu_torch.dfs.protocol.records import Block
from hadoop_tpu_torch.io.wire import pack, unpack
from hadoop_tpu_torch.security.ugi import AccessControlError
from hadoop_tpu_torch.util.misc import Daemon

log = logging.getLogger(__name__)

MAX_REQ = 1 << 20


class DomainPeerServer:
    """Per-DN Unix-socket listener serving REQUEST_FDS.

    ``token_checker(req, block)`` raises AccessControlError to refuse
    (None = tokens disabled). ``open_for_read`` is the blockstore's
    resolver returning (data_path, meta_path, checksum, visible).
    """

    def __init__(self, path: str, open_for_read: Callable,
                 token_checker: Optional[Callable] = None):
        self.path = path
        self.open_for_read = open_for_read
        self.token_checker = token_checker
        self._lsock: Optional[socket.socket] = None
        self._running = False
        self.grants = 0

    def start(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._lsock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._lsock.bind(self.path)
        # rw for owner only: the socket itself is the first gate
        os.chmod(self.path, 0o600)
        self._lsock.listen(64)
        self._running = True
        Daemon(self._accept_loop,
               f"domain-peer-{os.path.basename(self.path)}").start()

    def stop(self) -> None:
        self._running = False
        if self._lsock is not None:
            try:
                self._lsock.close()
            except OSError:
                pass
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def _accept_loop(self) -> None:
        while self._running:
            try:
                sock, _ = self._lsock.accept()
            except OSError:
                return
            Daemon(self._serve, "domain-peer-conn", args=(sock,)).start()

    def _serve(self, sock: socket.socket) -> None:
        try:
            with sock:
                sock.settimeout(10.0)
                try:
                    from hadoop_tpu_torch.io.wire import read_frame
                    req = unpack(read_frame(sock, MAX_REQ))
                except (OSError, EOFError, ValueError):
                    return
                if not isinstance(req, dict) or "b" not in req:
                    self._reply(sock, {"ok": False, "em": "bad request"})
                    return
                block = Block.from_wire(req["b"])
                if self.token_checker is not None:
                    try:
                        self.token_checker(req, block)
                    except AccessControlError as e:
                        self._reply(sock, {"ok": False, "em": str(e),
                                           "denied": True})
                        return
                try:
                    data_path, meta_path, checksum, visible = \
                        self.open_for_read(block)
                except IOError as e:
                    self._reply(sock, {"ok": False, "em": str(e)})
                    return
                data_fd = meta_fd = -1
                try:
                    data_fd = os.open(data_path, os.O_RDONLY)
                    meta_fd = os.open(meta_path, os.O_RDONLY)
                    frame = pack({"ok": True,
                                  "bpc": checksum.bytes_per_chunk,
                                  "visible": visible})
                    socket.send_fds(
                        sock, [struct.pack(">I", len(frame)) + frame],
                        [data_fd, meta_fd])
                    self.grants += 1
                except OSError as e:
                    log.debug("fd grant for %s failed: %s", block, e)
                finally:
                    # the kernel dup'ed them into the message; close ours
                    for fd in (data_fd, meta_fd):
                        if fd >= 0:
                            try:
                                os.close(fd)
                            except OSError:
                                pass
        except Exception:  # noqa: BLE001 — one bad peer must not kill the loop
            log.debug("domain peer connection error", exc_info=True)

    @staticmethod
    def _reply(sock: socket.socket, msg: dict) -> None:
        from hadoop_tpu_torch.io.wire import write_frame
        try:
            write_frame(sock, pack(msg))
        except OSError:
            pass


def socket_path_for(template: str, xfer_port: int) -> str:
    """Expand the ``_PORT`` placeholder (ref: DomainSocket.getEffectivePath
    applied to dfs.domain.socket.path)."""
    return template.replace("_PORT", str(xfer_port))
