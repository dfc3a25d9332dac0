"""DFSClient: the NameNode proxy, leases and stream factories.

The port's copy of ``hadoop_tpu/dfs/client/dfsclient.py``. It holds:

- the ClientProtocol proxy to the NameNode(s), wrapped in
  ``ipc/retry.py``'s ``failover_on_network_exception`` over the given
  addresses (an HA pair fails over); the proxy's own retries are off,
  the handler's policy decides, with idempotency from
  :class:`_ClientProtocolDecl`;
- observer reads (``dfs.client.observer.reads.enabled`` with more than
  one address): the pure namespace reads try an observer NameNode
  first, after one ``msync`` to the active seeds the state id the RPC
  layer carries, and fall back to the active on any failure;
- a client name for lease identity and a renewer thread that renews at
  half of ``dfs.lease.soft-limit`` (at most every 2 s) while any file
  is open for write;
- the hedged-read pool (``dfs.client.hedged.read.threadpool.size``),
  whose tasks run under the submitting thread's span
  (``tracing.carry_context``) and which refuses a hedge when every
  worker is busy, so the caller reads in line instead of queueing;
- data-transfer encryption (``dfs.encrypt.data.transfer``): the
  NameNode's data encryption key, fetched on demand, installs the
  process's dial-side ``TransferSecurity`` with QoP
  ``dfs.data.transfer.protection`` (privacy by default).

``close()`` stops the renewer, the hedged pool and the RPC client's
connections (their receive threads end with them), and uninstalls the
transfer security it installed.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.dfs.client.streams import (DFSInputStream,
                                                 DFSOutputStream,
                                                 HEDGED_READ_POOL_SIZE_KEY)
from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
from hadoop_tpu_torch.dfs.protocol.records import (Block, FileStatus,
                                                   LocatedBlock)
from hadoop_tpu_torch.ipc.client import Client
from hadoop_tpu_torch.ipc.errors import RpcError
from hadoop_tpu_torch.ipc.retry import (RetryInvocationHandler,
                                        RetryPolicies,
                                        StaticFailoverProxyProvider)
from hadoop_tpu_torch.ipc.rpc import RETRY_RNG, get_proxy, idempotent
from hadoop_tpu_torch.tracing import carry_context

log = logging.getLogger(__name__)


class _ClientProtocolDecl:
    """Idempotency declarations for the proxy (mirrors the server's
    ClientProtocol annotations)."""
    _idem = idempotent

    @_idem
    def get_block_locations(self): ...
    @_idem
    def get_file_info(self): ...
    @_idem
    def listing(self): ...
    @_idem
    def content_summary(self): ...
    @_idem
    def renew_lease(self): ...
    @_idem
    def get_stats(self): ...
    @_idem
    def get_datanode_report(self): ...
    @_idem
    def get_service_status(self): ...
    @_idem
    def msync(self): ...
    @_idem
    def get_ec_policy(self): ...
    @_idem
    def get_ec_policies(self): ...
    @_idem
    def get_data_encryption_key(self): ...


class DFSClient:
    _counter = 0
    _counter_lock = threading.Lock()

    def __init__(self, nn_addrs, conf: Optional[ConfLike] = None):
        """``nn_addrs``: one (host, port) or a list of them (HA failover)."""
        self.conf = conf or Configuration()
        if isinstance(nn_addrs, tuple):
            nn_addrs = [nn_addrs]
        self.nn_addrs = nn_addrs
        with DFSClient._counter_lock:
            DFSClient._counter += 1
            n = DFSClient._counter
        # a lease holder's name: unique across every client of this
        # process, whichever package it comes from
        self.client_name = f"DFSClient_{os.getpid()}_torch_{n}"
        self._rpc_client = Client(self.conf)
        provider = StaticFailoverProxyProvider(self._nn_proxy, nn_addrs)
        policy = RetryPolicies.failover_on_network_exception(
            max_failovers=len(nn_addrs) * 4, delay_s=0.3)
        self.nn = RetryInvocationHandler(provider, policy,
                                         idempotent=_is_idempotent)
        # observer reads: idempotent namespace reads to an observer NN,
        # the rest to the active; an msync first seeds the state id
        if self.conf.get_bool("dfs.client.observer.reads.enabled", False) \
                and len(nn_addrs) > 1:
            self.nn = _ObserverReadProxy(self.nn, self, nn_addrs)
        # Data-transfer encryption (ref: DFSClient's
        # SaslDataTransferClient under dfs.encrypt.data.transfer): fetch
        # the NN's current key and install the process dial-side default
        # so every data socket — pipeline, pread, striped, balancer —
        # handshakes before the first op frame.
        self.transfer_security = None
        if self.conf.get_bool("dfs.encrypt.data.transfer", False):
            self.transfer_security = dt.TransferSecurity(
                lambda: self.nn.get_data_encryption_key(),
                qop=self.conf.get("dfs.data.transfer.protection",
                                  "privacy"))
            dt.set_default_security(self.transfer_security)
        self._block_sizes: Dict[str, int] = {}
        self._hedged_pool = None
        self._hedged_pool_lock = threading.Lock()
        self._hedged_inflight = 0   # submitted, not yet finished
        self.hedged_reads = 0   # hedges started (metric parity:
        self.hedged_wins = 0    # DFSHedgedReadMetrics)
        self._open_files = 0
        self._renewer_lock = threading.Lock()
        self._renewer_stop: Optional[threading.Event] = None

    def _nn_proxy(self, addr):
        """A ClientProtocol stub with no retries of its own: the retry
        handler around it decides."""
        return get_proxy("ClientProtocol", addr, client=self._rpc_client,
                         max_retries=0)

    # ----------------------------------------------------------- streams

    def create(self, path: str, overwrite: bool = False,
               replication: Optional[int] = None,
               block_size: Optional[int] = None):
        st = FileStatus.from_wire(
            self.nn.create(path, self.client_name, replication, block_size,
                           overwrite))
        self._block_sizes[path] = st.block_size
        self._writer_opened()
        if st.ec_policy:
            from hadoop_tpu_torch.dfs.client.striped import \
                DFSStripedOutputStream
            stream = DFSStripedOutputStream(self, path, st.ec_policy)
        else:
            # dfs.client-write-packet-size: 1 MB, the per-packet cost
            # being a Python thread handoff chain
            pkt = self.conf.get_size_bytes(
                "dfs.client-write-packet-size", dt.PACKET_SIZE)
            # ref: dfs.bytes-per-checksum — the replica's meta stores the
            # writer's chunking and read setup replies echo it back, so
            # any reader verifies with the right bpc
            bpc = self.conf.get_size_bytes(
                "dfs.bytes-per-checksum", dt.CHUNK_SIZE)
            # Write-pipeline depth (STORAGE_BENCH showed writes at ~1/6
            # of read throughput; the pipe per hop held ~1 packet):
            # outstanding-ack window (ref: the reference's 80-packet
            # dataQueue bound) + per-hop socket buffer sizing.
            window = self.conf.get_int(
                "dfs.client.write.max-packets-in-flight", 64)
            sock_buf = self.conf.get_size_bytes(
                "dfs.client.write.socket.buffer", 0)
            stream = DFSOutputStream(self, path, packet_size=pkt,
                                     chunk_size=bpc,
                                     max_packets_in_flight=window,
                                     socket_buffer=sock_buf)
        orig_close = stream.close

        def close_and_release():
            try:
                orig_close()
            finally:
                self._writer_closed()
        stream.close = close_and_release  # type: ignore[method-assign]
        return stream

    def open(self, path: str):
        # One NN round trip: the located blocks carry the EC marker, so the
        # stream type is chosen from the same response the stream consumes.
        info = self.get_block_locations(path)
        blocks = info.get("blocks", [])
        if blocks and blocks[0].get("ec"):
            from hadoop_tpu_torch.dfs.client.striped import \
                DFSStripedInputStream
            return DFSStripedInputStream(self, path, info)
        return DFSInputStream(self, path, info)

    # ----------------------------------------------------- erasure coding

    def set_ec_policy(self, path: str, policy: Optional[str]) -> bool:
        return self.nn.set_ec_policy(path, policy)

    def get_ec_policy(self, path: str) -> Optional[str]:
        return self.nn.get_ec_policy(path)

    # ------------------------------------------------- stream callbacks

    def allocate_block(self, path: str, previous: Optional[Dict],
                       exclude: List[str]) -> LocatedBlock:
        return LocatedBlock.from_wire(
            self.nn.add_block(path, self.client_name, previous, exclude))

    def abandon_block(self, path: str, block: Block) -> None:
        self.nn.abandon_block(path, self.client_name, block.to_wire())

    def complete_file(self, path: str, last: Optional[Dict]) -> None:
        # Millisecond-scale early rungs: DNs enqueue the incremental
        # block report the moment a replica finalizes (immediate-IBR
        # wake in _BPServiceActor), so the NN usually learns of the
        # last block within a few ms of our final ack — the reference's
        # 400 ms initial delay (locateFollowingBlock.initial.delay.ms)
        # is sized for its heartbeat-batched IBR path, not this one.
        for backoff in (0.003, 0.01, 0.03, 0.1, 0.4, 0.8, 1.6, 3.2, 6.4):
            if self.nn.complete(path, self.client_name, last):
                return
            # jittered ladder (ref: DFSOutputStream.completeFile loop):
            # many writers closing together must not re-poll in phase
            time.sleep(backoff * (0.5 + RETRY_RNG.random()))
        raise IOError(f"could not complete {path}: min replication not met")

    def block_size_for(self, path: str) -> int:
        bs = self._block_sizes.get(path)
        if bs is None:
            st = FileStatus.from_wire(self.nn.get_file_info(path))
            bs = st.block_size
        return bs

    def get_block_locations(self, path: str) -> Dict:
        return self.nn.get_block_locations(path)

    def report_bad_block(self, block: Block, dn_uuid: str) -> None:
        try:
            self.nn.report_bad_blocks([block.to_wire()], [dn_uuid])
        except Exception as e:  # noqa: BLE001 — best effort
            log.debug("report_bad_blocks failed: %s", e)

    # ------------------------------------------------------ lease renewer

    def _writer_opened(self) -> None:
        with self._renewer_lock:
            self._open_files += 1
            if self._renewer_stop is None:
                self._renewer_stop = threading.Event()
                threading.Thread(target=self._renew_loop, daemon=True,
                                 name=f"lease-renewer-{self.client_name}"
                                 ).start()

    def _writer_closed(self) -> None:
        with self._renewer_lock:
            self._open_files -= 1

    def _renew_loop(self) -> None:
        """Ref: LeaseRenewer.run — renew at half the soft limit."""
        interval = self.conf.get_time_seconds("dfs.lease.soft-limit", 60.0) / 2
        stop = self._renewer_stop
        while not stop.wait(min(interval, 2.0)):
            with self._renewer_lock:
                if self._open_files <= 0:
                    continue
            try:
                self.nn.renew_lease(self.client_name)
            except Exception as e:  # noqa: BLE001
                log.warning("lease renewal failed: %s", e)

    def hedged_pool(self):
        """Shared executor for hedged reads (ref: DFSClient
        .initThreadsNumForHedgedReads)."""
        with self._hedged_pool_lock:
            if self._hedged_pool is None:
                size = self.conf.get_int(HEDGED_READ_POOL_SIZE_KEY, 0)
                # only reached when streams saw a nonzero pool size;
                # clamp so a racing reconfigure still gets a live pool
                self._hedged_workers = max(2, size)
                self._hedged_pool = ThreadPoolExecutor(
                    max_workers=self._hedged_workers,
                    thread_name_prefix="hedged-read")
            return self._hedged_pool

    def hedged_submit(self, fn, *args):
        """Submit a hedged task tracking in-flight count, or None when
        the pool is saturated by straggling losers — the caller falls
        back to its sequential path instead of queueing a NEW read
        behind stuck threads (the reference gets the same property from
        a SynchronousQueue + CallerRunsPolicy)."""
        pool = self.hedged_pool()
        with self._hedged_pool_lock:
            if self._hedged_inflight >= self._hedged_workers:
                return None
            self._hedged_inflight += 1
        # span-aware seam: the pool thread reads the SUBMITTING thread's
        # active span, so a hedge's DN read joins the read's trace
        fut = pool.submit(carry_context(fn), *args)

        def _done(_f):
            with self._hedged_pool_lock:
                self._hedged_inflight -= 1
        fut.add_done_callback(_done)
        return fut

    def close(self) -> None:
        if self._renewer_stop is not None:
            self._renewer_stop.set()
        self._rpc_client.stop()
        if self._hedged_pool is not None:
            self._hedged_pool.shutdown(wait=False)
        if self.transfer_security is not None:
            # Uninstall only if still ours: a newer client may have
            # replaced the process default.
            if dt.default_security() is self.transfer_security:
                dt.set_default_security(None)


_OBSERVER_READS = frozenset({
    # Pure namespace reads an observer may serve (ref: the @ReadOnly
    # annotations ObserverReadProxyProvider honors). renew_lease and
    # report_bad_blocks are idempotent but mutate active-side state.
    "get_block_locations", "get_file_info", "listing", "content_summary",
    "get_stats", "get_datanode_report", "get_ec_policy", "get_ec_policies",
})


class _ObserverReadProxy:
    """Read-only calls try an observer NameNode first (the RPC layer
    carries the state id); every other call, and any observer failure,
    goes through the active's failover proxy."""

    def __init__(self, active, client: "DFSClient", nn_addrs):
        self._active = active
        self._client = client
        self._addrs = nn_addrs
        self._observer = None
        self._probed = False
        self._synced = False

    def _find_observer(self):
        for addr in self._addrs:
            try:
                proxy = self._client._nn_proxy(addr)
                st = proxy.get_service_status()
                if st.get("state") == "observer":
                    log.info("Observer reads via %s", addr)
                    return proxy
            except Exception:  # noqa: BLE001 — not an observer, or down
                continue
        return None

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kwargs):
            if name in _OBSERVER_READS:
                if not self._synced:
                    # seed the state id from the active, so the first
                    # observer read already waits for current state
                    try:
                        self._active.msync()
                        self._synced = True
                    except (RpcError, OSError) as e:
                        log.debug("msync to active failed: %s", e)
                if not self._probed:
                    self._observer = self._find_observer()
                    self._probed = True
                if self._observer is not None:
                    try:
                        return getattr(self._observer, name)(*args, **kwargs)
                    except Exception as e:  # noqa: BLE001 — to the active
                        log.debug("observer read %s failed (%s); using "
                                  "active", name, e)
                        self._observer = None
                        self._probed = False
            return getattr(self._active, name)(*args, **kwargs)

        return call


def _is_idempotent(method: str) -> bool:
    return bool(getattr(getattr(_ClientProtocolDecl, method, None),
                        "_rpc_idempotent", False))
