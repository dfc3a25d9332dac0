"""In-process DFS minicluster: the port's NameNode and DataNodes.

The port's copy of ``MiniDFSCluster``, ``MiniQJMHACluster`` (JournalNodes,
HA NameNodes over their quorum journal, observers) and ``fast_conf`` from
``hadoop_tpu/testing/minicluster.py``; the YARN clusters are Queue A 11.

Parity with the reference's pattern (ref:
hadoop-hdfs/src/test/java/org/apache/hadoop/hdfs/MiniDFSCluster.java:157,
3,423 LoC): real daemons (NameNode + N DataNodes), real protocols, one
process, temp dirs, ephemeral ports, aggressive intervals — multi-node
behavior (replication, dead-node handling, re-replication, restart recovery)
exercised without mocking peers. Kill/restart APIs drive failure tests.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import time
from typing import List, Optional

from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.ipc.errors import RpcError
from hadoop_tpu_torch.dfs.client.filesystem import DistributedFileSystem
from hadoop_tpu_torch.dfs.datanode import DataNode
from hadoop_tpu_torch.dfs.namenode import NameNode

log = logging.getLogger(__name__)


class MiniQJMHACluster:
    """HA minicluster: N JournalNodes + M NameNodes (QJM shared edits,
    automatic lease failover) + D DataNodes reporting to every NN.
    Ref: hadoop-hdfs/src/test/.../qjournal/MiniQJMHACluster.java:47 +
    MiniJournalCluster."""

    def __init__(self, num_journalnodes: int = 3, num_namenodes: int = 2,
                 num_datanodes: int = 3, num_observers: int = 0,
                 conf: Optional[Configuration] = None,
                 base_dir: Optional[str] = None):
        self.conf = fast_conf(conf)
        self.conf.set_if_unset("dfs.ha.tail-edits.period", "0.2s")
        self.conf.set_if_unset("dfs.ha.lease-duration", "1.5s")
        self.conf.set_if_unset("dfs.ha.health-check.interval", "0.3s")
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="htpu-qjmha-")
        self._owns_dir = base_dir is None
        self.num_journalnodes = num_journalnodes
        self.num_namenodes = num_namenodes
        self.num_observers = num_observers
        self.num_datanodes = num_datanodes
        self.journalnodes: List = []
        self.namenodes: List[Optional[NameNode]] = []
        self.datanodes: List[Optional[DataNode]] = []
        self._fs_instances: List[DistributedFileSystem] = []
        self._nn_ports: dict = {}  # index → last known port (for restarts)

    def start(self) -> "MiniQJMHACluster":
        for i in range(self.num_journalnodes):
            self._start_journalnode(i)
        jn_spec = ",".join(f"127.0.0.1:{j.port}" for j in self.journalnodes)
        self.conf.set("dfs.namenode.shared.edits.dir", jn_spec)
        total_nn = self.num_namenodes + self.num_observers
        for i in range(total_nn):
            self._start_namenode(i, observer=i >= self.num_namenodes)
        self.conf.set("dfs.namenode.rpc-address", ",".join(
            f"127.0.0.1:{nn.port}" for nn in self.namenodes))
        for i in range(self.num_datanodes):
            self._start_datanode(i)
        return self

    def _start_journalnode(self, i: int) -> None:
        from hadoop_tpu_torch.dfs.qjournal import JournalNode
        jn_conf = Configuration(other=self.conf)
        jn = JournalNode(jn_conf, storage_dir=os.path.join(
            self.base_dir, f"journal{i}"))
        jn.init(jn_conf)
        jn.start()
        self.journalnodes.append(jn)

    def _start_datanode(self, i: int) -> None:
        dn_conf = Configuration(other=self.conf)
        dn = DataNode(dn_conf,
                      data_dir=os.path.join(self.base_dir, f"data{i}"),
                      nn_addr=[("127.0.0.1", nn.port)
                               for nn in self.namenodes])
        dn.init(dn_conf)
        dn.start()
        self.datanodes.append(dn)

    def _start_namenode(self, i: int, observer: bool = False) -> None:
        nn_conf = Configuration(other=self.conf)
        if observer:
            nn_conf.set("dfs.ha.initial-state", "observer")
        if i in self._nn_ports:
            nn_conf.set("dfs.namenode.rpc-port", self._nn_ports[i])
        nn = NameNode(nn_conf,
                      name_dir=os.path.join(self.base_dir, f"name{i}"),
                      nn_id=f"nn{i + 1}")
        nn.init(nn_conf)
        nn.start()
        self._nn_ports[i] = nn.port
        if i < len(self.namenodes):
            self.namenodes[i] = nn
        else:
            self.namenodes.append(nn)

    # --------------------------------------------------------------- access

    def active_index(self) -> Optional[int]:
        for i, nn in enumerate(self.namenodes):
            if nn is not None and nn.ha_state == "active":
                return i
        return None

    def wait_active(self, timeout: float = 30.0) -> int:
        """Wait for an elected active NN with all DNs live + safemode off."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            idx = self.active_index()
            if idx is not None:
                fsn = self.namenodes[idx].fsn
                live = len(fsn.bm.dn_manager.live_nodes())
                want = sum(1 for d in self.datanodes if d is not None)
                if not fsn.bm.safemode.is_on() and live >= want:
                    return idx
            time.sleep(0.05)
        raise TimeoutError(
            f"no active NN (states: "
            f"{[nn.ha_state if nn else None for nn in self.namenodes]})")

    def kill_active(self) -> int:
        """Stop the active NN (simulates a crash); returns its index."""
        idx = self.active_index()
        assert idx is not None, "no active to kill"
        nn = self.namenodes[idx]
        self.namenodes[idx] = None
        nn.stop()
        return idx

    def restart_namenode(self, i: int) -> None:
        self._start_namenode(i, observer=i >= self.num_namenodes)

    def get_filesystem(self, observer_reads: bool = False
                       ) -> DistributedFileSystem:
        conf = Configuration(other=self.conf)
        if observer_reads:
            conf.set("dfs.client.observer.reads.enabled", "true")
        fs = DistributedFileSystem(
            [("127.0.0.1", nn.port) for nn in self.namenodes
             if nn is not None], conf)
        self._fs_instances.append(fs)
        return fs

    def shutdown(self) -> None:
        for fs in self._fs_instances:
            try:
                fs.close()
            except (OSError, RpcError) as e:
                log.debug("fs close during shutdown failed: %s", e)
        for dn in self.datanodes:
            if dn is not None:
                dn.stop()
        for nn in self.namenodes:
            if nn is not None:
                nn.stop()
        for jn in self.journalnodes:
            jn.stop()
        if self._owns_dir:
            shutil.rmtree(self.base_dir, ignore_errors=True)

    def __enter__(self) -> "MiniQJMHACluster":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False


def fast_conf(base: Optional[Configuration] = None) -> Configuration:
    """Aggressive intervals so failure paths run in test time."""
    conf = Configuration(other=base) if base else Configuration(
        load_defaults=False)
    conf.set_if_unset("dfs.heartbeat.interval", "0.1s")
    conf.set_if_unset("dfs.namenode.heartbeat.recheck-interval", "0.25s")
    conf.set_if_unset("dfs.namenode.redundancy.interval", "0.2s")
    conf.set_if_unset("dfs.namenode.reconstruction.pending.timeout", "4s")
    conf.set_if_unset("dfs.blockreport.interval", "5s")
    conf.set_if_unset("dfs.lease.soft-limit", "2s")
    conf.set_if_unset("dfs.lease.hard-limit", "5s")
    conf.set_if_unset("dfs.blocksize", "1m")
    conf.set_if_unset("dfs.replication", "3")
    conf.set_if_unset("ipc.client.connect.timeout", "5s")
    conf.set_if_unset("ipc.client.rpc-timeout", "30s")
    conf.set_if_unset("ipc.ping.interval", "0.5s")
    return conf


class MiniDFSCluster:
    def __init__(self, num_datanodes: int = 3,
                 conf: Optional[Configuration] = None,
                 base_dir: Optional[str] = None,
                 storage_types: Optional[List[str]] = None):
        self.conf = fast_conf(conf)
        # fd-passing short-circuit on by default, like the reference's
        # MiniDFSCluster with domain sockets. Path lives under /tmp, NOT
        # base_dir: AF_UNIX paths cap at ~107 bytes and pytest tmp
        # paths routinely blow that.
        self.conf.set_if_unset(
            "dfs.domain.socket.path",
            f"/tmp/htpu-ds-{os.getpid()}-_PORT.sock")
        self.base_dir = base_dir or tempfile.mkdtemp(prefix="htpu-minidfs-")
        self._owns_dir = base_dir is None
        self.num_datanodes = num_datanodes
        self.storage_types = storage_types  # per-DN media class (mover tests)
        self.namenode: Optional[NameNode] = None
        self.datanodes: List[Optional[DataNode]] = []
        self._fs_instances: List[DistributedFileSystem] = []

    # ------------------------------------------------------------- lifecycle

    def start(self) -> "MiniDFSCluster":
        self._start_namenode()
        for i in range(self.num_datanodes):
            self._start_datanode(i)
        self.wait_active()
        return self

    def _start_namenode(self) -> None:
        nn_conf = Configuration(other=self.conf)
        if self.namenode is not None:
            # Restart keeps the address (clients hold it), like a real daemon.
            nn_conf.set("dfs.namenode.rpc-port", self.namenode.port)
        self.namenode = NameNode(
            nn_conf, name_dir=os.path.join(self.base_dir, "name"))
        self.namenode.init(nn_conf)
        self.namenode.start()
        self.conf.set("dfs.namenode.rpc-address",
                      f"127.0.0.1:{self.namenode.port}")

    def _start_datanode(self, i: int) -> None:
        dn_conf = Configuration(other=self.conf)
        if self.storage_types:
            dn_conf.set("dfs.datanode.storage.type",
                        self.storage_types[i % len(self.storage_types)])
        dn = DataNode(dn_conf,
                      data_dir=os.path.join(self.base_dir, f"data{i}"),
                      nn_addr=("127.0.0.1", self.namenode.port))
        dn.init(dn_conf)
        dn.start()
        if i < len(self.datanodes):
            self.datanodes[i] = dn
        else:
            self.datanodes.append(dn)

    def wait_active(self, timeout: float = 30.0) -> None:
        """Safemode off + all DNs live."""
        deadline = time.monotonic() + timeout
        fsn = self.namenode.fsn
        while time.monotonic() < deadline:
            live = len(fsn.bm.dn_manager.live_nodes())
            want = sum(1 for d in self.datanodes if d is not None)
            if not fsn.bm.safemode.is_on() and live >= want:
                return
            time.sleep(0.05)
        raise TimeoutError(
            f"cluster not active: safemode={fsn.bm.safemode.status()} "
            f"live={len(fsn.bm.dn_manager.live_nodes())}")

    def shutdown(self) -> None:
        for fs in self._fs_instances:
            try:
                fs.close()
            except (OSError, RpcError) as e:
                log.debug("fs close during shutdown failed: %s", e)
        for dn in self.datanodes:
            if dn is not None:
                dn.stop()
        if self.namenode is not None:
            self.namenode.stop()
        if self._owns_dir:
            shutil.rmtree(self.base_dir, ignore_errors=True)

    def __enter__(self) -> "MiniDFSCluster":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False

    # --------------------------------------------------------------- access

    @property
    def nn_addr(self):
        return ("127.0.0.1", self.namenode.port)

    @property
    def default_fs(self) -> str:
        return f"htpu://127.0.0.1:{self.namenode.port}"

    def get_filesystem(self) -> DistributedFileSystem:
        fs = DistributedFileSystem([self.nn_addr],
                                   Configuration(other=self.conf))
        self._fs_instances.append(fs)
        return fs

    # ---------------------------------------------------------- fault tools

    def kill_datanode(self, i: int) -> DataNode:
        """Hard-stop a DN (no dereg — the NN must notice via heartbeats).
        Ref: MiniDFSCluster.stopDataNode."""
        dn = self.datanodes[i]
        dn.stop()
        self.datanodes[i] = None
        return dn

    def restart_datanode(self, i: int) -> None:
        self._start_datanode(i)

    def restart_namenode(self) -> None:
        """Stop + cold-start the NN from its on-disk state (image + edits).
        Ref: MiniDFSCluster.restartNameNode."""
        self.namenode.stop()
        # Let DN actors notice and re-register after the new NN is up.
        self._start_namenode()
        for dn in self.datanodes:
            if dn is not None:
                dn.nn_addr = ("127.0.0.1", self.namenode.port)
        self.conf.set("dfs.namenode.rpc-address",
                      f"127.0.0.1:{self.namenode.port}")

    def corrupt_replica(self, block_id: int, dn_index: int) -> bool:
        """Flip a byte in a stored replica (tests checksum paths).
        Ref: MiniDFSCluster.corruptReplica."""
        dn = self.datanodes[dn_index]
        if dn is None:
            return False
        rep = dn.store.get_replica(block_id)
        if rep is None:
            return False
        path = dn.store._path(rep.state, block_id)
        with open(path, "r+b") as f:
            f.seek(0)
            b = f.read(1)
            f.seek(0)
            f.write(bytes([b[0] ^ 0xFF]))
        return True
