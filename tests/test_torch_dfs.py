"""The port's DFS client (``hadoop_tpu_torch/dfs/client``) against the
JAX package's own client, on a ``MiniDFSCluster`` of either package's
NameNode and DataNodes (every cluster fixture has the cases
``reference`` and ``port``): bytes written by one client are read by
the other, byte for byte, both ways.

Mirrors ``tests/test_minidfs.py`` (empty, sub-chunk, multi-block and
unaligned-flush files, a non-default bytes-per-checksum, pread and
seek, the namespace calls, single writer, read failover on a dead
DataNode, a corrupt replica avoided and reported, short-circuit reads
on and off), ``tests/test_fault_injection.py`` (pipeline recovery),
``tests/test_hedged_reads.py`` (a blocked replica, the hedge wins) and
``tests/test_erasure_coding.py`` (striped RS(6,3) and XOR(2,1) files,
read with up to m DataNodes down), and ``tests/test_ha.py``'s observer
reads. One shared cluster per kind. Every comparison is exact: the
transfers are bytes.
"""

import os
import threading
import time

import numpy as np
import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.dfs.client.filesystem import DistributedFileSystem as JDFS
from hadoop_tpu.dfs.datanode import datanode as jdatanode
from hadoop_tpu.ipc.errors import RemoteError as JRemoteError
from hadoop_tpu.testing import minicluster as jmini
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.datanode import datanode as pdatanode
from hadoop_tpu_torch.testing import minicluster as pmini
from hadoop_tpu_torch.dfs.client import DistributedFileSystem
from hadoop_tpu_torch.dfs.client import shortcircuit, streams
from hadoop_tpu_torch.dfs.protocol.records import AlreadyBeingCreatedError
from hadoop_tpu_torch.fs import get_filesystem


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _port_conf(cluster, **overrides):
    """A port ``Configuration`` holding the cluster's keys."""
    conf = Configuration()
    for k, v in cluster.conf.to_dict().items():
        conf.set(k, v)
    for k, v in overrides.items():
        conf.set(k, v)
    return conf


def _port_fs(cluster, **overrides):
    return DistributedFileSystem([cluster.nn_addr],
                                 _port_conf(cluster, **overrides))


# whose NameNode and DataNodes a cluster runs
DAEMONS = {"reference": (jmini, jdatanode), "port": (pmini, pdatanode)}


def _mini(kind, num_datanodes, base_dir=None, **keys):
    mini = DAEMONS[kind][0]
    conf = mini.fast_conf()
    for k, v in keys.items():
        conf.set(k, v)
    return mini.MiniDFSCluster(num_datanodes=num_datanodes, conf=conf,
                               base_dir=base_dir)


def _ref_conf(cluster, **overrides):
    """A reference ``Configuration`` holding the cluster's keys."""
    conf = JConfiguration(load_defaults=False)
    for k, v in cluster.conf.to_dict().items():
        conf.set(k, v)
    for k, v in overrides.items():
        conf.set(k, v)
    return conf


def _ref_fs(cluster, **overrides):
    """The reference's client on the cluster, closed with the cluster."""
    fs = JDFS([cluster.nn_addr], _ref_conf(cluster, **overrides))
    cluster._fs_instances.append(fs)
    return fs


@pytest.fixture(scope="module", params=sorted(DAEMONS))
def cluster(request):
    # the port's short-circuit cache is the process's: each cluster
    # starts it afresh, rid of the slots poisoned on the one before
    shortcircuit.ShortCircuitCache._instance = None
    with _mini(request.param, 3) as c:
        c.kind = request.param
        yield c


@pytest.fixture(scope="module")
def jfs(cluster):
    return _ref_fs(cluster)


@pytest.fixture(scope="module")
def pfs(cluster):
    fs = _port_fs(cluster)
    yield fs
    fs.close()


def _write(fs, path, parts, flush=False):
    with fs.create(path) as out:
        for p in parts:
            out.write(p)
            if flush:
                out.flush()


CASES = {
    "empty": ([], False),
    "under_one_chunk": ([_bytes(100, 1)], False),
    # 1 MB blocks: 3.5 MB in odd-sized writes is four blocks
    "multi_block": ([_bytes(3 * 1024 * 1024 + 512 * 1024, 2)[o:o + 97_531]
                     for o in range(0, 3 * 1024 * 1024 + 512 * 1024,
                                    97_531)], False),
    # a flush at 1000 leaves a partial chunk the next packet re-covers
    "unaligned_flush": ([_bytes(1000, 3), _bytes(50_001, 4),
                         _bytes(700, 5)], True),
}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cross_read_both_ways(cluster, jfs, pfs, writer, case):
    parts, flush = CASES[case]
    want = b"".join(parts)
    path = f"/cross/{writer}/{case}"
    wfs, rfs = (pfs, jfs) if writer == "port" else (jfs, pfs)
    _write(wfs, path, parts, flush)
    assert rfs.read_all(path) == want
    assert wfs.read_all(path) == want
    assert pfs.get_file_status(path).length == len(want)
    if case == "multi_block":
        assert len(pfs.client.get_block_locations(path)["blocks"]) == 4


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_non_default_bytes_per_checksum(cluster, writer):
    """A writer's 2048-byte chunks are stored in the replica's meta and
    echoed by the read setup: the other client verifies with them over
    TCP (short-circuit off)."""
    keys = {"dfs.bytes-per-checksum": "2048",
            "dfs.client.read.shortcircuit": "false"}
    p = _port_fs(cluster, **keys)
    j = JDFS([cluster.nn_addr], _ref_conf(cluster, **keys))
    try:
        payload = _bytes(300_001, 6)
        wfs, rfs = (p, j) if writer == "port" else (j, p)
        wfs.write_all(f"/bpc/{writer}.bin", payload)
        assert rfs.read_all(f"/bpc/{writer}.bin") == payload
    finally:
        p.close()
        j.close()


def test_blocks_after_the_first_fill_the_ack_window(cluster, jfs):
    """Blocks of more packets than the ack window, three of them: the
    window of each block's pipeline counts from its own first packet
    (the reference's writer counts from -1 and stalls on the second
    block, ROADMAP C 22)."""
    keys = {"dfs.client-write-packet-size": str(16 * 1024),
            "dfs.client.write.max-packets-in-flight": "4"}
    p = _port_fs(cluster, **keys)
    try:
        data = _bytes(600 * 1024 + 5, 15)
        with p.create("/window.bin", block_size=256 * 1024) as out:
            out.write(data)
        assert len(p.client.get_block_locations("/window.bin")["blocks"]) \
            == 3
        assert jfs.read_all("/window.bin") == data
        assert p.read_all("/window.bin") == data
    finally:
        p.close()


def test_pread_seek_and_namespace(cluster, jfs, pfs):
    data = bytes(range(256)) * 5000        # 1.28 MB, crosses a block edge
    pfs.write_all("/ns/seek.bin", data)
    with pfs.open("/ns/seek.bin") as f:
        f.seek(1000)
        assert f.tell() == 1000
        assert f.read(100) == data[1000:1100]
        edge = 1024 * 1024 - 50
        assert f.pread(edge, 100) == data[edge:edge + 100]
        assert f.tell() == 1100            # pread leaves the cursor
        f.seek(0)
        assert f.read(10) == data[:10]
    assert pfs.mkdirs("/ns/dir/sub")
    pfs.write_all("/ns/dir/a.txt", b"aaa")
    jfs.write_all("/ns/dir/b.txt", b"bbb")
    assert [s.path for s in pfs.list_status("/ns/dir")] == \
        [s.path for s in jfs.list_status("/ns/dir")] == \
        ["/ns/dir/a.txt", "/ns/dir/b.txt", "/ns/dir/sub"]
    st = pfs.get_file_status("/ns/dir/sub")
    assert st.is_dir and not pfs.get_file_status("/ns/dir/a.txt").is_dir
    assert pfs.rename("/ns/dir/a.txt", "/ns/dir/c.txt")
    assert not jfs.exists("/ns/dir/a.txt") and pfs.exists("/ns/dir/c.txt")
    assert jfs.read_all("/ns/dir/c.txt") == b"aaa"
    with pytest.raises(FileNotFoundError):
        pfs.get_file_status("/ns/none")
    # overwrite: refused without the flag, replaced with it
    pfs.write_all("/ns/ow.txt", b"v1")
    with pytest.raises(FileExistsError):
        with pfs.create("/ns/ow.txt", overwrite=False) as out:
            out.write(b"nope")
    pfs.write_all("/ns/ow.txt", b"v2", overwrite=True)
    assert jfs.read_all("/ns/ow.txt") == b"v2"
    assert pfs.delete("/ns/dir", recursive=True)
    assert not jfs.exists("/ns/dir") and not pfs.exists("/ns/dir")
    assert pfs.content_summary("/ns") == jfs.content_summary("/ns")


def test_single_writer_enforced(cluster, jfs, pfs):
    """One writer per file across the two clients: a second create of a
    file open for write fails with the NameNode's error."""
    out = pfs.create("/locked.txt")
    out.write(b"partial")
    try:
        with pytest.raises(Exception) as e:
            jfs.create("/locked.txt", overwrite=True)
        if cluster.kind == "port":
            # the reference's client resolves only its own dotted error
            # names: the port's error reaches it by name (ROADMAP C 20)
            assert isinstance(e.value, JRemoteError)
            assert e.value.class_name == (
                f"{AlreadyBeingCreatedError.__module__}."
                "AlreadyBeingCreatedError")
        else:
            assert "AlreadyBeingCreated" in type(e.value).__name__ or \
                isinstance(e.value, FileExistsError)
    finally:
        out.close()
    out = jfs.create("/locked2.txt")
    out.write(b"partial")
    other = _port_fs(cluster)
    try:
        with pytest.raises((AlreadyBeingCreatedError, FileExistsError)):
            other.create("/locked2.txt", overwrite=True)
    finally:
        out.close()
        other.close()
    assert pfs.read_all("/locked2.txt") == b"partial"


def _holder(cluster, fs, path):
    locs = fs.client.get_block_locations(path)
    holders = [loc["u"] for loc in locs["blocks"][0]["locs"]]
    idx = next(i for i, dn in enumerate(cluster.datanodes)
               if dn is not None and dn.uuid == holders[0])
    return idx, locs["blocks"][0]["b"]["id"]


def test_read_failover_on_dead_datanode(cluster, jfs, pfs):
    data = _bytes(400_000, 7)
    jfs.write_all("/failover.bin", data)
    time.sleep(0.3)
    victim, _ = _holder(cluster, pfs, "/failover.bin")
    cluster.kill_datanode(victim)
    try:
        fresh = _port_fs(cluster, **{"dfs.client.read.shortcircuit":
                                     "false"})
        try:
            with fresh.open("/failover.bin") as f:
                assert f.read() == data
        finally:
            fresh.close()
    finally:
        cluster.restart_datanode(victim)
        cluster.wait_active()


def test_corrupt_replica_detected_and_avoided(cluster, jfs):
    """A corrupt first replica fails its CRC in the port's reader, which
    reports it to the NameNode and reads another replica; the reported
    replica leaves the block's locations."""
    data = _bytes(50_000, 8)
    jfs.write_all("/corrupt.bin", data, overwrite=True)
    time.sleep(0.3)
    idx, block_id = _holder(cluster, jfs, "/corrupt.bin")
    bad_uuid = cluster.datanodes[idx].uuid
    assert cluster.corrupt_replica(block_id, idx)
    holders = {loc["u"] for loc in jfs.client.get_block_locations(
        "/corrupt.bin")["blocks"][0]["locs"]}
    for sc in ("true", "false"):
        fresh = _port_fs(cluster, **{"dfs.client.read.shortcircuit": sc})
        try:
            # the corrupt replica first, while the NameNode still lists
            # it: marking the healthy ones dead leaves it the only
            # candidate of the first round
            with fresh.open("/corrupt.bin") as f:
                listed = bad_uuid in {d.uuid for d in f.blocks[0].locations}
                f._dead.update(holders - {bad_uuid})
                assert f.read() == data
            # the first read met it (and reported it: see below)
            assert sc == "false" or listed
            assert fresh.read_all("/corrupt.bin") == data
        finally:
            fresh.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        info = cluster.namenode.fsn.bm.get(block_id)
        if bad_uuid not in info.locations:
            break
        time.sleep(0.1)
    assert bad_uuid not in cluster.namenode.fsn.bm.get(block_id).locations


def test_pipeline_recovers_when_a_datanode_dies_midwrite(cluster, jfs):
    """A DataNode of the pipeline stops after the first packets of a
    block: the port's writer rebuilds the pipeline without it, replays
    the block, and both clients read the file intact."""
    p = _port_fs(cluster, **{"dfs.client-write-packet-size": "65536"})
    data = _bytes(2 * 1024 * 1024 + 333, 9)

    class Kill(streams.DFSClientFaultInjector):
        fired = None
        stream = None

        def before_send_packet(self, block, seq):
            if seq == 3 and self.fired is None:
                victim = self.stream._pipeline.locations[1].uuid
                self.fired = next(i for i, dn in enumerate(cluster.datanodes)
                                  if dn is not None and dn.uuid == victim)
                cluster.datanodes[self.fired].stop()

    inj = Kill()
    streams.DFSClientFaultInjector.set(inj)
    try:
        with p.create("/recover.bin", replication=3) as out:
            inj.stream = out
            for o in range(0, len(data), 100_000):
                out.write(data[o:o + 100_000])
        assert inj.fired is not None
    finally:
        streams.DFSClientFaultInjector.set(None)
        if inj.fired is not None:
            cluster.restart_datanode(inj.fired)
            cluster.wait_active()
    try:
        assert jfs.read_all("/recover.bin") == data
        assert p.read_all("/recover.bin") == data
    finally:
        p.close()


def test_short_circuit_on_and_off_give_the_same_bytes(cluster, jfs):
    data = _bytes(2 * 1024 * 1024 + 12345, 10)
    jfs.write_all("/sc.bin", data)
    cache = shortcircuit.ShortCircuitCache.get()
    on = _port_fs(cluster)
    off = _port_fs(cluster, **{"dfs.client.read.shortcircuit": "false"})
    try:
        hits0, reqs0 = cache.hits, cache.requests
        with on.open("/sc.bin") as f:
            assert f._short_circuit_ok
            assert f.read() == data
        assert cache.hits > hits0 and cache.requests > reqs0
        hits1 = cache.hits
        with off.open("/sc.bin") as f:
            assert not f._short_circuit_ok
            assert f.read() == data
            assert f.pread(1024 * 1024 - 7, 99) == \
                data[1024 * 1024 - 7:1024 * 1024 + 92]
        assert cache.hits == hits1
        # a poisoned cached fd falls back to TCP, same bytes
        with cache._lock:
            for slot in cache._slots.values():
                os.close(slot.data_fd)
                slot.data_fd = -1
        assert on.read_all("/sc.bin") == data
    finally:
        on.close()
        off.close()


def test_get_filesystem_opens_the_port_client_by_uri(cluster, jfs):
    jfs.write_all("/uri.bin", b"by uri")
    fs = get_filesystem(f"{cluster.default_fs}/uri.bin",
                        _port_conf(cluster))
    try:
        assert isinstance(fs, DistributedFileSystem)
        assert fs.read_all("/uri.bin") == b"by uri"
    finally:
        fs.close()
    # no authority: dfs.namenode.rpc-address names the NameNode
    fs = get_filesystem("htpu:///uri.bin", _port_conf(cluster))
    try:
        assert fs.client.nn_addrs == [cluster.nn_addr]
        assert fs.read_all("/uri.bin") == b"by uri"
    finally:
        fs.close()
    with pytest.raises(ValueError, match="scheme 'viewfs'"):
        get_filesystem("viewfs://x/y")


def test_close_stops_the_clients_threads(cluster):
    before = set(threading.enumerate())
    fs = _port_fs(cluster, **{"dfs.client.hedged.read.threadpool.size": "2"})
    fs.write_all("/threads.bin", _bytes(10_000, 11))
    assert fs.read_all("/threads.bin") == _bytes(10_000, 11)
    fs.close()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        left = [t for t in set(threading.enumerate()) - before
                if t.is_alive()]
        if not left:
            break
        time.sleep(0.1)
    assert not left, [t.name for t in left]


# ------------------------------------------------------------ hedged reads

class _BlockFirstReplica:
    """The first read parks on an event the test sets only after the
    read returned: the read can finish only through the hedge. Mixed
    into the cluster's ``DataNodeFaultInjector``."""

    def __init__(self):
        self.hits = 0
        self._lock = threading.Lock()
        self._gate = threading.Event()

    def before_read_block(self, block, port: int = 0) -> None:
        with self._lock:
            self.hits += 1
            first = self.hits == 1
        if first:
            self._gate.wait(timeout=120.0)

    def release(self) -> None:
        self._gate.set()


@pytest.fixture(scope="module", params=sorted(DAEMONS))
def hedge_cluster(request, tmp_path_factory):
    with _mini(request.param, 2,
               base_dir=str(tmp_path_factory.mktemp("hedge")),
               **{"dfs.replication": "2"}) as c:
        c.wait_active()
        c.kind = request.param
        yield c


def test_hedged_read_wins_over_a_blocked_replica(hedge_cluster):
    c = hedge_cluster
    jfs = _ref_fs(c)
    injector = DAEMONS[c.kind][1].DataNodeFaultInjector
    payload = _bytes(100_000, 12)
    jfs.write_all("/hedge.bin", payload)
    p = _port_fs(c, **{"dfs.client.read.shortcircuit": "false",
                       "dfs.client.hedged.read.threadpool.size": "4",
                       "dfs.client.hedged.read.threshold": "0.05"})
    inj = type("BlockFirstReplica", (_BlockFirstReplica, injector), {})()
    injector.set(inj)
    try:
        assert p.read_all("/hedge.bin") == payload
        assert inj.hits >= 2
        assert p.client.hedged_reads >= 1 and p.client.hedged_wins >= 1
    finally:
        inj.release()
        injector.set(None)
    with p.open("/hedge.bin") as f:
        assert f.pread(10_000, 256) == payload[10_000:10_256]
    p.close()


# --------------------------------------------------------- erasure coding

@pytest.fixture(scope="module", params=sorted(DAEMONS))
def ec_cluster(request, tmp_path_factory):
    # several block groups
    with _mini(request.param, 9, base_dir=str(tmp_path_factory.mktemp("ec")),
               **{"dfs.blocksize": str(256 * 1024)}) as c:
        c.wait_active()
        yield c


@pytest.mark.parametrize("policy", ["RS-6-3-64k", "XOR-2-1-64k"])
def test_striped_files_cross_both_ways_with_m_datanodes_down(ec_cluster,
                                                             policy):
    """Striped files (several groups, a partial last stripe) written by
    each client are read by the other, first whole, then with m
    DataNodes holding units killed (the readers decode)."""
    from hadoop_tpu.io import erasurecode as jec
    c = ec_cluster
    jfs = _ref_fs(c)
    pfs = _port_fs(c)
    m = jec.get_policy(policy).m
    d = f"/ec-{policy}"
    pfs.mkdirs(d)
    pfs.set_ec_policy(d, policy)
    assert jfs.client.get_ec_policy(d) == policy
    files = {f"{d}/port.bin": (pfs, _bytes(900 * 1024 + 12345, 13)),
             f"{d}/ref.bin": (jfs, _bytes(700 * 1024 + 7, 14))}
    for path, (wfs, data) in files.items():
        with wfs.create(path) as out:
            out.write(data)
        assert pfs.get_file_status(path).ec_policy == policy
    for path, (_, data) in files.items():
        assert jfs.read_all(path) == data and pfs.read_all(path) == data
    killed = []
    try:
        for i in range(m):
            c.kill_datanode(i)
            killed.append(i)
        for path, (_, data) in files.items():
            fresh = _port_fs(c)
            try:
                assert fresh.read_all(path) == data
                with fresh.open(path) as f:
                    at = 300 * 1024 + 5
                    assert f.pread(at, 70_000) == data[at:at + 70_000]
            finally:
                fresh.close()
            assert _ref_fs(c).read_all(path) == data
    finally:
        for i in killed:
            c.restart_datanode(i)
        c.wait_active()
        pfs.close()


# ---------------------------------------------------------- observer reads

@pytest.mark.parametrize("kind", sorted(DAEMONS))
def test_observer_reads_through_the_port_client(tmp_path, kind):
    """With an observer NameNode and observer reads on, the port's
    namespace reads go to the observer after an msync to the active,
    and see the active's latest writes, on either package's HA
    cluster."""
    with DAEMONS[kind][0].MiniQJMHACluster(
            num_journalnodes=3, num_namenodes=2, num_datanodes=3,
            num_observers=1, base_dir=str(tmp_path)) as c:
        c.wait_active()
        observer = c.namenodes[2]
        assert observer.ha_state == "observer"
        conf = Configuration()
        for k, v in c.conf.to_dict().items():
            conf.set(k, v)
        conf.set("dfs.client.observer.reads.enabled", "true")
        addrs = [("127.0.0.1", nn.port) for nn in c.namenodes
                 if nn is not None]
        fs = DistributedFileSystem(addrs, conf)
        try:
            with fs.create("/obs/data.txt") as out:
                out.write(b"observed")
            st = fs.get_file_status("/obs/data.txt")
            assert st.length == len(b"observed")
            assert fs.client.nn._observer is not None
            assert fs.client.nn._observer._address == ("127.0.0.1",
                                                       observer.port)
            with fs.open("/obs/data.txt") as f:
                assert f.read() == b"observed"
        finally:
            fs.close()


def test_a_failed_mirror_is_blamed_not_the_first_datanode():
    """A setup reply naming a mirror as the bad node: the port's pipeline
    reports that mirror, so the writer excludes it and keeps the healthy
    first DataNode (the reference blames the first one, ROADMAP C 16)."""
    import socket as _socket

    from hadoop_tpu.dfs.client import streams as jstreams
    from hadoop_tpu.dfs.protocol.records import (Block as JBlock,
                                                 DatanodeInfo as JInfo)
    from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
    from hadoop_tpu_torch.dfs.protocol.records import Block, DatanodeInfo
    from hadoop_tpu_torch.util.crc import DataChecksum

    srv = _socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)

    def answer():
        for _ in range(2):
            conn, _ = srv.accept()
            with conn:
                dt.recv_frame(conn)
                dt.send_frame(conn, {"ok": False, "bad_node": "mirror",
                                     "em": "mirror failed"})

    t = threading.Thread(target=answer, daemon=True)
    t.start()
    port = srv.getsockname()[1]
    try:
        with pytest.raises(streams.PipelineError) as got:
            streams._Pipeline(Block(1, 1), [
                DatanodeInfo("first", "127.0.0.1", port),
                DatanodeInfo("mirror", "127.0.0.1", 1)], DataChecksum())
        assert got.value.bad_node == "mirror"
        with pytest.raises(jstreams.PipelineError) as want:
            jstreams._Pipeline(JBlock(1, 1), [
                JInfo("first", "127.0.0.1", port),
                JInfo("mirror", "127.0.0.1", 1)],
                jstreams.DataChecksum())
        assert want.value.bad_node == "first"
    finally:
        t.join(timeout=10)
        srv.close()
    assert not t.is_alive()
