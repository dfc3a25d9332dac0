"""The port's ``MiniDFSCluster`` (``hadoop_tpu_torch/testing``) and two
mixed clusters, held to the JAX package's own DFS tests.

The cases of ``tests/test_minidfs.py`` (round trips, replication,
re-replication after a DataNode dies, a corrupt replica avoided, lease
recovery, NameNode restarts with and without a checkpoint, short-circuit
reads on and off and across a DataNode restart, a dead DataNode on the
read path) run on the port's modules, through ``torch_ported_cases``, on
three clusters: the port's NameNode and DataNodes, the port's NameNode
with the reference's DataNodes, and the reference's NameNode with the
port's DataNodes. Both packages' clients then cross bytes on each. The
cases of ``tests/test_security.py`` (SASL RPC at each QoP, delegation
and block tokens, encrypted transfer, the fully secured cluster) run on
the port's modules and daemons, against the reference's ``MiniKdc``.
Every comparison is exact.
"""


import numpy as np
import pytest

from hadoop_tpu.dfs.client.filesystem import DistributedFileSystem as JDFS
from hadoop_tpu.dfs.datanode import DataNode as JDataNode
from hadoop_tpu.dfs.namenode import NameNode as JNameNode
from hadoop_tpu_torch.dfs.client import shortcircuit
from hadoop_tpu_torch.dfs.datanode import DataNode
from hadoop_tpu_torch.dfs.namenode import NameNode
from hadoop_tpu_torch.testing import minicluster as pmini
from torch_ported_cases import MixedCluster, cases_on_port, jconf

globals().update(cases_on_port("test_minidfs", {}))
globals().update(cases_on_port("test_security", {},
                               reference=("hadoop_tpu.testing.minikdc",)))


CLUSTERS = {
    "port": (NameNode, DataNode),
    "port_nn-ref_dn": (NameNode, JDataNode),
    "ref_nn-port_dn": (JNameNode, DataNode),
}


def _cluster(kind, num_datanodes=3):
    nn_cls, dn_cls = CLUSTERS[kind]
    if kind == "port":
        return pmini.MiniDFSCluster(num_datanodes=num_datanodes)
    return MixedCluster(nn_cls, [dn_cls], num_datanodes=num_datanodes)


@pytest.fixture(scope="module", params=sorted(CLUSTERS))
def cluster(request):
    """Replaces ``test_minidfs``'s fixture: its cases run on each. The
    port's short-circuit cache is the process's: each cluster starts it
    afresh, rid of the slots the cases poisoned on the one before."""
    shortcircuit.ShortCircuitCache._instance = None
    with _cluster(request.param) as c:
        c.kind = request.param
        yield c


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_both_clients_cross_bytes(cluster, fs, writer):
    """The port's and the reference's clients, each writing a multi-block
    file with a flush mid-chunk that the other reads, on every cluster."""
    jfs = JDFS([cluster.nn_addr], jconf(cluster.conf))
    try:
        data = _bytes(2 * 1024 * 1024 + 777, 20 + (writer == "port"))
        path = f"/both/{cluster.kind}/{writer}.bin"
        wfs, rfs = (fs, jfs) if writer == "port" else (jfs, fs)
        with wfs.create(path) as out:
            out.write(data[:1000])
            out.flush()
            out.write(data[1000:])
        assert rfs.read_all(path) == data
        assert wfs.read_all(path) == data
        assert [b["b"] for b in fs.client.get_block_locations(path)[
            "blocks"]] == [b["b"] for b in jfs.client.get_block_locations(
                path)["blocks"]]
        assert fs.content_summary(f"/both/{cluster.kind}") == \
            jfs.content_summary(f"/both/{cluster.kind}")
    finally:
        jfs.close()
